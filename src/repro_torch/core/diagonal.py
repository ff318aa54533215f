"""Diagonal-batching executor (the paper's contribution, paper Alg. 1).

A slot buffer ``buf[L, B, T, D]`` holds, in slot l, the segment entering
layer l. Anti-diagonal step i (S + L - 1 of them, the Lemma 3.1 minimum)
applies one grouped cell to the valid slot band ``[max(0, i-S+1),
min(i, L-1)]`` (slot l holds segment i - l), then shifts the band's output
down one slot; the top slot's output leaves the pipeline as a finished
segment. Eager PyTorch slices the band with Python ints, so fill and drain
steps run exactly the cells that exist, with no masking: S*L cell applies,
as in the sequential schedule. The recurrence is exact: every layer's state
is updated by the same functions in the same order as the sequential
executor, only grouped across slots.

A pattern of several positions (jamba's attn, mamba and mamba_moe
layers) puts position p's layer j at slot ``p + len(pattern) * j``
(``StackLayout.position_slots``): a step applies one cell per position to
that position's slots in the band, a strided view of the slot buffer, as
the reference's ``_diag_step`` does. Every cell of a step reads the buffer
before any output is written back (as the reference's separate ``y``
buffer), so position p never sees position p - 1's output of the same step.

Prelude layers (kimi's dense first layer) take the first slots: slot j <
n_prelude is prelude layer j, applied as that layer's one-group cell when
the band covers it, and the pattern's layers follow (one position only
after a prelude: no config has more). The per-slot math does not depend on
the band, so the executors stay equal to the sequential one.

Every form of the executor runs one band step, ``band_step``: ``(carry,
i) -> carry``, in place, with the group cursor i a host int in the carry.
So they are equal by construction:

  * ``run_diagonal``, the one-shot executor, runs all S + L - 1 steps;
  * ``pipeline_init`` / ``pipeline_step`` / ``pipeline_finalize``, the
    resumable pipeline: the carry (slot buffer, executor state, cursor,
    outputs, optional state capture) is explicit, and each
    ``pipeline_step`` runs a bounded number of steps, so a long prefill can
    be suspended between calls (to let decode chunks run,
    ``serve/scheduler.py``) and resumed to the bit;
  * ``pipeline_step_pool`` advances several such carries, whose cursors
    may differ: per step the live members' bands go through one grouped
    cell call along the group axis, each group reading its own layer's
    weights through a layer index (the ``attn`` and ``attn_moe`` cells;
    the mamba cells and prelude slots go member by member).

Under gradients (``core.sequential.training(params, segments)``)
``run_diagonal`` takes an out-of-place form, ``run_diagonal_grad``: the
slots are a list of tensors, each band's input stacked from them (the
entering segment and the last step's outputs) and its outputs kept as
views, the state carried per layer as the new tensors the cells return,
the finished segments collected and stacked, the final state stacked
into the usual tree. It applies the same cells to the same values in the
same order, so its forward gives the in-place form's bits. ``remat``
runs each cell call under ``torch.utils.checkpoint``. The capture,
``stream_ys`` and the resumable and pooled pipeline are forward-only.

A carry's buffers are its own (``pipeline_init`` copies the state), so a
caller's state updated in place, a decode pool say, never aliases one.
Only the recurrent leaves (``RECURRENT_KEYS``) are copied, written back
and captured: a whisper ``dec`` layer's cross K/V (``ck``/``cv``) is
constant for the whole forward, and the cells read the caller's tensors.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.core.memory import RECURRENT_KEYS
from repro_torch.core.schedule import band, n_diagonal_groups
from repro_torch.core.sequential import (ApplyBlock, exec_state_copy, layer_slice,
                                         one_layer_cell, rematerialized, stack_layers,
                                         stacked_state, training, with_new_state)


# band steps that ran as one cell call over two or more pipelines
# (``pipeline_step_pool``), and the member band steps they covered; a
# caller that reads them sets them to 0 first
pool_counts = {"steps": 0, "member_steps": 0}


def _check_layout(layout) -> None:
    if layout.prelude and len(layout.pattern) != 1:
        raise ValueError("the diagonal executor supports one pattern position after "
                         f"prelude layers, got {layout.prelude} + {layout.pattern}")


def _band_slice(tree, lo: int, hi: int):
    """Layers lo..hi of a stacked dict tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _band_slice(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi + 1]


def _position_slots(layout, p: int, jb) -> slice:
    """The slots of position p's superblocks jb = (j0, j1): a strided slice
    of the slot buffer (stride len(pattern); contiguous for one position)."""
    slots = layout.position_slots(p)
    return slice(slots[jb[0]], slots[jb[1]] + 1, slots.step)


def _per_slot_apply(apply_block: ApplyBlock):
    """The plain block applied slot by slot over a band: the oracle for the
    fused grouped cell (what the reference's vmap over slots computes)."""
    def grouped(t, p, x, state):
        outs = [apply_block(t, layer_slice(p, g), x[g], layer_slice(state, g))
                for g in range(x.shape[0])]
        return (torch.stack([y for y, _ in outs]),
                stack_layers([{k: v for k, v in st.items() if k in RECURRENT_KEYS}
                              for _, st in outs]))
    return grouped


def boundary_states_from_capture(layout, captured: Dict, n_segments: int) -> Dict:
    """Per-boundary recurrent states from a per-step capture
    (``run_diagonal(capture_states=True)``): layer l's state after segment
    c - 1 was written at step (c - 1) + l, so boundary c (index c - 1) of
    each leaf gathers those steps (prelude layer j: slot j; pattern
    position p's layer j: its slot ``layout.position_slots(p)[j]``). One
    gather per leaf, on the device -> leaves with a leading [S] boundary
    axis."""
    _check_layout(layout)
    P = len(layout.prelude)
    device = next(iter(captured["pattern"][0].values())).device
    steps = torch.arange(n_segments, device=device)[:, None]
    layers = torch.arange(layout.n_super, device=device)[None, :]
    pattern = []
    for p, tree in enumerate(captured["pattern"]):
        slots = torch.tensor(list(layout.position_slots(p)), device=device)[None, :]
        pattern.append({k: a[steps + slots, layers] for k, a in tree.items()})
    return {"prelude": tuple({k: a[steps[:, 0] + j] for k, a in captured["prelude"][j].items()}
                             for j in range(P)),
            "pattern": tuple(pattern)}


def _cell(apply_block: ApplyBlock, grouped_apply):
    return grouped_apply if grouped_apply is not None else _per_slot_apply(apply_block)


def _segments(carry: Dict) -> int:
    return carry["brow"].shape[0] if "win" in carry else carry["ys"].shape[0]


def _band_in(xs: torch.Tensor, carry: Dict, n_layers: int):
    """The band (lo, hi) of the carry's next step, with the entering
    segment written into slot 0."""
    i = carry["step"]
    lo, hi = band(i, xs.shape[0], n_layers)
    if lo == 0:
        carry["buf"][0] = xs[i]
    return lo, hi


def _apply_prelude(layout, params: Dict, carry: Dict, lo: int, hi: int, cell):
    """The prelude slots of band lo..hi, each its layer as a one-group
    cell -> ([(slot, 1, y [1, B, T, D])], {slot: its new state})."""
    parts, new = [], {}
    one = one_layer_cell(cell)
    for j in range(lo, min(hi, len(layout.prelude) - 1) + 1):
        y, new[j] = one(layout.prelude[j], params["prelude"][j], carry["buf"][j],
                        carry["state"]["prelude"][j])
        parts.append((j, 1, y[None]))
    return parts, new


def _apply_position(layout, params: Dict, carry: Dict, p: int, jb, cell, parts,
                    new_pattern: Dict) -> None:
    """Pattern position p's superblocks jb of a carry's band as one cell
    call over their strided slots; its output and new state are appended to
    ``parts`` and ``new_pattern`` (written back only after every position
    has read the buffer)."""
    sl = _position_slots(layout, p, jb)
    y, new = cell(layout.pattern[p], _band_slice(params["pattern"][p], *jb),
                  carry["buf"][sl], _band_slice(carry["state"]["pattern"][p], *jb))
    parts.append((sl.start, sl.step, y))
    new_pattern[p] = (jb, new)


def _band_out(carry: Dict, parts, new_prelude: Dict, new_pattern: Dict, *,
              retain_pos: int) -> None:
    """The band's results into the carry, after every cell of the step has
    run: the state's band layers (prelude layers, and per pattern position
    p its superblocks ``new_pattern[p] = ((j0, j1), new)``), the finished
    segment (if the band reached the top slot) into ``ys`` or
    ``win``/``brow``, each output shifted one slot up in the slot buffer,
    the capture of this step; then the cursor moves on. parts: [(first
    slot, slot stride, y)]."""
    i, buf = carry["step"], carry["buf"]
    L = buf.shape[0]
    state = carry["state"]
    for j, new in new_prelude.items():
        for k, v in new.items():
            if k in RECURRENT_KEYS:
                state["prelude"][j][k].copy_(v)
    for p, ((j0, j1), new) in new_pattern.items():
        for k, v in new.items():
            if k in RECURRENT_KEYS:
                state["pattern"][p][k][j0:j1 + 1] = v
    for s0, st, y in parts:
        y = y.to(buf.dtype)
        if s0 + st * (y.shape[0] - 1) == L - 1:     # segment i - (L-1) finished
            s = i - (L - 1)
            if "win" in carry:
                carry["win"][s % carry["win"].shape[0]].copy_(y[-1])
                carry["brow"][s].copy_(y[-1][:, retain_pos])
            else:
                carry["ys"][s].copy_(y[-1])
            y = y[:-1]
        if y.shape[0]:
            buf[s0 + 1:s0 + 2 + st * (y.shape[0] - 1):st] = y
    if "cap" in carry:
        for part in ("prelude", "pattern"):
            for cap, st in zip(carry["cap"][part], state[part]):
                for k, c in cap.items():
                    c[i].copy_(st[k])
    carry["step"] = i + 1


def band_step(layout, params: Dict, xs: torch.Tensor, carry: Dict, cell, *,
              retain_pos: int = -1) -> Dict:
    """One anti-diagonal step of a carry, in place: the cells over the band
    of step ``carry['step']`` (a prelude slot as its layer's one-group
    cell; per pattern position, one cell over its layers in the band, at
    the strided slots ``position_slots``), every cell reading the slot
    buffer before any output is written back; then the cursor moves on. A
    cursor past the grid is a no-op (it only moves on)."""
    L = layout.n_layers
    if carry["step"] >= n_diagonal_groups(xs.shape[0], L):
        carry["step"] += 1
        return carry
    lo, hi = _band_in(xs, carry, L)
    parts, new_pre = _apply_prelude(layout, params, carry, lo, hi, cell)
    new_pat: Dict = {}
    for p in range(len(layout.pattern)):
        jb = layout.position_band(p, lo, hi)
        if jb is not None:
            _apply_position(layout, params, carry, p, jb, cell, parts, new_pat)
    _band_out(carry, parts, new_pre, new_pat, retain_pos=retain_pos)
    return carry


def _forward_only(params, xs, what: str) -> None:
    if training(params, xs):
        raise ValueError(f"{what} is forward-only; under gradients run run_diagonal")


def run_diagonal_grad(layout, params: Dict, state0: Dict, segments: torch.Tensor, cell,
                      *, remat: bool = False):
    """The out-of-place form of ``run_diagonal`` (for gradients): the same
    band steps, each cell over a band stacked from the slot list, every
    cell of a step reading the slots before any output moves on; the state
    carried per layer. remat: each cell call under ``rematerialized``.
    -> (ys [S, B, T, D], final_state)."""
    _check_layout(layout)
    if remat:
        cell = rematerialized(cell)
    S, L = segments.shape[0], layout.n_layers
    slots: List = [None] * L
    ys: List = [None] * S
    prelude = list(state0["prelude"])
    pattern = [[layer_slice(tree, j) for j in range(layout.n_super)]
               for tree in state0["pattern"]]
    one = one_layer_cell(cell)
    for i in range(n_diagonal_groups(S, L)):
        lo, hi = band(i, S, L)
        if lo == 0:
            slots[0] = segments[i]
        outs, new_prelude, new_pattern = [], {}, {}
        for j in range(lo, min(hi, len(layout.prelude) - 1) + 1):
            y, new_prelude[j] = one(layout.prelude[j], params["prelude"][j], slots[j],
                                    prelude[j])
            outs.append((j, y))
        for p in range(len(layout.pattern)):
            jb = layout.position_band(p, lo, hi)
            if jb is None:
                continue
            sl = _position_slots(layout, p, jb)
            y, new = cell(layout.pattern[p], _band_slice(params["pattern"][p], *jb),
                          torch.stack(slots[sl]), stack_layers(pattern[p][jb[0]:jb[1] + 1]))
            new_pattern[p] = (jb, new)
            outs += zip(range(sl.start, sl.stop, sl.step), y)
        for j, new in new_prelude.items():
            prelude[j] = with_new_state(prelude[j], new)
        for p, ((j0, j1), new) in new_pattern.items():
            for j in range(j0, j1 + 1):
                pattern[p][j] = with_new_state(pattern[p][j],
                                               {k: v[j - j0] for k, v in new.items()})
        for slot, y in outs:
            y = y.to(segments.dtype)
            if slot == L - 1:
                ys[i - (L - 1)] = y
            else:
                slots[slot + 1] = y
    return torch.stack(ys), stacked_state(state0, prelude, pattern)


def run_diagonal(layout, params: Dict, state0: Dict, segments: torch.Tensor,
                 apply_block: ApplyBlock, *, grouped_apply=None,
                 capture_states: bool = False, stream_ys: bool = False,
                 retain_pos: int = -1, remat: bool = False):
    """segments: [S, B, T, D] -> (ys [S, B, T, D], final_state); the same
    params/state structure as ``run_sequential``; state0 is not modified.

    grouped_apply: the fused grouped cell ``(btype, params [G, ...], x [G, B,
    T, D], state [G, B, ...]) -> (y, new_state)``
    (``models.grouped_blocks.make_grouped_apply``); None applies the plain
    block slot by slot (the oracle).

    capture_states: also return, third, every step's recurrent state (A
    and z; or h and the conv tail) of every layer, leaves with a leading
    [S + L - 1] step axis (``boundary_states_from_capture`` gathers the
    segment boundaries from it). Only the band's slots change at a step,
    so step i's capture is the whole stacked state after it.

    stream_ys: bounded memory; return ``{"win": [W, B, T, D], "brow": [S,
    B, D]}`` in place of ys: ``win`` holds the last W = min(L, S) finished
    segments (segment s at ``win[s % W]``) and ``brow`` each segment's row
    ``retain_pos``, the same bits as ``ys[s, :, retain_pos]``.

    Under gradients (``training(params, segments)``) the out-of-place form
    runs, ``run_diagonal_grad`` (remat: each cell rematerialized);
    capture_states and stream_ys are forward-only there."""
    if training(params, segments):
        if capture_states or stream_ys:
            raise ValueError("run_diagonal: capture_states and stream_ys are forward-only")
        return run_diagonal_grad(layout, params, state0, segments,
                                 _cell(apply_block, grouped_apply), remat=remat)
    xs, carry = pipeline_init(layout, state0, segments, capture_states=capture_states,
                              stream_ys=stream_ys)
    cell = _cell(apply_block, grouped_apply)
    for _ in range(n_diagonal_groups(segments.shape[0], layout.n_layers)):
        band_step(layout, params, xs, carry, cell, retain_pos=retain_pos)
    out = ({"win": carry["win"], "brow": carry["brow"]} if stream_ys else carry["ys"])
    final = carry["state"]
    if capture_states:
        return out, final, carry["cap"]
    return out, final


# ---------------------------------------------------------------------------
# Resumable pipeline (interleaved admission)
# ---------------------------------------------------------------------------

def pipeline_init(layout, state0: Dict, segments: torch.Tensor, *,
                  capture_states: bool = False, stream_ys: bool = False):
    """(xs, carry) of a resumable diagonal prefill over ``segments [S, B,
    T, D]``. xs is the segments themselves (read-only; the port reads
    segment i at step i, so it needs no drain padding). The carry, all of
    it the pipeline's own buffers:

      * ``buf``   [L, B, T, D], the slot buffer;
      * ``state`` a copy of state0 (the executor state tree; its constant
        ck/cv shared, not copied);
      * ``step``  the group cursor, a host int (``core.schedule``'s
        ``segments_completed`` / ``segments_entered`` read it);
      * ``ys``    [S, B, T, D], each segment written as it finishes; or,
        with stream_ys, ``win`` [min(L, S), B, T, D] and ``brow`` [S, B, D]
        (see ``run_diagonal``);
      * ``cap``   with capture_states, the per-step recurrent state, leading
        axis [S + L - 1]."""
    _check_layout(layout)
    S, L = segments.shape[0], layout.n_layers
    shape, kw = tuple(segments.shape[1:]), dict(dtype=segments.dtype, device=segments.device)
    state = exec_state_copy(state0)
    carry = {"buf": torch.zeros((L,) + shape, **kw), "state": state, "step": 0}
    if stream_ys:
        carry["win"] = torch.zeros((min(L, S),) + shape, **kw)
        carry["brow"] = torch.zeros((S, shape[0], shape[2]), **kw)
    else:
        carry["ys"] = torch.zeros((S,) + shape, **kw)
    if capture_states:
        n = n_diagonal_groups(S, L)
        carry["cap"] = {part: tuple(
            {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype, device=v.device)
             for k, v in tree.items() if k in RECURRENT_KEYS} for tree in state[part])
            for part in ("prelude", "pattern")}
    return segments, carry


def pipeline_step(layout, params: Dict, xs: torch.Tensor, carry: Dict,
                  apply_block: ApplyBlock, *, n_groups: int = 1, grouped_apply=None,
                  retain_pos: int = -1) -> Dict:
    """Advance a suspended pipeline by ``n_groups`` steps, in place (the
    carry is also returned). Steps past the end of the grid are no-ops, so
    a budget that overshoots the last group is safe. retain_pos: the row
    a streaming carry keeps of each segment. Forward-only."""
    _forward_only(params, xs, "pipeline_step")
    cell = _cell(apply_block, grouped_apply)
    for _ in range(n_groups):
        band_step(layout, params, xs, carry, cell, retain_pos=retain_pos)
    return carry


def pipeline_step_pool(layout, params: Dict, xs_pool: Sequence[torch.Tensor],
                       carry_pool: Sequence[Dict], apply_block: ApplyBlock, *,
                       n_groups: int = 1, grouped_apply=None,
                       retain_pos: int = -1) -> List[Dict]:
    """Advance a pool of suspended pipelines by ``n_groups`` steps each, in
    place; their cursors (and grids) may differ.

    At a pattern position whose cell takes a layer index
    (``grouped_apply.indexed``, the ``attn`` and ``attn_moe`` cells), each
    step concatenates the live members' bands of that position along the
    group axis into one cell call over G' = sum of the band widths, each
    group reading its own layer's weights (the GEMM's ``widx``), and writes
    each member's part back into its own carry: one launch of each kernel
    per step for the whole pool. Members are not stacked along the batch
    axis, which would take the B = 1 cell off its fused route and round
    differently. A member whose cursor is past its grid contributes no
    group; a step with one live member is that member's own band step. A
    member's prelude slots run as its own one-group cells, and the other
    positions' cells (the mamba cells) member by member, in the same step;
    every output is written back after the step's last cell. A pattern
    with no indexed cell (falcon) advances the members one after another.
    Forward-only."""
    _forward_only(params, xs_pool, "pipeline_step_pool")
    cell = _cell(apply_block, grouped_apply)
    indexed = getattr(grouped_apply, "indexed", ()) if grouped_apply is not None else ()
    if not any(t in indexed for t in layout.pattern):
        for xs, carry in zip(xs_pool, carry_pool):
            pipeline_step(layout, params, xs, carry, apply_block, n_groups=n_groups,
                          grouped_apply=grouped_apply, retain_pos=retain_pos)
        return list(carry_pool)
    L = layout.n_layers
    layers = None
    for _ in range(n_groups):
        live = []
        for xs, carry in zip(xs_pool, carry_pool):
            if carry["step"] >= n_diagonal_groups(xs.shape[0], L):
                carry["step"] += 1
            else:
                live.append((xs, carry))
        if len(live) < 2:
            for xs, carry in live:
                band_step(layout, params, xs, carry, cell, retain_pos=retain_pos)
            continue
        if layers is None:
            layers = torch.arange(layout.n_super, dtype=torch.int32, device=live[0][0].device)
        bands = [_band_in(xs, carry, L) for xs, carry in live]
        outs = [_apply_prelude(layout, params, carry, lo, hi, cell) + ({},)
                for (_, carry), (lo, hi) in zip(live, bands)]
        for p, t in enumerate(layout.pattern):
            members = [(m, jb) for m, jb in
                       ((m, layout.position_band(p, lo, hi)) for m, (lo, hi) in enumerate(bands))
                       if jb is not None]
            if not members:
                continue
            if t not in indexed:
                for m, jb in members:
                    _apply_position(layout, params, live[m][1], p, jb, cell, outs[m][0],
                                    outs[m][2])
                continue
            sls = [_position_slots(layout, p, jb) for _, jb in members]
            states = [live[m][1]["state"]["pattern"][p] for m, _ in members]
            x = torch.cat([live[m][1]["buf"][sl] for (m, _), sl in zip(members, sls)])
            st = {k: torch.cat([s[k][j0:j1 + 1] for s, (_, (j0, j1)) in
                                zip(states, members)]) for k in states[0]}
            widx = torch.cat([layers[j0:j1 + 1] for _, (j0, j1) in members])
            y, new = grouped_apply(t, params["pattern"][p], x, st, widx=widx)
            off = 0
            for (m, jb), sl in zip(members, sls):
                g = jb[1] - jb[0] + 1
                outs[m][0].append((sl.start, sl.step, y[off:off + g]))
                outs[m][2][p] = (jb, {k: v[off:off + g] for k, v in new.items()})
                off += g
        pool_counts["steps"] += 1
        pool_counts["member_steps"] += len(live)
        for (_, carry), (parts, new_pre, new_pat) in zip(live, outs):
            _band_out(carry, parts, new_pre, new_pat, retain_pos=retain_pos)
    return list(carry_pool)


def pipeline_finalize(layout, carry: Dict):
    """A completed carry (cursor at or past S + L - 1) -> (ys [S, B, T, D],
    or ``{"win", "brow"}`` for a streaming carry; the final state; the
    boundary states gathered from the capture, or None)."""
    S = _segments(carry)
    if carry["step"] < n_diagonal_groups(S, layout.n_layers):
        raise ValueError(f"pipeline at step {carry['step']} of "
                         f"{n_diagonal_groups(S, layout.n_layers)} is not finished")
    captured = None
    if "cap" in carry:
        captured = boundary_states_from_capture(layout, carry["cap"], S)
    out = ({"win": carry["win"], "brow": carry["brow"]} if "win" in carry
           else carry["ys"])
    return out, carry["state"], captured
