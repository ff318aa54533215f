"""Sharding rules: path-based partition specs for params, optimizer state
(ZeRO-1), batches and decode states; the reference's ``parallel/
sharding.py``, rule for rule.

Axes: 'pod' (outer DP, multi-pod only), 'data' (DP), 'model' (TP/EP),
'stage' (diagonal-as-pipeline slot sharding; also the stacked per-layer dim
of pattern params).

A spec is a ``P``: one entry per dim, each None (replicated), an axis name
or a tuple of axis names (the dim is cut into the product of their sizes,
row-major in that order). A ``Sharding`` pairs a mesh with a spec, where
the reference has ``NamedSharding``. The rules read only the mesh's
``axis_names`` and ``shape``, so they run on a ``launch.mesh.Mesh`` over a
process group or on an ``AbstractMesh`` alike. The trees they walk are the
port's: nested dicts and tuples (or lists) whose leaves are tensors (the
meta device's shape trees included) or anything with a ``shape``; a Python
int leaf (a decode state's scalar ``pos``) has the shape ().

Where the reference's rules annotate arguments and GSPMD derives the
collectives, the port places them by hand (``parallel/comm.py``, the
tensor-parallel cells). A dim that does not divide its axis falls back to
replication; each fallback emits one structured warning line
(``repro_torch.parallel.sharding`` logger, deduplicated) naming the leaf
and dim, and counts in the default registry's ``sharding_fallback_total``
counter, labelled by kind, leaf, dim and axis (not deduplicated).
"""
from __future__ import annotations

import logging
import math
from typing import Any, Optional, Tuple

_log = logging.getLogger("repro_torch.parallel.sharding")
_warned: set = set()


class P(tuple):
    """A partition spec: ``P(None, "model")``; ``P()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Sharding:
    """A mesh and a spec: where each block of a tensor lives."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self) -> str:
        return f"Sharding({self.spec!r})"


def _warn_replicated(kind: str, leaf: str, dim: int, size: int,
                     axis: str, axis_size: int) -> None:
    """One structured line per distinct fallback: a dim a rule wanted to
    shard does not divide its mesh axis, so it is replicated instead.

    Every occurrence also increments the default registry's
    ``sharding_fallback_total`` counter (labelled kind/leaf/dim/axis); the
    counter is not deduplicated, the log line is (one per distinct site)."""
    _registry().inc("sharding_fallback_total", kind=kind, leaf=leaf,
                    dim=dim, axis=axis)
    key = (kind, leaf, dim, size, axis, axis_size)
    if key in _warned:
        return
    _warned.add(key)
    _log.warning(
        "sharding-fallback kind=%s leaf=%s dim=%d size=%d axis=%s "
        "axis_size=%d -> replicated", kind, leaf, dim, size, axis, axis_size)


def reset_fallback_warnings() -> None:
    """Clear the warning dedup set and the registry's fallback counter:
    one reset for both views of the same events. The other direction too:
    ``_registry()`` installs ``_warned.clear`` as a reset hook, so
    ``default_registry().reset()`` clears the dedup set."""
    _warned.clear()
    _registry().remove_series("sharding_fallback_total")


_hooked = False


def _registry():
    """The default telemetry registry, with this module's dedup set wired
    into its reset on first use. Imported at call time: the serve
    package's __init__ imports the engine, which imports this module."""
    global _hooked
    from repro_torch.serve.telemetry import default_registry
    reg = default_registry()
    if not _hooked:
        reg.register_reset_hook(_warned.clear)
        _hooked = True
    return reg


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _map_with_path(fn, tree, names=()):
    """fn(names, leaf) over a dict/tuple/list tree, keeping its structure;
    names are the dict keys and, for a sequence, ``[i]``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, names + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(list(names), tree)


def _flatten_with_path(tree, names=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten_with_path(v, names + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _flatten_with_path(v, names + (f"[{i}]",))]
    return [(names, tree)]


def spec_of(sharding) -> P:
    return sharding.spec if isinstance(sharding, Sharding) else P(*sharding)


# ---------------------------------------------------------------------------
# Mesh sizes
# ---------------------------------------------------------------------------

def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    return int(math.prod(mesh.shape[a] for a in dp_axes(mesh)))


def tp_size(mesh) -> int:
    return int(mesh.shape["model"]) if "model" in mesh.axis_names else 1


def stage_size(mesh) -> int:
    return int(mesh.shape["stage"]) if "stage" in mesh.axis_names else 1


def batch_axes(mesh, batch: int, *, leaf: str = ""):
    """Largest prefix of dp axes whose product divides the batch."""
    axes = []
    prod = 1
    for a in dp_axes(mesh):
        if batch % (prod * mesh.shape[a]) == 0:
            axes.append(a)
            prod *= mesh.shape[a]
    if batch > 1 and prod < dp_size(mesh):
        # batch > 1 cannot fill the dp axes: rows are (partly) replicated.
        # batch == 1 (a scheduler admission) is by design and stays quiet
        _warn_replicated("batch", leaf or "batch", 0, batch,
                         "x".join(dp_axes(mesh)) or "data", dp_size(mesh))
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


# ---------------------------------------------------------------------------
# Parameters and optimizer state
# ---------------------------------------------------------------------------

def param_leaf_spec(names, shape, tp: int) -> P:
    """Spec of one parameter leaf, ignoring any stacked leading dim (the
    caller prepends one for stacked pattern/enc-block params)."""
    if tp <= 1:   # no 'model' axis in this mesh (e.g. pure stage meshes)
        return P(*([None] * len(shape)))
    last = names[-1]
    leaf = ".".join(names)
    in_mem = "mem" in names
    in_moe = "moe" in names
    in_mixer = "mixer" in names

    def fallback(dim: int) -> None:
        _warn_replicated("param", leaf, dim, shape[dim], "model", tp)

    if last == "embed":
        if _div(shape[0], tp):
            return P("model", None)
        if _div(shape[1], tp):
            return P(None, "model")
        fallback(0)
        return P(None, None)
    if last == "head":
        if _div(shape[1], tp):
            return P(None, "model")
        if _div(shape[0], tp):
            return P("model", None)
        fallback(1)
        return P(None, None)
    if last in ("mem_tokens", "pos_embed", "pos", "router"):
        return P(*([None] * len(shape)))

    if in_moe and "shared" not in names and last in ("wg", "wu", "wd"):
        E = shape[0]
        if _div(E, tp):
            return P("model", None, None)          # expert parallelism
        # fall back: shard the FFN hidden dim
        if last in ("wg", "wu"):
            if _div(shape[2], tp):
                return P(None, None, "model")
            fallback(2)
            return P(None, None, None)
        if _div(shape[1], tp):
            return P(None, "model", None)
        fallback(1)
        return P(None, None, None)

    if in_mem:
        if last == "wv" and _div(shape[1], tp):
            return P(None, "model")
        return P(*([None] * len(shape)))           # wq/wk/wb are small: replicated

    if in_mixer:
        table = {
            "in_proj": P(None, "model"), "conv_w": P(None, "model"),
            "x_proj": P("model", None), "dt_proj": P(None, "model"),
            "A_log": P("model", None), "out_proj": P("model", None),
            "D": P("model"), "conv_b": P("model"), "dt_bias": P("model"),
        }
        spec = table.get(last, P(*([None] * len(shape))))
        # every sharded dim must divide; else replicate
        for d, ax in enumerate(spec):
            if ax is not None and not _div(shape[d], tp):
                fallback(d)
                return P(*([None] * len(shape)))
        return spec

    # attention / dense FFN projections
    if last in ("wq", "wk", "wv", "wg", "wu", "wi"):   # column parallel
        if _div(shape[1], tp):
            return P(None, "model")
        fallback(1)
        return P(None, None)
    if last in ("wo", "wd"):                           # row parallel
        if _div(shape[0], tp):
            return P("model", None)
        fallback(0)
        return P(None, None)
    return P(*([None] * len(shape)))                   # norms, biases, misc


def param_specs(params_shape: Any, mesh, *, fsdp: bool = False,
                stacked_axis: str = None) -> Any:
    """Tree of ``Sharding`` matching a parameter (shape) tree.

    fsdp=True also shards the first replicated, dp-divisible dim of every
    leaf over the DP axes (ZeRO-3/FSDP).

    stacked_axis: shard the stacked per-layer dim of pattern params over
    this mesh axis (the diagonal-as-pipeline slot sharding)."""
    tp = tp_size(mesh)

    def one(names, leaf):
        full = _shape(leaf)
        stacked = ("pattern" in names) or ("enc" in names and "blocks" in names)
        shape = full[1:] if stacked else full
        spec = list(param_leaf_spec(names, shape, tp))
        if stacked:
            ax = (stacked_axis if stacked_axis
                  and _div(full[0], mesh.shape[stacked_axis]) else None)
            if stacked_axis and ax is None:
                _warn_replicated("param", ".".join(names), 0, full[0],
                                 stacked_axis, int(mesh.shape[stacked_axis]))
            spec = [ax] + spec
        if fsdp:
            spec = _dp_cut(spec, full, mesh)
        return Sharding(mesh, P(*spec))

    return _map_with_path(one, params_shape)


def _dp_cut(spec, full, mesh) -> list:
    """spec with its first replicated dim that the DP size divides sharded
    over the DP axes (unchanged where none does)."""
    dp, dsz, spec = dp_axes(mesh), dp_size(mesh), list(spec)
    for d in range(len(full)):
        if dp and spec[d] is None and _div(full[d], dsz):
            spec[d] = dp if len(dp) > 1 else dp[0]
            break
    return spec


def zero1_specs(params_shape: Any, mesh, pspecs: Any = None) -> Any:
    """Optimizer-moment shardings: the param spec (``pspecs``, default the
    rules') with the first replicated, divisible dim also sharded over the
    DP axes (ZeRO-1)."""
    if pspecs is None:
        return param_specs(params_shape, mesh, fsdp=True)
    shapes = {tuple(n): _shape(leaf) for n, leaf in _flatten_with_path(params_shape)}
    return _map_with_path(lambda names, s: Sharding(
        mesh, P(*_dp_cut(spec_of(s), shapes[tuple(names)], mesh))), pspecs)


def opt_state_specs(opt_shape: Any, params_shape: Any, mesh, *,
                    zero1: bool = True, pspecs: Any = None) -> Any:
    """Shardings for the optimizer state tree ({"m", "v", "step"}); a
    factored second moment's leaves (vr/vc) are small and replicated.
    pspecs: the params' shardings the moments follow (default the rules';
    the mesh train step passes its local view's, ``models/model.py``
    ``local_param_specs``)."""
    base = (zero1_specs(params_shape, mesh, pspecs) if zero1
            else pspecs if pspecs is not None else param_specs(params_shape, mesh))
    rep = Sharding(mesh, P())
    flat_base = {tuple(names): s for names, s in _flatten_with_path(base)}

    def one_v(names, leaf):
        if names and names[-1] in ("vr", "vc"):
            return rep
        return flat_base.get(tuple(names), rep)

    v_specs = _map_with_path(one_v, opt_shape["v"])
    return {"m": base, "v": v_specs, "step": rep}


def batch_specs(mesh, batch_shape: Any) -> Any:
    """Shardings for a batch tree of arrays whose dim 0 is the batch."""
    def one(names, leaf):
        shape = _shape(leaf)
        ax = batch_axes(mesh, shape[0])
        return Sharding(mesh, P(ax, *([None] * (len(shape) - 1))))
    return _map_with_path(one, batch_shape)


# ---------------------------------------------------------------------------
# Decode state and the diagonal executor's carries
# ---------------------------------------------------------------------------

def decode_state_specs(state_shape: Any, mesh, batch: int, *,
                       stacked_axis: Optional[str] = None) -> Any:
    """Shardings for decode state trees (k/v caches, A/z, ssm h/conv, pos).

    The batch dim (the scheduler's decode slots) shards over the DP axes,
    head/d_model-like dims over 'model', small remainders replicate (with a
    fallback warning). ``pos`` may be a scalar (replicated) or a per-slot
    [batch] vector, which shards with the slots.

    stacked_axis: shard the leading n_super dim of pattern leaves over this
    mesh axis, as ``param_specs(stacked_axis=...)`` does."""
    tp = tp_size(mesh)

    def one(names, leaf):
        last = names[-1]
        leaf_name = ".".join(names)
        full = _shape(leaf)
        bax = batch_axes(mesh, batch, leaf=leaf_name)
        if last == "pos":
            # scalar: replicated; per-slot [batch] vector: sharded with slots
            spec = [bax] if len(full) == 1 else []
            return Sharding(mesh, P(*spec))
        stacked = "pattern" in names
        shape = full[1:] if stacked else full
        if last in ("k", "v", "ck", "cv"):          # [B, S, kv, hd]
            if tp <= 1:   # no 'model' axis in this mesh (e.g. data,stage)
                spec = [bax, None, None, None]
            elif _div(shape[2], tp):
                spec = [bax, None, "model", None]
            elif _div(shape[1], tp):
                # kv heads do not divide TP: shard the sequence dim of the
                # cache instead (the port's engine refuses such a mesh)
                spec = [bax, "model", None, None]
            else:
                _warn_replicated("decode_state", leaf_name, 2, shape[2],
                                 "model", tp)
                spec = [bax, None, None, None]
        elif last in ("A", "h", "conv"):
            # model-dim placement of the recurrent leaves: A [B, P, dv] dim 2,
            # h [B, dI, dS] dim 1, conv [B, dc-1, dI] dim 2
            d = 1 if last == "h" else 2
            spec = [bax] + [None] * (len(shape) - 1)
            if tp > 1:
                if _div(shape[d], tp):
                    spec[d] = "model"
                else:
                    _warn_replicated("decode_state", leaf_name, d, shape[d],
                                     "model", tp)
        elif last == "z":                           # [B, P]
            spec = [bax, None]
        else:
            spec = [bax] + [None] * (len(shape) - 1)
        if stacked:
            ax = (stacked_axis if stacked_axis
                  and _div(full[0], mesh.shape[stacked_axis]) else None)
            if stacked_axis and ax is None:
                _warn_replicated("decode_state", leaf_name, 0, full[0],
                                 stacked_axis, int(mesh.shape[stacked_axis]))
            spec = [ax] + spec
        return Sharding(mesh, P(*spec))

    return _map_with_path(one, state_shape)


def slot_buf_spec(mesh, n_layers: int, batch: int) -> Optional[P]:
    """Spec for the diagonal executor's slot buffer [L, B, T, D]: slots
    over 'stage', the batch over the DP axes; None when the mesh offers
    neither."""
    stage = None
    if "stage" in mesh.axis_names:
        if _div(n_layers, stage_size(mesh)):
            stage = "stage"
        else:
            _warn_replicated("slot_buf", "buf", 0, n_layers, "stage",
                             stage_size(mesh))
    bax = batch_axes(mesh, batch, leaf="slot_buf")
    if stage is None and bax is None:
        return None
    return P(stage, bax, None, None)


def pipeline_carry_specs(carry_shape: Any, mesh, n_layers: int, batch: int, *,
                         stacked_axis: Optional[str] = None) -> Any:
    """Shardings for a suspended diagonal-pipeline carry and its read-only
    ``xs`` input:

      * ``buf`` [L, B, T, D]: ``slot_buf_spec``;
      * ``state``: the decode-state rules;
      * ``ys`` / ``xs`` / ``win`` [S(+L-1), B, T, D]: batch over the DP
        axes, the segment/step dims replicated;
      * ``brow`` [S, B, D]: batch over the DP axes;
      * ``cap`` [S+L-1, (n_super,) B, ...]: batch over the DP axes, the
        stacked dim over ``stacked_axis`` when it divides;
      * ``step``: replicated.

    Only the keys present in ``carry_shape`` (plus ``xs``) are returned."""
    bspec = slot_buf_spec(mesh, n_layers, batch)
    bax = batch_axes(mesh, batch, leaf="pipeline_carry")
    seg_spec = Sharding(mesh, P(None, bax, None, None))
    out = {
        "buf": Sharding(mesh, bspec if bspec is not None else P(None, None, None, None)),
        "state": decode_state_specs(carry_shape["state"], mesh, batch,
                                    stacked_axis=stacked_axis),
        "step": Sharding(mesh, P()),
        "xs": seg_spec,
    }
    if "ys" in carry_shape:
        out["ys"] = seg_spec
    if "win" in carry_shape:
        out["win"] = seg_spec
    if "brow" in carry_shape:
        out["brow"] = Sharding(mesh, P(None, bax, None))
    if "cap" in carry_shape:
        def one(names, leaf):
            shape = _shape(leaf)
            stacked = "pattern" in names
            bdim = 2 if stacked else 1           # [steps, (n_super,) B, ...]
            spec = [None] * len(shape)
            if len(shape) > bdim:
                spec[bdim] = bax
            if (stacked and stacked_axis
                    and _div(shape[1], mesh.shape[stacked_axis])):
                spec[1] = stacked_axis
            return Sharding(mesh, P(*spec))
        out["cap"] = _map_with_path(one, carry_shape["cap"])
    return out


class _Shape:
    """A leaf's shape alone (a pool member's, its pool axis dropped)."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def pool_carry_specs(carry_pool: Any, mesh, n_layers: int, batch: int, *,
                     stacked_axis: Optional[str] = None) -> Any:
    """Shardings for a pooled admission carry: every leaf of ``carry_pool``
    leads with a pool axis [n_pool, ...] stacking same-shape B = 1 carries.
    The pool axis is replicated; within a member the layout is
    ``pipeline_carry_specs``'s. ``xs`` is not part of a carry pool: only the
    carry keys are returned."""
    member = _map_with_path(lambda names, a: _Shape(_shape(a)[1:]), carry_pool)
    base = pipeline_carry_specs(member, mesh, n_layers, batch,
                                stacked_axis=stacked_axis)
    base.pop("xs")
    return _map_with_path(lambda names, s: Sharding(mesh, P(None, *s.spec)), base)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, P())
