"""Training through the port against the JAX reference at smoke size (fp32,
CPU): ``lm_loss`` and every parameter's gradient against
``jax.value_and_grad`` of the reference's ``lm_loss`` (diagonal and
sequential, on the kernels' autograd Functions and on the plain path,
segmented with and without a needle loss mask, full mode at 512 tokens,
where the 256-token CE chunks run); the out-of-place executors against
the in-place ones to the bit, remat leaving the forward and the gradients
unchanged; one ``make_train_step`` step against the reference's (and two
microbatches, and the non-finite skip); the fault-tolerant loop (the loss
falls, a resume continues to the bit, metrics are journaled, the CLI);
and the families once refused (mamba, MoE, the encoder-decoder) taking a
step; whisper refused by the frameless loop. The reference's gradients are
computed once per module (jitted, the sequential schedule: the same
function)."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import OptimConfig as JOptimConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.train.state import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import diagonal as diag  # noqa: E402
from repro_torch.core import sequential as seq  # noqa: E402
from repro_torch.core.schedule import StackLayout  # noqa: E402
from repro_torch.data import lm_stream  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.blocks import make_apply_block  # noqa: E402
from repro_torch.models.grouped_blocks import make_grouped_apply  # noqa: E402
from repro_torch.optim import OptimConfig, adamw_init  # noqa: E402
from repro_torch.train import make_train_step, train_loop  # noqa: E402
from repro_torch.utils import tree_flatten_with_path, tree_leaves, tree_map  # noqa: E402

ARCH = "llama-1b-armt"
B, N_TOK, N_FULL = 2, 48, 512     # 3 segments of 16; full mode in two CE chunks
LOSS_RTOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops: the suite runs in
    parallel workers, and an oversubscribed pool made the training loop's
    thousands of small ops ~20x slower on a busy machine. The count before
    is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jpaths(tree):
    """{path: leaf} of a JAX tree, paths as the port's ("pattern/0/attn/wq")."""
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return {"/".join(key(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def ref():
    """The reference's params (as numpy), a batch, a needle mask and its
    lm_loss value and gradients: segmented (with a mask of ones and with
    the needle mask; one compile) and full mode at N_FULL tokens."""
    jc = j_smoke(ARCH)
    jp = jax.jit(lambda key: jmodel.init_params(jc, key))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab, (B, N_TOK)).astype(np.int32)
    labels = rng.integers(0, jc.vocab, (B, N_TOK)).astype(np.int32)
    needle = np.zeros((B, N_TOK), np.float32)
    needle[:, [5, 20, 47]] = 1.0     # a few answer positions, in two segments
    seg = jax.jit(jax.value_and_grad(lambda p, t, l, m: jmodel.lm_loss(
        p, jc, t, l, schedule="sequential", loss_mask=m)))
    out = {"params": jax.tree_util.tree_map(np.asarray, jp), "tokens": tokens,
           "labels": labels, "needle_mask": needle}
    for name, mask in (("ones", np.ones_like(needle)), ("needle", needle)):
        loss, g = seg(jp, tokens, labels, mask)
        out[name] = (float(loss), _jpaths(g))
    ft = rng.integers(0, jc.vocab, (1, N_FULL)).astype(np.int32)
    fl = rng.integers(0, jc.vocab, (1, N_FULL)).astype(np.int32)
    loss, g = jax.jit(jax.value_and_grad(lambda p, t, l: jmodel.lm_loss(
        p, jc, t, l, schedule="sequential", mode="full")))(jp, ft, fl)
    out["full"] = (float(loss), _jpaths(g), ft, fl)
    return out


def _params(ref, requires_grad=True):
    p = params_from_jax(ref["params"], "cpu")
    return tree_map(lambda t: t.requires_grad_(), p) if requires_grad else p


def _check_grads(loss, params, want_loss, want_grads):
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    got = dict(tree_flatten_with_path(params))
    assert got.keys() == want_grads.keys()
    errs = {k: _rel(t.grad, want_grads[k]) for k, t in got.items()
            if np.linalg.norm(want_grads[k]) > 0}
    assert max(errs.values()) <= GRAD_TOL, errs
    for k, t in got.items():      # leaves the loss does not reach: zero on both sides
        if np.linalg.norm(want_grads[k]) == 0:
            assert t.grad is None or not t.grad.any(), k


@pytest.mark.parametrize("schedule", ["diagonal", "sequential"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mask", ["none", "needle"])
def test_lm_loss_and_grads_match_reference(ref, schedule, fused, mask):
    p = _params(ref)
    loss_mask = None if mask == "none" else torch.from_numpy(ref["needle_mask"])
    loss = tmodel.lm_loss(p, t_smoke(ARCH), torch.from_numpy(ref["tokens"]),
                          torch.from_numpy(ref["labels"]), schedule=schedule, fused=fused,
                          loss_mask=loss_mask)
    loss.backward()
    _check_grads(loss, p, *ref["ones" if mask == "none" else "needle"])


@pytest.mark.parametrize("schedule", ["diagonal", "sequential"])
@pytest.mark.parametrize("fused", [True, False])
def test_lm_loss_full_mode_chunked_matches_reference(ref, schedule, fused):
    """Full mode over 512 tokens: one segment, its CE in two chunks of 256;
    the memory weights and tokens get no gradient on either side."""
    want_loss, want_grads, ft, fl = ref["full"]
    p = _params(ref)
    loss = tmodel.lm_loss(p, t_smoke(ARCH), torch.from_numpy(ft), torch.from_numpy(fl),
                          schedule=schedule, fused=fused, mode="full")
    loss.backward()
    _check_grads(loss, p, want_loss, want_grads)


# ---------------------------------------------------------------------------
# the out-of-place executors and remat
# ---------------------------------------------------------------------------

def _same_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("arch", ["llama-1b-armt", "jamba-1.5-large-398b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("fused", [True, False])
def test_out_of_place_executors_equal_in_place(arch, fused):
    """run_diagonal_grad and run_sequential_grad against the in-place
    executors on the same cells and inputs (gradients off on both, so the
    blocks compute alike), outputs and final state to the bit: llama, a
    three-position pattern with strided bands (jamba), a prelude (kimi)."""
    cfg = t_smoke(arch)
    params = tmodel.init_params(cfg, 0, device="cpu")
    layout = StackLayout.from_config(cfg)
    x = tmodel.embed_segments(params, cfg, torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 48))), 16)
    state0 = tmodel.init_state(cfg, 2, "cpu")
    exec_params = {"prelude": params["prelude"], "pattern": params["pattern"]}
    apply = make_apply_block(cfg)
    cell = make_grouped_apply(cfg) if fused else None
    with torch.no_grad():
        want = diag.run_diagonal(layout, exec_params, state0, x, apply, grouped_apply=cell)
        got = diag.run_diagonal_grad(layout, exec_params, state0, x,
                                     cell or diag._per_slot_apply(apply))
        assert _same_tree(got, want)
        one = seq.one_layer_cell(cell) if fused else apply
        want = seq.run_sequential(layout, exec_params, state0, x, one)
        assert _same_tree(seq.run_sequential_grad(layout, exec_params, state0, x, one), want)


@pytest.mark.parametrize("schedule", ["diagonal", "sequential"])
@pytest.mark.parametrize("mode", ["segmented", "full"])
def test_forward_under_grad_and_remat_unchanged(ref, schedule, mode):
    """The fused path's forward with gradients on (the out-of-place
    executors, the kernels' autograd Functions, the unfused B == 1 route)
    equals the forward without, to the bit; remat "full" leaves it and
    every gradient unchanged (on the CPU, to the bit)."""
    cfg = t_smoke(ARCH)
    toks = torch.from_numpy(ref["tokens"][:1])    # B = 1: the fused update's route
    with torch.no_grad():
        want = tmodel.forward_hidden(_params(ref, False), cfg, toks, schedule=schedule,
                                     mode=mode)
    grads = []
    for remat in ("none", "full"):
        p = _params(ref)
        got = tmodel.forward_hidden(p, dataclasses.replace(cfg, remat=remat), toks,
                                    schedule=schedule, mode=mode)
        assert _same_tree(got, want), remat
        (got[0].square().sum() + sum(v.sum() for v in tree_leaves(got[1]))).backward()
        grads.append([t.grad for t in tree_leaves(p)])
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(*grads))


def test_forward_only_paths_refused_under_grad(ref):
    cfg = t_smoke(ARCH)
    p = _params(ref)
    toks = torch.from_numpy(ref["tokens"])
    for schedule in ("diagonal", "sequential"):
        with pytest.raises(ValueError, match="forward-only"):
            tmodel.forward_hidden(p, cfg, toks, schedule=schedule, capture_states=True)
    layout = StackLayout.from_config(cfg)
    x = tmodel.embed_segments(p, cfg, toks, 16)
    exec_params = {"prelude": p["prelude"], "pattern": p["pattern"]}
    apply = make_apply_block(cfg)
    with pytest.raises(ValueError, match="forward-only"):
        diag.run_diagonal(layout, exec_params, tmodel.init_state(cfg, B, "cpu"), x, apply,
                          stream_ys=True)
    xs, carry = diag.pipeline_init(layout, tmodel.init_state(cfg, B, "cpu"), x)
    with pytest.raises(ValueError, match="forward-only"):
        diag.pipeline_step(layout, exec_params, xs, carry, apply)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b",
                                  "qwen2-moe-a2.7b", "whisper-medium"])
def test_make_train_step_refuses_what_has_no_backward(arch):
    """The families the port once refused (mamba, the hybrid, MoE, the
    encoder-decoder) now build a step: one step at smoke size on 2
    segments (whisper's batch with its frames) is finite, not skipped, and
    moves every parameter the loss reaches. What training still refuses
    (the MoE's einsum dispatch, whisper through the frameless loop) is
    below and in tests/test_torch_train_families.py."""
    cfg = t_smoke(arch, seq_len=32)
    seg = tmodel.segment_len(cfg) if cfg.armt is not None else 32
    ocfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    params = tmodel.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 2 * seg + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encoder is not None:
        batch["enc_frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))
    state, metrics = make_train_step(cfg, ocfg, schedule="diagonal")(
        {"params": params, "opt": adamw_init(params, ocfg)}, batch)
    assert metrics["skipped"].item() == 0.0 and np.isfinite(metrics["loss"].item())
    assert np.isfinite(metrics["grad_norm"].item()) and metrics["grad_norm"].item() > 0
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(state["params"]),
                                                    tree_leaves(params))]
    assert sum(moved) >= len(moved) - 1    # at most one leaf the loss never reaches


def test_train_loop_refuses_whisper():
    """The loop's streams carry no frames, so whisper (the reference's loop
    stops at its forward's missing frames) is refused with a ValueError
    that says so, through the library and the CLI."""
    cfg = t_smoke("whisper-medium", seq_len=32)
    with pytest.raises(ValueError, match="no frames"):
        train_loop(cfg, OptimConfig(), lm_stream(cfg.vocab, 2, 32, seed=0), steps=1,
                   device="cpu")
    with pytest.raises(ValueError, match="no frames"):
        launch_train.main(["--arch", "whisper-medium", "--smoke", "--device", "cpu",
                           "--steps", "1", "--batch", "2", "--seq-len", "32"])


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_step(ref):
    """One step of the reference's make_train_step (sequential schedule)
    from its params and zero optimizer state, on the batch."""
    jc = j_smoke(ARCH)
    jocfg = JOptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jp = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    state, metrics = jax.jit(j_make_train_step(jc, jocfg, schedule="sequential"))(
        {"params": jp, "opt": j_adamw_init(jp, jocfg)},
        {"tokens": ref["tokens"], "labels": ref["labels"]})
    return _jpaths(state), {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(ref, ref_step, microbatches):
    """loss, grad_norm and lr within 1e-5; every param and moment within
    1e-5 of the reference's after the step. Two microbatches of one row
    each (equal token counts, so the mean of their means is the batch
    mean) are held against the reference's one."""
    ocfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = _params(ref, False)
    step = make_train_step(t_smoke(ARCH), ocfg, schedule="diagonal", microbatches=microbatches)
    state, metrics = step({"params": params, "opt": adamw_init(params, ocfg)},
                          {"tokens": torch.from_numpy(ref["tokens"]),
                           "labels": torch.from_numpy(ref["labels"])})
    want_state, want_metrics = ref_step
    assert metrics["skipped"].item() == 0.0
    for k in ("loss", "grad_norm", "lr"):
        assert metrics[k].dim() == 0
        np.testing.assert_allclose(metrics[k].item(), want_metrics[k], rtol=STEP_TOL)
    got = dict(tree_flatten_with_path(state))
    assert set(got) == set(want_state)
    for k, t in got.items():
        np.testing.assert_allclose(t.double().numpy(), want_state[k], rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=k)


def test_train_step_skips_nonfinite(ref):
    """A NaN in one weight makes the loss NaN: the step is skipped, its
    params and moments come back equal to the bit to those it was given
    (which it did not modify), and the next step's counter is unmoved."""
    ocfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = _params(ref, False)
    params["embed"][3, 0] = float("nan")
    state = {"params": params, "opt": adamw_init(params, ocfg)}
    before = tree_map(torch.clone, state)
    new, metrics = make_train_step(t_smoke(ARCH), ocfg)(
        state, {"tokens": torch.from_numpy(ref["tokens"]),
                "labels": torch.from_numpy(ref["labels"])})
    assert metrics["skipped"].item() == 1.0 and not np.isfinite(metrics["loss"].item())
    for a, b, c in zip(tree_leaves(new), tree_leaves(before), tree_leaves(state)):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
        assert torch.equal(c.nan_to_num(7.0), b.nan_to_num(7.0))


# ---------------------------------------------------------------------------
# the fault-tolerant loop
# ---------------------------------------------------------------------------

def test_train_loop_learns_and_resumes_to_the_bit(tmp_path):
    """30 steps on the Markov LM stream: the mean loss of the last 5 below
    that of the first 5. Then 10 steps with checkpoints every 5, and a
    fresh loop over the same directory to 15: it resumes at step 10, its
    losses equal the uninterrupted run's to the bit, and metrics.jsonl has
    every step."""
    cfg = t_smoke(ARCH, seq_len=32)
    ocfg = OptimConfig(lr=3e-3, total_steps=30, warmup_steps=3)

    def run(steps, **kw):
        return train_loop(cfg, ocfg, lm_stream(cfg.vocab, 2, 32, seed=0), steps=steps,
                          schedule="diagonal", device="cpu", **kw)
    full = [h["loss"] for h in run(30)["history"]]
    assert np.mean(full[-5:]) < np.mean(full[:5]) - 0.1, full
    first = run(10, ckpt_dir=str(tmp_path), ckpt_every=5)
    assert first["last_step"] == 10
    second = run(15, ckpt_dir=str(tmp_path), ckpt_every=5)
    assert [h["step"] for h in second["history"]] == list(range(10, 15))
    assert [h["loss"] for h in second["history"]] == full[10:15]
    assert second["last_step"] == 15
    lines = [json.loads(l) for l in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == list(range(15))


def test_launch_train_cli_runs_on_the_cpu(tmp_path):
    """The CLI on the needle task (its loss mask through the step), with a
    checkpoint at the end."""
    out = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                             "--batch", "2", "--seq-len", "32", "--ckpt-dir", str(tmp_path)])
    assert out["last_step"] == 3 and len(out["history"]) == 3
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert (tmp_path / "step_3" / "manifest.json").exists()
