"""The training path's pieces in the port against the JAX reference, on
the CPU: AdamW (fp32 and bf16 params, bf16 moments, the factored second
moment, clipping on and off) and its schedule, the synthetic data
streams, the MoE's load-balance loss, the original-RMT contrast
(``core/rmt.py``), the step checkpoints, and each training kernel's
backward formula (``kernels/grad.py``) against autograd through the
kernel's plain version, with a control that must fail."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import rmt as jrmt  # noqa: E402
from repro.core.schedule import StackLayout as JLayout  # noqa: E402
from repro.data import lm_stream as j_lm_stream  # noqa: E402
from repro.data import needle_qa as j_needle_qa  # noqa: E402
from repro.models.moe import aux_load_balance_loss as j_aux  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import rmt as trmt  # noqa: E402
from repro_torch.core.schedule import StackLayout  # noqa: E402
from repro_torch.data import lm_stream, needle_qa  # noqa: E402
from repro_torch.kernels import armt_memory, flash_attention, grouped_matmul, ref  # noqa: E402
from repro_torch.models.moe import aux_load_balance_loss  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.utils import tree_flatten_with_path, tree_map  # noqa: E402

# fp32 on both sides: the same formulas, rounded in another order
RTOL = 1e-5
# a backward formula against autograd through the plain version, fp32
GRAD_TOL = 1e-4


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


def _jpaths(tree, is_leaf=None):
    """{path: leaf} of a JAX tree, paths as the port's ("a/0/b")."""
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return {"/".join(key(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype or torch.float32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

VARIANTS = {
    "fp32": (torch.float32, {}),
    "bf16_params": (torch.bfloat16, {}),
    "bf16_moments": (torch.float32, {"moment_dtype": "bfloat16"}),
    "factored_v": (torch.float32, {"factored_v": True}),
    "no_clip": (torch.float32, {"clip_norm": 0.0}),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_adamw_update_matches_reference(variant):
    """Three AdamW steps on a random tree (a 3-D stack, a matrix, a vector
    and a tuple), grads large enough to clip, from the same values: new
    params, moments, lr and grad_norm. bf16 leaves within one bf16 step
    (the fp32 math rounds in another order before the cast)."""
    dtype, kw = VARIANTS[variant]
    ocfg = adamw.OptimConfig(lr=1e-2, warmup_steps=2, total_steps=10, **kw)
    jocfg = jadamw.OptimConfig(lr=1e-2, warmup_steps=2, total_steps=10, **kw)
    rng = np.random.default_rng(0)
    shapes = {"stack": (2, 6, 5), "w": (4, 3), "b": (7,), "t": ((3, 2), (5,))}

    def draw(scale):
        return {k: (tuple(rng.standard_normal(s) * scale for s in v) if k == "t"
                    else rng.standard_normal(v) * scale) for k, v in shapes.items()}
    p0 = draw(1.0)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32).astype(jdt), p0)
    tp = tree_map(lambda a: _t(a, dtype), p0)
    jopt, topt = jadamw.adamw_init(jp, jocfg), adamw.adamw_init(tp, ocfg)
    tol = 2 ** -7 if dtype == torch.bfloat16 or kw.get("moment_dtype") else RTOL
    jupdate = jax.jit(jadamw.adamw_update, static_argnums=3)
    for _ in range(3):
        g = draw(3.0)
        jp, jopt, jm = jupdate(
            jp, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32).astype(jdt), g),
            jopt, jocfg)
        tp, topt, tm = adamw.adamw_update(tp, tree_map(lambda a: _t(a, dtype), g), topt, ocfg)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=RTOL)
        want = _jpaths({"p": jp, "m": jopt["m"], "v": jopt["v"]})
        got = dict(tree_flatten_with_path({"p": tp, "m": topt["m"], "v": topt["v"]}))
        assert got.keys() == want.keys()
        for path, t in got.items():
            np.testing.assert_allclose(_np(t), _np(want[path]), rtol=tol, atol=tol * 1e-2,
                                       err_msg=path)
        assert int(topt["step"]) == int(jopt["step"])
    if kw.get("factored_v"):
        assert set(topt["v"]["stack"]) == {"vr", "vc"} and topt["v"]["b"].shape == (7,)


def test_lr_schedule_matches_reference():
    ocfg = adamw.OptimConfig(lr=3e-3, warmup_steps=5, total_steps=40, min_lr_ratio=0.2)
    jocfg = jadamw.OptimConfig(lr=3e-3, warmup_steps=5, total_steps=40, min_lr_ratio=0.2)
    for s in (0, 1, 3, 5, 6, 17, 39, 40, 55):
        np.testing.assert_allclose(
            adamw.lr_schedule(ocfg, torch.tensor(s, dtype=torch.int32)).item(),
            float(jadamw.lr_schedule(jocfg, jnp.int32(s))), rtol=RTOL)


# ---------------------------------------------------------------------------
# data, the MoE's auxiliary loss, the original RMT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_data_streams_equal_reference(seed):
    """lm_stream and needle_qa give the reference's arrays for (seed,
    step), steps 0-2, and from a later start_step."""
    for port, refgen, kw in ((lm_stream, j_lm_stream, {}),
                             (needle_qa, j_needle_qa, {"n_keys": 8})):
        a, b = port(256, 3, 40, seed=seed, **kw), refgen(256, 3, 40, seed=seed, **kw)
        for _ in range(3):
            x, y = next(a), next(b)
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    x = next(lm_stream(256, 2, 16, seed=seed, start_step=5))
    y = next(j_lm_stream(256, 2, 16, seed=seed, start_step=5))
    assert all(np.array_equal(x[k], y[k]) for k in x)


def test_aux_load_balance_loss_matches_reference():
    cfg = t_smoke("qwen2-moe-a2.7b")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((cfg.d_model, cfg.moe.n_experts)) * 0.3).astype(np.float32)
    want = float(j_aux(jnp.asarray(x), {"router": jnp.asarray(router)},
                       j_smoke("qwen2-moe-a2.7b").moe))
    got = aux_load_balance_loss(torch.from_numpy(x), {"router": torch.from_numpy(router)},
                                cfg.moe)
    np.testing.assert_allclose(got.item(), want, rtol=RTOL)


def test_rmt_dependencies_and_violation_match_reference():
    for s in range(4):
        for l in range(5):
            assert trmt.rmt_dependencies(s, l, 5) == jrmt.rmt_dependencies(s, l, 5)
    for S in range(1, 6):
        for L in range(1, 6):
            assert trmt.diagonal_violates_rmt(S, L) == jrmt.diagonal_violates_rmt(S, L), (S, L)
    assert trmt.diagonal_violates_rmt(3, 2) and not trmt.diagonal_violates_rmt(3, 1)


def _rmt_inputs():
    rng = np.random.default_rng(4)
    W = (rng.standard_normal((3, 16, 16)) * 0.4).astype(np.float32)
    mem0 = rng.standard_normal((2, 3, 16)).astype(np.float32)
    segs = rng.standard_normal((4, 2, 5, 16)).astype(np.float32)
    return W, mem0, segs


@pytest.fixture(scope="module")
def rmt_reference():
    """The reference's run_rmt over a 3-layer stack of tanh(x W) blocks, 4
    segments: (ys, final memory, the gradient of sum(ys^2) + sum(memory) to
    the stacked W), computed once."""
    W, mem0, segs = _rmt_inputs()
    layout = JLayout.from_config(dataclasses.replace(j_smoke("llama-1b-armt"), n_layers=3))

    def run(W):
        ys, mem = jrmt.run_rmt(layout, {"prelude": (), "pattern": ({"w": W},)},
                               jnp.asarray(mem0), jnp.asarray(segs),
                               lambda t, p, x, st: (jnp.tanh(x @ p["w"]), st))
        return jnp.square(ys).sum() + mem.sum(), (ys, mem)
    (_, (ys, mem)), g = jax.jit(jax.value_and_grad(run, has_aux=True))(jnp.asarray(W))
    return np.asarray(ys), np.asarray(mem), np.asarray(g)


@pytest.mark.parametrize("remat", [False, True])
def test_run_rmt_matches_reference(remat, rmt_reference):
    """run_rmt's outputs, final memory and weight gradient against the
    reference's; remat recomputes each block in the backward."""
    W, mem0, segs = _rmt_inputs()
    cfg = dataclasses.replace(t_smoke("llama-1b-armt"), n_layers=3)
    w = torch.from_numpy(W).requires_grad_()
    ys, mem = trmt.run_rmt(StackLayout.from_config(cfg),
                           {"prelude": (), "pattern": ({"w": w},)}, torch.from_numpy(mem0),
                           torch.from_numpy(segs),
                           lambda t, p, x, st: (torch.tanh(x @ p["w"]), st), remat=remat)
    (ys.square().sum() + mem.sum()).backward()
    jys, jmem, jg = rmt_reference
    np.testing.assert_allclose(_np(ys), jys, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(_np(mem), jmem, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(_np(w.grad), jg, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# step checkpoints
# ---------------------------------------------------------------------------

def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "nested": {"b": torch.randn(3, generator=g).to(torch.bfloat16),
                       "t": (torch.randn(2, 2, generator=g),
                             torch.zeros((), dtype=torch.int32))}}


def _same(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for (_, x), (_, y) in zip(tree_flatten_with_path(a), tree_flatten_with_path(b)))


def test_checkpoint_roundtrip_keep_k_and_latest(tmp_path):
    """A bf16, fp32 and int32 tree comes back to the bit; keep=2 keeps the
    two newest; the latest of many is what restore takes by default."""
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    trees = {s: _tree(s) for s in (1, 2, 3, 4)}
    for s, t in trees.items():
        mgr.save(s, t)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert _same(mgr.restore(_tree(0)), trees[4])
    assert _same(mgr.restore(_tree(0), step=3), trees[3])
    manifest = json.loads((tmp_path / "step_4" / "manifest.json").read_text())
    assert [l["path"] for l in manifest["leaves"]] == ["a", "nested/b", "nested/t/0",
                                                        "nested/t/1"]
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_checkpoint_corruption_detected(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, _tree(0))
    leaf = tmp_path / "step_1" / "leaf_0.npy"
    arr = np.load(leaf)
    arr.ravel()[0] += 1
    np.save(leaf, arr)
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(_tree(0))
    assert _same(mgr.restore(_tree(0), verify=False)["nested"], _tree(0)["nested"])


def test_checkpoint_async_save_then_restore(tmp_path):
    """An async save copies the leaves first: updating the tree in place
    after save returns does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    tree = _tree(5)
    want = tree_map(torch.clone, tree)
    mgr.save(5, tree)
    tree["a"].add_(1.0)
    mgr.wait()
    assert _same(mgr.restore(_tree(0)), want)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(_tree(0))


# ---------------------------------------------------------------------------
# the backward formulas against autograd through the plain versions
# ---------------------------------------------------------------------------

def _grads(fn, inputs, seed=0):
    """Gradients of sum(outputs * fixed random weights) to the inputs."""
    leaves = [t.clone().requires_grad_() if t is not None else None for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator().manual_seed(seed)
    sum(((o.float() * torch.randn(o.shape, generator=g)).sum() for o in outs)).backward()
    return [t.grad for t in leaves if t is not None]


def _rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _gemm_case(act, bias, res):
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((3, 10, 16)))
    w = _t(rng.standard_normal((3, 16, 24)) * 0.3)
    b = _t(rng.standard_normal((3, 24))) if bias else None
    r = _t(rng.standard_normal((3, 10, 24))) if res else None
    return ([x, w, b, r],
            lambda x, w, b, r: grouped_matmul.grouped_matmul(x, w, b, activation=act, res=r),
            lambda x, w, b, r: ref.grouped_matmul_ref(x, w, b, activation=act, res=r))


def _flash_case(causal, window):
    rng = np.random.default_rng(6)
    q = _t(rng.standard_normal((3, 6, 12, 8)))
    k, v = (_t(rng.standard_normal((3, 2, 12, 8))) for _ in range(2))
    return ([q, k, v],
            lambda q, k, v: flash_attention.flash_attention(q, k, v, causal=causal,
                                                            window=window),
            lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=causal, window=window))


def _read_case(shared):
    rng = np.random.default_rng(7)
    N, T, D, dm = 6, 9, 16, 4
    wq = _t(rng.standard_normal((D, dm) if shared else (3, D, dm)) * 0.3)
    return ([_t(rng.standard_normal((N, T, D))), wq,
             _t(rng.standard_normal((N, 6 * dm, D)) * 0.1),
             _t(rng.uniform(0.5, 1.5, (N, 6 * dm)))],
            lambda *a: armt_memory.armt_read(*a, nu=3),
            lambda *a: ref.armt_read_ref(*a, nu=3))


def _update_case(shared):
    rng = np.random.default_rng(8)
    N, M, D, dm = 6, 5, 16, 4
    lead = () if shared else (3,)
    ws = [_t(rng.standard_normal(lead + (D, e)) * 0.3) for e in (dm, D, 1)]
    return ([_t(rng.standard_normal((N, M, D))), *ws,
             _t(rng.standard_normal((N, 6 * dm, D)) * 0.1),
             _t(rng.uniform(0.5, 1.5, (N, 6 * dm)))],
            lambda *a: armt_memory.armt_update(*a, nu=3),
            lambda *a: ref.armt_update_ref(*a, nu=3))


CASES = {**{f"gemm_{a}_{int(b)}{int(r)}": (_gemm_case, (a, b, r))
            for a in (None, "silu", "gelu") for b, r in ((False, False), (True, True))},
         "flash_causal": (_flash_case, (True, 0)), "flash_window": (_flash_case, (True, 5)),
         "flash_bidirectional": (_flash_case, (False, 0)),
         "read": (_read_case, (False,)), "read_shared": (_read_case, (True,)),
         "update": (_update_case, (False,)), "update_shared": (_update_case, (True,))}


@pytest.mark.parametrize("case", list(CASES))
def test_backward_formula_matches_autograd_of_plain(case):
    """The kernel wrapper's autograd Function (on the CPU: the plain
    forward, then its backward formula) against autograd through the plain
    version, every input's gradient within GRAD_TOL; the same comparison
    with one gradient scaled by 0.98 (a control) must fail it."""
    make, args = CASES[case]
    inputs, kernel, plain = make(*args)
    got, want = _grads(kernel, inputs), _grads(plain, inputs)
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= GRAD_TOL, errs
    assert _rel(got[0] * 0.98, want[0]) > GRAD_TOL


def test_forward_only_options_refused_under_grad():
    x = torch.randn(2, 4, 8, requires_grad=True)
    w = torch.randn(2, 8, 8)
    with pytest.raises(ValueError, match="forward-only"):
        grouped_matmul.grouped_matmul(x, w, widx=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="forward-only"):
        grouped_matmul.grouped_matmul(x, w, out=torch.empty(2, 4, 8))
    A, z = torch.zeros(2, 48, 8), torch.zeros(2, 48)
    wk, wv, wb = torch.randn(8, 8), torch.randn(8, 8), torch.randn(8, 1)
    with pytest.raises(ValueError, match="forward-only"):
        grouped_matmul.grouped_matmul_armt_update(x, w, x.detach(), wk, wv, wb, A, z, M=2)
    with torch.no_grad():     # without gradients the options are there
        grouped_matmul.grouped_matmul_armt_update(x, w, x, wk, wv, wb, A, z, M=2)
