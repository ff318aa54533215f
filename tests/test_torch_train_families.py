"""Training the mamba, MoE and encoder configs through the port against the
JAX reference at smoke size (fp32, CPU): ``mamba_scan``'s plain backward
against autograd through its plain version (both forms, shared and
per-group A_log, a nonzero h0, d_state 4 and 16) and the wrapper's autograd
Function; ``lm_loss`` and every parameter's gradient against
``jax.value_and_grad`` of the reference's ``lm_loss`` for falcon-mamba-7b,
jamba-1.5-large-398b, qwen2-moe-a2.7b and whisper-medium (with its
frames), on both schedules, on the kernels' autograd Functions and on the
plain path; one ``make_train_step`` step against the reference's for
qwen2-moe and whisper; and what training still refuses.

The reference's values are computed once per config, jitted, on the
sequential schedule (the same function as the diagonal one); jamba runs a
cut of its pattern to its first three positions (attn, mamba_moe, mamba:
one layer of each block type), whose reference compiles in a third of the
whole pattern's time. A leaf whose reference gradient vanishes in exact
arithmetic (an attention key bias: softmax ignores a shift of all of a
query's scores) is held to that zero against the largest gradient, not to
its own rounding noise. Inputs come from a numpy seed."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import OptimConfig as JOptimConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.train.state import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import grad as kgrad  # noqa: E402
from repro_torch.kernels import mamba_scan as kscan  # noqa: E402
from repro_torch.kernels.ref import mamba_scan_ref  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import OptimConfig, adamw_init  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.state import check_trainable  # noqa: E402
from repro_torch.utils import tree_flatten_with_path, tree_map  # noqa: E402

SCAN_TOL, LOSS_RTOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-5, 1e-4, 1e-5
ZERO = 1e-6     # a reference gradient this far below the largest one is a zero
B = 2
# arch -> (tokens per segment, segments, pattern positions kept (None: all))
ARCHS = {"falcon-mamba-7b": (16, 3, None), "jamba-1.5-large-398b": (16, 2, (0, 1, 2)),
         "qwen2-moe-a2.7b": (16, 2, None), "whisper-medium": (16, 2, None)}
STEP_ARCHS = ("qwen2-moe-a2.7b", "whisper-medium")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops (the suite runs in
    parallel workers); the count before is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# mamba_scan: the plain backward and the Function
# ---------------------------------------------------------------------------

def _scan_operands(rng, fused, shared, dS, N=4, T=9, dI=6, G=2):
    """The scan's operands from a numpy seed: a nonzero h0; A_log and D (and
    dt_bias) shared [dI, ...] or per group [G, dI, ...]; raw dt around the
    model's bias (fused) or a positive step."""
    def r(*s, sc=1.0):
        return torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))
    lead = () if shared else (G,)
    ops = {"x": r(N, T, dI), "dt": r(N, T, dI, sc=0.5) if fused else r(N, T, dI).abs() * 0.1,
           "Bt": r(N, T, dS), "Ct": r(N, T, dS),
           "A_log": torch.log(torch.from_numpy(rng.uniform(0.5, 4.0, lead + (dI, dS))
                                               .astype(np.float32))),
           "D": r(*lead, dI), "h0": r(N, dI, dS)}
    if fused:
        ops["dt_bias"] = r(*lead, dI, sc=0.5) - 1.0
        ops["z"] = r(N, T, dI)
    return ops


@pytest.mark.parametrize("dS", [4, 16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("fused", [True, False])
def test_mamba_scan_plain_backward_matches_autograd(fused, shared, dS):
    """grad.mamba_scan_bwd_plain (the backward kernel's plain version)
    against autograd through mamba_scan_ref on the same values: every
    operand's gradient within 1e-5 of its norm, given gradients of y and
    of the final state hT."""
    rng = np.random.default_rng(dS + 2 * shared + 4 * fused)
    ops = {k: v.requires_grad_() for k, v in _scan_operands(rng, fused, shared, dS).items()}
    names = list(ops)
    y, hT = mamba_scan_ref(*(ops[k] for k in names[:7]),
                           **{k: ops[k] for k in names[7:]})
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    dhT = torch.from_numpy(rng.standard_normal(hT.shape).astype(np.float32))
    want = torch.autograd.grad((y, hT), [ops[k] for k in names], (dy, dhT))
    got = kgrad.mamba_scan_bwd_plain(*(ops[k].detach() for k in names[:7]), dy, dhT,
                                     **{k: ops[k].detach() for k in names[7:]})
    got = [g for g in got if g is not None]
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert ((g - w).norm() / w.norm()).item() <= SCAN_TOL, name


@pytest.mark.parametrize("fused", [True, False])
def test_mamba_scan_goes_through_its_function_under_grad(fused):
    """On a CPU tensor under gradients mamba_scan runs MambaScanFn (its
    outputs' grad_fn), whose backward is the plain backward; without
    gradients, or with no operand requiring one, it runs the forward
    alone."""
    ops = _scan_operands(np.random.default_rng(1), fused, False, 4)
    names = list(ops)
    ops["x"].requires_grad_()
    y, hT = kscan.mamba_scan(*(ops[k] for k in names[:7]), **{k: ops[k] for k in names[7:]})
    assert type(y.grad_fn).__name__ == "MambaScanFnBackward"
    assert type(hT.grad_fn).__name__ == "MambaScanFnBackward"
    dx, = torch.autograd.grad(y.sum() + hT.sum(), ops["x"])
    want = kgrad.mamba_scan_bwd_plain(*(ops[k].detach() for k in names[:7]),
                                      torch.ones_like(y), torch.ones_like(hT),
                                      **{k: ops[k] for k in names[7:]})[0]
    assert torch.equal(dx, want)
    with torch.no_grad():
        y, _ = kscan.mamba_scan(*(ops[k] for k in names[:7]), **{k: ops[k] for k in names[7:]})
    assert y.grad_fn is None
    ops["x"] = ops["x"].detach()
    y, _ = kscan.mamba_scan(*(ops[k] for k in names[:7]), **{k: ops[k] for k in names[7:]})
    assert y.grad_fn is None


# ---------------------------------------------------------------------------
# the loss and every gradient against the reference's
# ---------------------------------------------------------------------------

def _jpaths(tree):
    """{path: leaf} of a JAX tree, paths as the port's ("pattern/0/attn/wq")."""
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return {"/".join(key(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _configs(arch):
    """(jax cfg, port cfg): the smoke config, cut to the kept positions."""
    jc, tc = j_smoke(arch), t_smoke(arch)
    keep = ARCHS[arch][2]
    if keep is not None:
        pattern = tuple(tc.block_pattern[p] for p in keep)
        kw = dict(n_layers=len(tc.prelude) + len(pattern), block_pattern=pattern)
        jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    return jc, tc


_REF = {}


def _ref(arch):
    """The reference's params (numpy), a batch (tokens, labels, frames for
    whisper), and its lm_loss value and gradients on the sequential
    schedule; for STEP_ARCHS also one make_train_step step from zero
    optimizer state, in the same jitted call."""
    if arch in _REF:
        return _REF[arch]
    jc, _ = _configs(arch)
    seg, n_seg, _ = ARCHS[arch]
    jp = jax.jit(lambda key: jmodel.init_params(jc, key))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jc.vocab, (B, seg * n_seg)).astype(np.int32),
             "labels": rng.integers(0, jc.vocab, (B, seg * n_seg)).astype(np.int32)}
    if jc.encoder is not None:
        batch["enc_frames"] = rng.standard_normal(
            (B, jc.encoder.n_frames, jc.d_model)).astype(np.float32)
    # the train step segments by the model's own length: the ARMT segment,
    # falcon's whole (short) input
    seg_len = seg if jc.armt is None else None

    def loss(p, b):
        return jmodel.lm_loss(p, jc, b["tokens"], b["labels"], schedule="sequential",
                              seg_len=seg_len, enc_frames=b.get("enc_frames"))
    out = {"params": jax.tree_util.tree_map(np.asarray, jp), "batch": batch,
           "seg_len": seg_len}
    if arch in STEP_ARCHS:
        jocfg = JOptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        step = j_make_train_step(jc, jocfg, schedule="sequential")

        def both(p, b):
            state, metrics = step({"params": p, "opt": j_adamw_init(p, jocfg)}, b)
            return jax.value_and_grad(loss)(p, b), state, metrics
        (lv, g), state, metrics = jax.jit(both)(jp, batch)
        out["step"] = (_jpaths(state), {k: float(v) for k, v in metrics.items()})
    else:
        lv, g = jax.jit(jax.value_and_grad(loss))(jp, batch)
    out["loss"], out["grads"] = float(lv), _jpaths(g)
    _REF[arch] = out
    return out


def _batch(ref, keys=("tokens", "labels", "enc_frames")):
    return {k: torch.from_numpy(ref["batch"][k]) for k in keys if k in ref["batch"]}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("schedule", ["diagonal", "sequential"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_loss_and_grads_match_reference(arch, schedule, fused):
    """lm_loss within 1e-5 and every parameter's gradient within 1e-4 of its
    norm against jax.value_and_grad of the reference's lm_loss (whisper's
    with the batch's frames: the encoder's gradients come through every
    segment's cross-attention)."""
    ref = _ref(arch)
    _, tc = _configs(arch)
    p = tree_map(lambda t: t.requires_grad_(), params_from_jax(ref["params"], "cpu"))
    b = _batch(ref)
    loss = tmodel.lm_loss(p, tc, b["tokens"], b["labels"], schedule=schedule, fused=fused,
                          seg_len=ref["seg_len"], enc_frames=b.get("enc_frames"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=LOSS_RTOL)
    got = dict(tree_flatten_with_path(p))
    want = ref["grads"]
    assert got.keys() == want.keys()
    scale = max(np.linalg.norm(w) for w in want.values())
    errs = {}
    for k, t in got.items():
        g = np.zeros_like(want[k]) if t.grad is None else t.grad.double().numpy()
        nw = np.linalg.norm(want[k])
        if nw <= ZERO * scale:     # zero in exact arithmetic: held to that zero
            assert np.linalg.norm(g) <= ZERO * scale, k
        else:
            errs[k] = np.linalg.norm(g - want[k]) / nw
    assert errs and max(errs.values()) <= GRAD_TOL, errs


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch):
    """One make_train_step step (the diagonal schedule) from zero optimizer
    state against the reference's (sequential): loss, grad_norm and lr
    within 1e-5, every param and moment within 1e-5 after the step;
    whisper's batch carries its frames. A leaf whose gradient is zero in
    exact arithmetic (whisper's key biases) takes AdamW's first step, lr g
    / (|g| + eps), on rounding noise on both sides: its params are held
    within two such steps (its moments, tiny, within 1e-5)."""
    ref = _ref(arch)
    _, tc = _configs(arch)
    ocfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = params_from_jax(ref["params"], "cpu")
    state, metrics = make_train_step(tc, ocfg, schedule="diagonal")(
        {"params": params, "opt": adamw_init(params, ocfg)}, _batch(ref))
    want_state, want_metrics = ref["step"]
    assert metrics["skipped"].item() == 0.0
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(metrics[k].item(), want_metrics[k], rtol=STEP_TOL)
    got = dict(tree_flatten_with_path(state))
    assert set(got) == set(want_state)
    scale = max(np.linalg.norm(w) for w in ref["grads"].values())
    noise = {"params/" + k for k, w in ref["grads"].items() if np.linalg.norm(w) <= ZERO * scale}
    for k, t in got.items():
        atol = 2 * ocfg.lr if k in noise else STEP_TOL
        np.testing.assert_allclose(t.double().numpy(), want_state[k], rtol=STEP_TOL,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# what training accepts and refuses
# ---------------------------------------------------------------------------

def test_check_trainable_accepts_every_family_but_einsum():
    for arch in ("falcon-mamba-7b", "jamba-1.5-large-398b", "qwen2-moe-a2.7b",
                 "kimi-k2-1t-a32b", "whisper-medium", "llama-1b-armt"):
        check_trainable(t_smoke(arch))
    cfg = t_smoke("qwen2-moe-a2.7b")
    with pytest.raises(ValueError, match="einsum"):
        check_trainable(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                         dispatch="einsum")))


def test_launches_without_a_function_refuse_under_grad():
    """A kernel wrapper with no autograd Function raises "forward-only" under
    gradients on either device (the CPU's plain version would otherwise
    differ from the card, where the ctypes launch drops the gradient):
    decode attention, and the MoE's expert layer index (a pooled step, or
    per_row dispatch at B > 1)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models.moe import moe_ffn_grouped
    q = torch.randn(2, 4, 8, requires_grad=True)
    k, v = torch.randn(2, 6, 2, 8), torch.randn(2, 6, 2, 8)
    lengths = torch.tensor([3, 6], dtype=torch.int32)
    with pytest.raises(ValueError, match="forward-only"):
        kops.decode_attention(q, k, v, lengths)
    with torch.no_grad():
        assert kops.decode_attention(q, k, v, lengths).shape == (2, 4, 8)
    cfg = t_smoke("qwen2-moe-a2.7b")
    p = tmodel.init_params(cfg, 0, device="cpu")["pattern"][0]["moe"]
    p = tree_map(lambda t: t.requires_grad_(), p)
    x = torch.randn(2, 1, 16, cfg.d_model)
    with pytest.raises(ValueError, match="forward-only"):
        moe_ffn_grouped(x, p, cfg.moe, widx=torch.tensor([0, 1], dtype=torch.int32))
    per_row = dataclasses.replace(cfg.moe, dispatch="per_row")
    with pytest.raises(ValueError, match="forward-only"):
        moe_ffn_grouped(torch.randn(2, 2, 16, cfg.d_model), p, per_row)
    assert moe_ffn_grouped(x, p, cfg.moe).grad_fn is not None


def test_train_step_leaves_no_tensor_to_the_cycle_collector():
    """A train step's tensors are freed when their last reference goes, not
    when Python's cycle collector happens to run: after a falcon step with
    the collector off (after a first step, whose imports leave cycles of
    their own), a collection finds no tensor in a reference cycle.
    (Recursive closures in the tree helpers once held each step's
    gradients and leaves so: on the card, more than the train state again
    of device memory, until a collection.)"""
    import gc
    cfg = t_smoke("falcon-mamba-7b")
    ocfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    params = tmodel.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (1, 33)))
    step = make_train_step(cfg, ocfg)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state, _ = step({"params": params, "opt": adamw_init(params, ocfg)}, batch)   # imports
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        state, _ = step(state, batch)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if was_enabled:
            gc.enable()
    assert not held, [tuple(t.shape) for t in held[:10]]
