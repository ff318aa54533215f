"""How far the port's fp32 gradients sit from the JAX reference's on the CPU,
beside the reference's own rounding floor: qwen2-moe-a2.7b and
whisper-medium at smoke size, B = 2, 2 and 3 segments of 16 tokens, inputs
drawn as tests/test_torch_train_families.py draws them (params from the
reference's init at key 0, tokens, labels and frames from numpy seed 0).

For each case, the gradients' global norm (the train step's grad_norm) and
the worst leaf (relative to its own norm; the leaves that vanish in exact
arithmetic, the attention key biases, left out):

- port: the port's lm_loss (diagonal schedule on the kernels' autograd
  Functions, as make_train_step runs it) against the reference's
  (sequential, jitted): what the test holds at 1e-5 (grad_norm) and 1e-4
  (leaves);
- ref diag: the reference's diagonal schedule against its sequential one,
  a second rounding of the same maths in the reference;
- ref ulp: the reference with every parameter moved by one rounding
  (x (1 + u), u = +-2^-24 at random) against the reference: how far the
  problem itself moves a rounding of its inputs.

Where the port's gap is of the order of the reference's own, it is
rounding. A measurement run by hand beside the tests (pytest does not
collect it): it imports both packages, as only the tests may.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/ref_gap.py    # ~90 s
"""
from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.utils import tree_flatten_with_path  # noqa: E402

B, SEG, ZERO = 2, 16, 1e-6


def paths(tree):
    """{path: float64 array} of a JAX tree, paths as the port's."""
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return {"/".join(key(k) for k in path): np.asarray(leaf, np.float64)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def compare(got, want):
    """(grad_norm rel diff, worst leaf, its rel diff) of two {path: grad}."""
    def gnorm(g):
        return np.sqrt(sum(float((v * v).sum()) for v in g.values()))
    scale = max(np.linalg.norm(w) for w in want.values())
    errs = {k: np.linalg.norm(got[k] - w) / np.linalg.norm(w) for k, w in want.items()
            if np.linalg.norm(w) > ZERO * scale}
    worst = max(errs, key=errs.get)
    return abs(gnorm(got) - gnorm(want)) / gnorm(want), worst, errs[worst]


def case(arch: str, n_seg: int) -> None:
    jc, tc = j_smoke(arch), t_smoke(arch)
    jp = jax.jit(lambda key: jmodel.init_params(jc, key))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jc.vocab, (B, SEG * n_seg)).astype(np.int32),
             "labels": rng.integers(0, jc.vocab, (B, SEG * n_seg)).astype(np.int32)}
    if jc.encoder is not None:
        batch["enc_frames"] = rng.standard_normal(
            (B, jc.encoder.n_frames, jc.d_model)).astype(np.float32)

    def ref_grads(schedule, params):
        def loss(p):
            return jmodel.lm_loss(p, jc, batch["tokens"], batch["labels"], schedule=schedule,
                                  enc_frames=batch.get("enc_frames"))
        return paths(jax.jit(jax.grad(loss))(params))

    want = ref_grads("sequential", jp)
    urng = np.random.default_rng(1)
    moved = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + urng.choice([-1.0, 1.0], np.shape(a)) * 2.0 ** -24)
        .astype(np.float32), jp)
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    leaves = dict(tree_flatten_with_path(p))
    for t in leaves.values():
        t.requires_grad_()
    toks = {k: torch.from_numpy(v) for k, v in batch.items()}
    tmodel.lm_loss(p, tc, toks["tokens"], toks["labels"], schedule="diagonal",
                   enc_frames=toks.get("enc_frames")).backward()
    port = {k: (np.zeros(want[k].shape) if t.grad is None else t.grad.double().numpy())
            for k, t in leaves.items()}
    rows = {"port": compare(port, want),
            "ref diag": compare(ref_grads("diagonal", jp), want),
            "ref ulp": compare(ref_grads("sequential", moved), want)}
    print(f"{arch}, {n_seg} segments: " + "; ".join(
        f"{name}: grad_norm {g:.2e}, worst leaf {w} {e:.2e}" for name, (g, w, e) in rows.items()),
        flush=True)


def main() -> None:
    torch.set_num_threads(1)
    for arch in ("qwen2-moe-a2.7b", "whisper-medium"):
        for n_seg in (2, 3):
            case(arch, n_seg)


if __name__ == "__main__":
    main()
