"""ARMT memory math of the PyTorch port against the JAX reference
(repro.core.memory), fp32 on the CPU, inputs from a numpy seed."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARMTConfig as JARMT  # noqa: E402
from repro.core import memory as jmem  # noqa: E402
from repro_torch.configs import ARMTConfig  # noqa: E402
from repro_torch.core import memory as tmem  # noqa: E402

# fp32 on both sides; the reference runs matmuls at "highest" precision
# (tests/conftest.py), so only summation order differs
ATOL, RTOL = 2e-5, 1e-4


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b.detach().cpu(), np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("shape,nu", [((3, 5, 8), 3), ((2, 7), 1), ((4, 6), 2)])
def test_dpfp_matches_reference(shape, nu):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    _close(jmem.dpfp(jnp.asarray(x), nu), tmem.dpfp(torch.from_numpy(x), nu),
           atol=0, rtol=0)


def _inputs(seed, B=2, T=9, D=24, dm=8, Dv=0, M=5):
    rng = np.random.default_rng(seed)
    dv = Dv or D
    P = 6 * dm
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    params = {"wq": f(D, dm, sc=D ** -0.5), "wk": f(D, dm, sc=D ** -0.5),
              "wv": f(D, dv, sc=D ** -0.5), "wb": f(D, 1, sc=D ** -0.5)}
    state = {"A": f(B, P, dv, sc=0.1), "z": np.abs(f(B, P))}
    return params, state, f(B, T, D), f(B, M, D)


@pytest.mark.parametrize("seed,Dv", [(0, 0), (1, 40)])
def test_mem_read_and_update_match_reference(seed, Dv):
    params, state, x, m = _inputs(seed, Dv=Dv)
    jc, tc = JARMT(d_mem=8, d_val=Dv), ARMTConfig(d_mem=8, d_val=Dv)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = {k: torch.from_numpy(v) for k, v in state.items()}
    _close(jmem.mem_read(jp, js, jnp.asarray(x), jc),
           tmem.mem_read(tp, ts, torch.from_numpy(x), tc))
    ju = jmem.mem_update(jp, js, jnp.asarray(m), jc)
    tu = tmem.mem_update(tp, ts, torch.from_numpy(m), tc)
    _close(ju["A"], tu["A"])
    _close(ju["z"], tu["z"])


def test_mem_state_init_is_fp32_zero():
    st = tmem.mem_state_init(3, 16, ARMTConfig(d_mem=4), "cpu")
    assert st["A"].shape == (3, 24, 16) and st["z"].shape == (3, 24)
    assert st["A"].dtype == torch.float32 and not st["A"].any()


def test_recurrent_state_keeps_only_memory_leaves():
    z = torch.zeros(1)
    st = {"prelude": ({"A": z, "k": z},), "pattern": ({"z": z, "v": z},),
          "pos": 3}
    assert tmem.recurrent_state(st) == {"prelude": ({"A": z},),
                                        "pattern": ({"z": z},)}
