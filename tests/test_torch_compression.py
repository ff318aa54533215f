"""The port's int8 error-feedback compression (``optim/compression.py``)
against the reference's: ``quantize_int8``'s int8 values and fp32 scales,
``dequantize_int8`` and ``ef_compress`` equal to the bit over the
reference test's ranges (seeds 0-20, widths 3-700, x ~ 3 N(0, 1) of the
reference's generator), the error-feedback property over steps, and
``wire_bytes_ratio`` equal. ``compressed_psum`` over four gloo ranks is
held in ``tests/test_torch_mesh_train.py`` (the module that spawns
them)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.optim import compression as jc  # noqa: E402
from repro_torch.optim import compression as tc  # noqa: E402


def _x(seed, n):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (4, n)) * 3.0)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@given(st.integers(0, 20), st.integers(3, 700))
@settings(max_examples=20, deadline=None)
def test_quantize_and_dequantize_equal_reference_to_the_bit(seed, n):
    x = _x(seed, n)
    q, s = tc.quantize_int8(torch.from_numpy(x))
    jq, js = jc.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert _same(q.numpy(), jq) and _same(s.numpy(), js)
    assert _same(tc.dequantize_int8(q, s, n).numpy(), jc.dequantize_int8(jq, js, n))


@given(st.integers(0, 20), st.integers(3, 700))
@settings(max_examples=20, deadline=None)
def test_ef_compress_equals_reference_to_the_bit(seed, n):
    g = _x(seed, n)
    err = _x(seed + 100, n) * 1e-3
    g_hat, new_err = tc.ef_compress(torch.from_numpy(g), torch.from_numpy(err))
    jg, je = jc.ef_compress(jnp.asarray(g), jnp.asarray(err))
    assert _same(g_hat.numpy(), jg) and _same(new_err.numpy(), je)


def test_error_feedback_tracks_the_true_sum():
    """The reference's property: with error feedback the mean applied
    gradient over 20 steps stays within 1 % of the true one."""
    g = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), (8, 513))))
    err, applied = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(20):
        g_hat, err = tc.ef_compress(g, err)
        applied += g_hat
    assert (applied / 20 - g).abs().max() < g.abs().max() * 0.01


@pytest.mark.parametrize("n", [2, 4, 8, 512])
def test_wire_bytes_ratio_equals_reference(n):
    assert tc.wire_bytes_ratio(n) == jc.wire_bytes_ratio(n)
    assert tc.wire_bytes_ratio(2) < 0.3


def test_compressed_psum_one_rank_axis_is_the_round_trip():
    """On a one-rank axis (no mesh) the sum is the rank's own dequantized
    block, in x's dtype."""
    x = torch.from_numpy(_x(3, 300)).to(torch.bfloat16)
    got = tc.compressed_psum(x, None, "pod")
    q, s = tc.quantize_int8(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tc.dequantize_int8(q, s, 300).to(torch.bfloat16))
