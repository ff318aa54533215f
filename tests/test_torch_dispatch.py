"""The port's kernel dispatch and autotune (``repro_torch.kernels.dispatch``,
``repro_torch.kernels.autotune``) on the CPU, beside the reference's
(``repro.kernels.dispatch``): shape buckets and cache keys equal to the
reference's on the same shapes; override before cache before heuristic;
the CPU resolving to the plain versions; a cached ``"plain"`` for the card
refused; ``kernel_dispatch_total`` moving once per key; the heuristic table
covering every op and backend; ``KernelConfig``'s JSON; an unreadable cache
loading empty; the sweep on the ``test`` backend (each candidate the plain
version under a distinct config): cold, then warm with no sweep launch;
validation falling through a wrong candidate, a raising candidate dropped,
the heuristic standing when none validates; ``MetricsRegistry.
remove_series`` against the reference's; and ``ops.decode_attention``,
``ops.assoc_read`` and ``ops.assoc_update`` (``use_kernel=False``) against
the reference's ops of the same names, fp32, each JAX reference computed
once per module. The card's side (every candidate of the card's spaces
equal to the heuristic to the bit) is in tests/test_torch_cuda.py."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve.telemetry import MetricsRegistry as JMetricsRegistry  # noqa: E402
from repro_torch.kernels import autotune, dispatch, ops  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import grouped_matmul as tgm  # noqa: E402
from repro_torch.kernels.autotune import Autotuner, config_space, run_op  # noqa: E402
from repro_torch.kernels.dispatch import KernelConfig  # noqa: E402
from repro_torch.serve.telemetry import MetricsRegistry, default_registry  # noqa: E402

CUDA = torch.device("cuda")      # a device object only: nothing here runs on a card


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops: the suite runs in
    parallel workers, and an oversubscribed pool makes thousands of small
    ops many times slower on a busy machine. The count before is restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cache(tmp_path):
    """The dispatch cache pointed at a fresh file; the default after."""
    path = str(tmp_path / "kernel_cache.json")
    dispatch.set_cache_path(path)
    yield path
    dispatch.set_cache_path(None)


def _f(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _tiny_args(op, seed=0):
    """Small operands per op, in the kernel wrappers' layouts."""
    rng = np.random.default_rng(seed)
    if op == "grouped_matmul":
        return (_f(rng, 2, 16, 12), _f(rng, 2, 12, 20)), {}
    if op == "grouped_matmul_armt_update":
        G, R, K, D, dm, M = 2, 12, 8, 16, 4, 2
        return (_f(rng, G, R, K, scale=0.3), _f(rng, G, K, D, scale=0.3),
                _f(rng, G, R, D, scale=0.3), _f(rng, G, D, dm, scale=0.3),
                _f(rng, G, D, D, scale=0.3), _f(rng, G, D, 1, scale=0.3),
                _f(rng, G, 6 * dm, D, scale=0.1),
                torch.from_numpy(rng.uniform(size=(G, 6 * dm)).astype(np.float32))), {"M": M}
    if op == "flash_attention":
        return (_f(rng, 2, 4, 16, 8), _f(rng, 2, 2, 16, 8), _f(rng, 2, 2, 16, 8)), {}
    if op == "decode_attention":
        return (_f(rng, 2, 4, 8), _f(rng, 2, 16, 2, 8), _f(rng, 2, 16, 2, 8),
                torch.tensor([3, 16], dtype=torch.int32)), {"window": 0}
    if op == "armt_read":
        dm = 4
        return (_f(rng, 2, 8, 12), _f(rng, 12, dm, scale=0.3), _f(rng, 2, 6 * dm, 16, scale=0.1),
                torch.from_numpy(rng.uniform(size=(2, 6 * dm)).astype(np.float32))), {}
    if op == "armt_update":
        dm = 4
        return (_f(rng, 2, 2, 12), _f(rng, 12, dm, scale=0.3), _f(rng, 12, 16, scale=0.3),
                _f(rng, 12, 1, scale=0.3), _f(rng, 2, 6 * dm, 16, scale=0.1),
                torch.from_numpy(rng.uniform(size=(2, 6 * dm)).astype(np.float32))), {}
    if op == "mamba_scan":
        x = _f(rng, 1, 8, 8, scale=0.5)
        dt = torch.nn.functional.softplus(_f(rng, 1, 8, 8))
        A_log = torch.log(torch.arange(1.0, 5.0)).repeat(8, 1)
        return (x, dt, _f(rng, 1, 8, 4, scale=0.5), _f(rng, 1, 8, 4, scale=0.5), A_log,
                torch.ones(8), _f(rng, 1, 8, 4, scale=0.1)), {}
    raise ValueError(op)


def _counters(reg, name):
    return {k: v for k, v in reg.counters.items() if k.startswith(name + "{")}


# ---------------------------------------------------------------- keys

@pytest.mark.parametrize("op,shapes", [
    ("grouped_matmul", ((2, 60, 33), (2, 33, 100))),
    ("grouped_matmul", ((16, 1152, 2048), (16, 2048, 8192))),
    ("grouped_matmul_armt_update", ((16, 1152, 8192), (16, 8192, 2048), (16, 384, 2048))),
    ("flash_attention", ((16, 32, 1152, 64), (16, 8, 1152, 64))),
    ("decode_attention", ((4, 32, 64), (4, 1152, 8, 64))),
    ("armt_read", ((1, 1, 1), (3, 0, 5))),
    ("mamba_scan", ((16, 1024, 8192), (16, 1024, 16))),
])
def test_shape_bucket_and_cache_key_match_the_reference(op, shapes):
    assert dispatch.shape_bucket(shapes) == jdispatch.shape_bucket(shapes)
    for bk in ("cpu", "cuda"):
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            got = dispatch.cache_key(bk, op, shapes, tdt)
            assert got == jdispatch.cache_key(bk, op, shapes, jdt)
            assert got == dispatch.cache_key(bk, op, shapes, np.dtype(jdt).name)


def test_bucketing_crosses_at_powers_of_two():
    k = dispatch.cache_key("cpu", "grouped_matmul", ((2, 64, 64), (2, 64, 128)), torch.float32)
    assert dispatch.cache_key("cpu", "grouped_matmul", ((2, 60, 33), (2, 33, 100)),
                              torch.float32) == k
    assert dispatch.cache_key("cpu", "grouped_matmul", ((2, 65, 64), (2, 64, 128)),
                              torch.float32) != k
    assert dispatch.cache_key("cuda", "grouped_matmul", ((2, 64, 64), (2, 64, 128)),
                              torch.bfloat16) == "cuda/grouped_matmul/2_64_64x2_64_128/bfloat16"


# ---------------------------------------------------------------- resolution

def test_the_cpu_resolves_to_the_plain_versions(cache):
    for op in dispatch.OPS:
        assert dispatch.resolve(op, ((2, 3, 4), (2, 4, 5)), torch.float32,
                                device="cpu") == dispatch.PLAIN
    # and the wrappers run them on CPU tensors with no launch; asking for
    # the kernel on a CPU tensor raises
    (x, w), _ = _tiny_args("grouped_matmul")
    before = tgm.launches
    torch.testing.assert_close(ops.grouped_gemm(x, w), tgm.grouped_matmul_plain(x, w),
                               rtol=0, atol=0)
    assert tgm.launches == before
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ops.grouped_gemm(x, w, use_kernel=True)
    args, kw = _tiny_args("decode_attention")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ops.decode_attention(*args, config=dispatch.CUDA, **kw)


def test_override_beats_cache_beats_heuristic(cache):
    shapes = ((2, 16, 12), (2, 12, 20))
    op = "grouped_matmul"
    assert dispatch.resolve(op, shapes, torch.float32, device="cpu") == dispatch.PLAIN
    assert dispatch.resolve(op, shapes, torch.bfloat16, device=CUDA) == dispatch.CUDA
    tuned_cpu = KernelConfig(impl="plain", block_n=256)
    tuned_card = KernelConfig(impl="cuda", block_n=128)
    dispatch.store_config(dispatch.cache_key("cpu", op, shapes, torch.float32), tuned_cpu)
    dispatch.store_config(dispatch.cache_key("cuda", op, shapes, torch.bfloat16), tuned_card)
    # the cache beats the heuristic, for any shape of the bucket
    assert dispatch.resolve(op, shapes, torch.float32, device="cpu") == tuned_cpu
    assert dispatch.resolve(op, ((2, 9, 12), (2, 12, 17)), torch.float32,
                            device="cpu") == tuned_cpu
    assert dispatch.resolve(op, shapes, torch.bfloat16, device=CUDA) == tuned_card
    # the override beats the cache
    assert dispatch.resolve(op, shapes, torch.bfloat16, device=CUDA,
                            use_kernel=False) == dispatch.PLAIN
    assert dispatch.resolve(op, shapes, torch.float32, device="cpu",
                            use_kernel=True) == dispatch.CUDA
    # another dtype, another key: the heuristic
    assert dispatch.resolve(op, shapes, torch.float32, device=CUDA) == dispatch.CUDA
    # the file holds both, and a reload serves them
    dispatch.set_cache_path(cache)
    assert dispatch.resolve(op, shapes, torch.bfloat16, device=CUDA) == tuned_card


def test_a_plain_cache_entry_for_the_card_is_refused(cache):
    shapes = ((4, 32, 64), (4, 1152, 8, 64))
    key = dispatch.cache_key("cuda", "decode_attention", shapes, torch.bfloat16)
    with open(cache, "w") as f:
        json.dump({"configs": {key: {"impl": "plain"}}}, f)
    dispatch.set_cache_path(cache)
    with pytest.raises(ValueError, match="runs only 'cuda'"):
        dispatch.resolve("decode_attention", shapes, torch.bfloat16, device=CUDA)
    # the tuner's warm path refuses it too
    q = torch.zeros(4, 32, 64, dtype=torch.bfloat16)
    kv = torch.zeros(4, 1152, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="runs only 'cuda'"):
        Autotuner(persist=False, registry=MetricsRegistry()).get_or_tune(
            "decode_attention", (q, kv, kv, torch.ones(4, dtype=torch.int32)), backend="cuda")
    with pytest.raises(ValueError, match="runs only 'cuda'"):
        dispatch.store_config(key, dispatch.PLAIN)
    # nor does the CPU take a kernel from the cache
    cpu_key = dispatch.cache_key("cpu", "decode_attention", shapes, torch.float32)
    with pytest.raises(ValueError, match="runs only 'plain'"):
        dispatch.store_config(cpu_key, dispatch.CUDA)


def test_a_cached_block_that_does_not_fit_the_call_is_refused(cache):
    """decode's heads a block tuned at 4 q heads a kv head (32 / 8, hd 128)
    is refused for a call with 3 (24 / 8) in the same bucket, by resolve,
    the tuner's warm path and the wrapper; the shape it was tuned at, and
    an explicit config that fits, still resolve."""
    rep4 = ((4, 32, 128), (4, 1152, 8, 128))
    rep3 = ((4, 24, 128), (4, 1152, 8, 128))
    key = dispatch.cache_key("cuda", "decode_attention", rep4, torch.bfloat16)
    assert dispatch.cache_key("cuda", "decode_attention", rep3, torch.bfloat16) == key
    tuned = KernelConfig(impl="cuda", block_h=4)
    dispatch.store_config(key, tuned)
    assert dispatch.resolve("decode_attention", rep4, torch.bfloat16, device=CUDA) == tuned
    with pytest.raises(ValueError, match="block_h 4 does not fit decode_attention"):
        dispatch.resolve("decode_attention", rep3, torch.bfloat16, device=CUDA)
    # every call of the shape raises again: nothing was memoised for it
    with pytest.raises(ValueError, match="1 <= block_h <= 3"):
        dispatch.resolve("decode_attention", rep3, torch.bfloat16, device=CUDA)
    q = torch.zeros(*rep3[0], dtype=torch.bfloat16)
    kv = torch.zeros(*rep3[1], dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit"):
        Autotuner(persist=False, registry=MetricsRegistry()).get_or_tune(
            "decode_attention", (q, kv, kv, torch.ones(4, dtype=torch.int32)), backend="cuda")
    # an explicit config is held to the call's shape too
    args, kw = _tiny_args("decode_attention")            # 2 q heads a kv head
    with pytest.raises(ValueError, match="block_h 4 does not fit"):
        ops.decode_attention(*args, config=KernelConfig(impl="plain", block_h=4), **kw)
    torch.testing.assert_close(
        ops.decode_attention(*args, config=KernelConfig(impl="plain", block_h=2), **kw),
        ops.decode_attention(*args, use_kernel=False, **kw), rtol=0, atol=0)


@pytest.mark.parametrize("rule_n,stored_n", [(256, 0), (128, 256)])
def test_a_winner_is_stored_relative_to_the_kernel_rule(cache, monkeypatch, rule_n, stored_n):
    """The winner (block_n 256, the faster in space order) is stored as 0
    where the kernel's own rule picks it at the tuned shape, so the other
    shapes of the bucket run their own rule; where it beat the rule its
    value is stored. ``results`` keeps the winner as swept."""
    args, kw = _tiny_args("grouped_matmul")
    monkeypatch.setattr(Autotuner, "sweep", lambda self, op_, a, **k: [
        (c, float(i)) for i, c in enumerate(reversed(config_space(op_, "test")))])
    monkeypatch.setattr(dispatch, "rule_config",
                        lambda op, shapes, bk="cuda": KernelConfig(impl="plain", block_n=rule_n))
    tuner = Autotuner(cache, registry=MetricsRegistry())
    got = tuner.get_or_tune("grouped_matmul", args, backend="test", op_kwargs=kw)
    key = tuner.key_for("grouped_matmul", args, "test")
    assert got == KernelConfig(impl="plain", block_n=stored_n) == dispatch.cached_config(key)
    assert tuner.results[key]["winner"] == KernelConfig(impl="plain", block_n=256)
    assert dispatch.rule_relative(KernelConfig(impl="cuda", block_n=256, block_h=2),
                                  KernelConfig(impl="cuda", block_n=256, block_h=4)) \
        == KernelConfig(impl="cuda", block_h=2)


def test_the_dispatch_counter_moves_once_per_key(cache):
    reg = default_registry()
    reg.remove_series("kernel_dispatch_total")
    heur = "kernel_dispatch_total{backend=cpu,impl=plain,op=armt_read,source=heuristic}"
    for shapes in (((2, 8, 12), (2, 24, 16)), ((2, 8, 12), (2, 24, 16)),
                   ((2, 7, 9), (2, 20, 13))):          # the same bucket
        dispatch.resolve("armt_read", shapes, torch.float32, device="cpu")
    assert _counters(reg, "kernel_dispatch_total") == {heur: 1}
    dispatch.resolve("armt_read", ((2, 9, 12), (2, 24, 16)), torch.float32, device="cpu")
    assert reg.counters[heur] == 2                     # a new bucket
    dispatch.resolve("armt_read", ((2, 8, 12), (2, 24, 16)), torch.float32, device="cpu",
                     use_kernel=False)
    over = "kernel_dispatch_total{backend=cpu,impl=plain,op=armt_read,source=override}"
    assert reg.counters[over] == 1
    # a wrapper call resolves through the same memo: counted once
    args, kw = _tiny_args("armt_read")
    for _ in range(3):
        ops.assoc_read(*args, **kw)
    assert reg.counters[heur] == 2
    # a reset of the registry counts afresh
    reg.remove_series("kernel_dispatch_total")
    dispatch.set_cache_path(cache)
    ops.assoc_read(*args, **kw)
    assert _counters(reg, "kernel_dispatch_total") == {heur: 1}


def test_the_heuristic_table_covers_every_op_and_backend():
    assert set(dispatch.HEURISTICS) == {(b, op) for b in dispatch.BACKENDS
                                        for op in dispatch.OPS}
    for bk in dispatch.BACKENDS:
        for op in dispatch.OPS:
            cfg = dispatch.heuristic(op, bk)
            # the card: each kernel's own rule, every block 0
            assert cfg == (dispatch.CUDA if bk == "cuda" else dispatch.PLAIN)
            assert cfg.blocks("block_n", "block_i", "block_h") == {}
    assert dispatch.OPS == jdispatch.OPS


def test_kernel_config_json_round_trips_and_ignores_unknown_fields():
    cfg = KernelConfig(impl="cuda", block_n=256, block_i=64, block_h=2)
    assert KernelConfig.from_json(json.loads(json.dumps(cfg.to_json()))) == cfg
    assert cfg.blocks("block_n", "block_h", "block_i") == {"block_n": 256, "block_h": 2,
                                                           "block_i": 64}
    # a reference-style entry: unknown knobs ignored
    got = KernelConfig.from_json({"impl": "cuda", "block_n": 128, "block_m": 64,
                                  "interpret": True, "fast_softmax": True})
    assert got == KernelConfig(impl="cuda", block_n=128)
    with pytest.raises(ValueError):
        KernelConfig(impl="xla")
    with pytest.raises(ValueError):
        KernelConfig(impl="cuda", block_n=-1)


@pytest.mark.parametrize("content", ["{not json", json.dumps({"configs": {
    "cpu/armt_read/2_8_16x2_32_16/float32": {"impl": "xla"}}}), json.dumps([1, 2])])
def test_an_unreadable_cache_loads_as_empty(cache, content):
    with open(cache, "w") as f:
        f.write(content)
    dispatch.set_cache_path(cache)
    assert dispatch.cached_config("cpu/armt_read/2_8_16x2_32_16/float32") is None
    assert dispatch.resolve("armt_read", ((2, 8, 12), (2, 24, 16)), torch.float32,
                            device="cpu") == dispatch.PLAIN


# ---------------------------------------------------------------- autotuner

def test_config_spaces_hold_what_the_kernels_compile():
    for op in dispatch.OPS:
        assert config_space(op, "cpu") == [dispatch.PLAIN]
        card = config_space(op, "cuda")
        assert card and all(c.impl == "cuda" for c in card)     # no plain on the card
        assert [c.blocks("block_n", "block_i", "block_h") for c in config_space(op, "test")] \
            == [c.blocks("block_n", "block_i", "block_h") for c in card]
    for op in ("grouped_matmul", "grouped_matmul_armt_update", "armt_read"):
        assert [c.block_n for c in config_space(op, "cuda")] == [128, 256]
    assert [c.block_i for c in config_space("mamba_scan", "cuda")] == [64, 256]
    assert config_space("flash_attention", "cuda") == [dispatch.CUDA]
    assert config_space("armt_update", "cuda") == [dispatch.CUDA]
    # decode: the heads a block that divide the rep, at most 1,024 outputs
    llama = config_space("decode_attention", "cuda", ((4, 32, 64), (4, 1152, 8, 64)))
    assert [c.block_h for c in llama] == [1, 2, 4]
    chatglm = config_space("decode_attention", "cuda", ((4, 32, 128), (4, 1152, 2, 128)))
    assert [c.block_h for c in chatglm] == [1, 2, 4, 8]
    assert tda.head_groups(16, 128)[0] in [c.block_h for c in chatglm]


@pytest.mark.parametrize("op", dispatch.OPS)
def test_a_cold_sweep_then_a_warm_cache_with_no_sweep_launch(cache, op):
    """The reference's acceptance invariant, on the test backend: the first
    tuner sweeps, validates and persists; a second (fresh registry,
    reloaded file) serves the same winner with zero sweep launches."""
    args, kw = _tiny_args(op)
    reg1 = MetricsRegistry()
    winner = Autotuner(cache, registry=reg1).get_or_tune(op, args, backend="test", repeats=1,
                                                         op_kwargs=kw)
    n_cands = len(config_space(op, "test", autotune.key_shapes(op, args)))
    assert sum(_counters(reg1, "autotune_sweep_total").values()) == n_cands
    assert reg1.counters[f"autotune_validate_total{{op={op},result=pass}}"] == 1
    assert winner in config_space(op, "test", autotune.key_shapes(op, args))
    dispatch.set_cache_path(cache)                 # the in-memory table dropped
    reg2 = MetricsRegistry()
    again = Autotuner(cache, registry=reg2).get_or_tune(op, args, backend="test", repeats=1,
                                                        op_kwargs=kw)
    assert again == winner
    assert _counters(reg2, "autotune_sweep_total") == {}
    assert reg2.counters[f"autotune_cache_hit_total{{op={op}}}"] == 1


def test_the_dispatch_serves_a_tuned_winner_from_the_cache(cache):
    args, kw = _tiny_args("armt_update")
    winner = Autotuner(cache, registry=MetricsRegistry()).get_or_tune(
        "armt_update", args, repeats=1, op_kwargs=kw)          # the CPU's own backend
    assert winner == dispatch.PLAIN
    reg = default_registry()
    reg.remove_series("kernel_dispatch_total")
    dispatch.set_cache_path(cache)
    shapes = (args[0].shape, args[4].shape)
    assert dispatch.resolve("armt_update", shapes, torch.float32, device="cpu") == winner
    assert _counters(reg, "kernel_dispatch_total") == {
        "kernel_dispatch_total{backend=cpu,impl=plain,op=armt_update,source=cache}": 1}


def _ranked_runner(monkeypatch, op, wrong=(), raises=()):
    """The test backend's candidates ranked in space order, and a runner
    whose output is wrong (x1.5) for the configs in ``wrong`` and raises for
    those in ``raises``."""
    real = autotune._RUNNERS[op]

    def runner(a, c, **kw):
        if c in raises:
            raise RuntimeError("candidate refused")
        out = real(a, c, **kw)
        return tuple(o * 1.5 for o in out) if c in wrong and isinstance(out, tuple) else \
            (out * 1.5 if c in wrong else out)
    monkeypatch.setitem(autotune._RUNNERS, op, runner)
    monkeypatch.setattr(Autotuner, "sweep", lambda self, op_, args, **k: [
        (c, float(i)) for i, c in enumerate(config_space(op_, "test",
                                                          autotune.key_shapes(op_, args)))
        if c not in raises])


def test_validation_rejects_a_wrong_result_and_falls_through(cache, monkeypatch):
    args, kw = _tiny_args("grouped_matmul")
    first, second = config_space("grouped_matmul", "test")
    _ranked_runner(monkeypatch, "grouped_matmul", wrong=(first,))
    reg = MetricsRegistry()
    tuner = Autotuner(cache, registry=reg)
    assert not tuner.validate("grouped_matmul", args, first, backend="test")
    got = tuner.get_or_tune("grouped_matmul", args, backend="test", op_kwargs=kw)
    assert got == second
    assert reg.counters["autotune_validate_total{op=grouped_matmul,result=fail}"] == 2
    assert reg.counters["autotune_validate_total{op=grouped_matmul,result=pass}"] == 1
    assert dispatch.cached_config(tuner.key_for("grouped_matmul", args, "test")) == second
    assert tuner.results[tuner.key_for("grouped_matmul", args, "test")]["rejected"] == [first]


def test_a_wrong_reference_fails_validation(cache, monkeypatch):
    """As the reference's test: the plain version moved, nothing validates."""
    args, _ = _tiny_args("grouped_matmul")
    monkeypatch.setitem(autotune._REFS, "grouped_matmul",
                        lambda x, w, b=None, **_: torch.matmul(x, w) * 1.5)
    reg = MetricsRegistry()
    assert not Autotuner(cache, registry=reg).validate("grouped_matmul", args, dispatch.PLAIN)
    assert reg.counters["autotune_validate_total{op=grouped_matmul,result=fail}"] == 1


def test_a_candidate_that_raises_is_dropped(cache, monkeypatch):
    args, kw = _tiny_args("mamba_scan")
    first, second = config_space("mamba_scan", "test")
    real = autotune._RUNNERS["mamba_scan"]

    def runner(a, c, **k):
        if c == first:
            raise RuntimeError("candidate refused")
        return real(a, c, **k)
    monkeypatch.setitem(autotune._RUNNERS, "mamba_scan", runner)
    tuner = Autotuner(cache, registry=MetricsRegistry())
    ranked = tuner.sweep("mamba_scan", args, backend="test", repeats=2, op_kwargs=kw)
    assert [c for c, _ in ranked] == [second] and ranked[0][1] >= 0
    assert tuner.get_or_tune("mamba_scan", args, backend="test", repeats=1) == second
    assert tuner.results[tuner.key_for("mamba_scan", args, "test")]["dropped"] == [first]


def test_the_heuristic_stands_when_no_candidate_validates(cache, monkeypatch):
    args, kw = _tiny_args("decode_attention")
    space = config_space("decode_attention", "test", autotune.key_shapes("decode_attention",
                                                                           args))
    _ranked_runner(monkeypatch, "decode_attention", wrong=tuple(space))
    reg = MetricsRegistry()
    tuner = Autotuner(cache, registry=reg)
    got = tuner.get_or_tune("decode_attention", args, backend="test", op_kwargs=kw)
    assert got == dispatch.heuristic("decode_attention", "test")
    assert reg.counters["autotune_validate_total{op=decode_attention,result=fail}"] == len(space)
    assert dispatch.cached_config(tuner.key_for("decode_attention", args, "test")) is None


# ---------------------------------------------------------------- registry

def test_remove_series_matches_the_reference():
    regs = (MetricsRegistry(), JMetricsRegistry())
    for reg in regs:
        reg.inc("kernel_dispatch_total", op="a", impl="x", backend="cpu", source="cache")
        reg.inc("kernel_dispatch_total", op="b", impl="x", backend="cpu", source="heuristic")
        reg.inc("kernel_dispatch_total")
        reg.inc("kernel_dispatch_totals", op="a")        # another name with the prefix
        reg.set_gauge("kernel_dispatch_total", 3.0, op="a")
        reg.observe("kernel_dispatch_total", 1.0)
        reg.observe("other", 2.0, op="a")
        reg.remove_series("kernel_dispatch_total")
    mine, theirs = (reg.snapshot() for reg in regs)
    assert mine["counters"] == theirs["counters"] == {"kernel_dispatch_totals{op=a}": 1}
    assert mine["gauges"] == theirs["gauges"] == {}
    assert set(mine["histograms"]) == set(theirs["histograms"]) == {"other{op=a}"}


# ---------------------------------------------------------------- ops vs the reference

@pytest.fixture(scope="module")
def reference_ops():
    """The three ops' operands (numpy, fp32) and the reference's outputs of
    them, computed once."""
    rng = np.random.default_rng(7)

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    dm, Dv = 4, 16
    P = 6 * dm
    a = dict(q=f(3, 8, 16), k=f(3, 40, 2, 16), v=f(3, 40, 2, 16),
             lengths=np.asarray([40, 17, 1], np.int32), x=f(6, 9, 24),
             wq=f(2, 24, dm, scale=0.3), m=f(6, 3, 24), wk=f(2, 24, dm, scale=0.3),
             wv=f(2, 24, Dv, scale=0.3), wb=f(2, 24, 1, scale=0.3), A=f(6, P, Dv, scale=0.1),
             z=rng.uniform(size=(6, P)).astype(np.float32))
    j = {n: jnp.asarray(v) for n, v in a.items()}
    want = {"decode": np.asarray(jops.decode_attention(j["q"], j["k"], j["v"], j["lengths"],
                                                       window=5, use_kernel=False)),
            "read": np.asarray(jops.assoc_read(j["x"], j["wq"], j["A"], j["z"],
                                               use_kernel=False)),
            "update": tuple(np.asarray(o) for o in jops.assoc_update(
                j["m"], j["wk"], j["wv"], j["wb"], j["A"], j["z"], use_kernel=False))}
    return a, want


@pytest.mark.parametrize("name", ["decode", "read", "update"])
def test_ops_wrappers_match_the_reference_ops(reference_ops, name):
    a, want = reference_ops
    t = {n: torch.from_numpy(v) for n, v in a.items()}
    if name == "decode":
        got = ops.decode_attention(t["q"], t["k"], t["v"], t["lengths"], window=5,
                                   use_kernel=False)
    elif name == "read":
        got = ops.assoc_read(t["x"], t["wq"], t["A"], t["z"], use_kernel=False)
    else:
        got = ops.assoc_update(t["m"], t["wk"], t["wv"], t["wb"], t["A"], t["z"],
                               use_kernel=False)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want[name] if isinstance(want[name], tuple) else (want[name],)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


def test_run_op_with_a_config_equals_the_resolved_call_on_the_cpu(cache):
    for op in dispatch.OPS:
        args, kw = _tiny_args(op)
        assert autotune.same_bits(run_op(op, args, None, **kw),
                                  run_op(op, args, dispatch.PLAIN, **kw))


def test_tune_kernels_lists_every_op_of_the_path(cache):
    """tools/tune_kernels.py's path_cases (the shapes phase (y) of
    chip_smoke.py tunes at) at smoke width on the CPU: llama's cell and
    decode reach every op but the scan, falcon's only the scan, each case
    runs through the tuner on the test backend; an unlisted family is
    refused."""
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import get_smoke_config
    path = Path(__file__).resolve().parents[1] / "tools" / "tune_kernels.py"
    spec = importlib.util.spec_from_file_location("tune_kernels", path)
    tk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tk)
    cpu = torch.device("cpu")
    tuner = Autotuner(cache, registry=MetricsRegistry())
    seen = {}
    for arch in ("llama-1b-armt", "falcon-mamba-7b"):
        for op, label, args, kw in tk.path_cases(get_smoke_config(arch), cpu, G=2):
            seen.setdefault(arch, set()).add(op)
            got = tuner.get_or_tune(op, args, backend="test", repeats=1, op_kwargs=kw)
            assert got in config_space(op, "test", autotune.key_shapes(op, args)), (op, label)
    assert seen == {"llama-1b-armt": set(dispatch.OPS) - {"mamba_scan"},
                    "falcon-mamba-7b": {"mamba_scan"}}
    with pytest.raises(ValueError, match="listed"):
        next(tk.path_cases(get_smoke_config("jamba-1.5-large-398b"), cpu))
