"""The port's helpers against the JAX reference: the parameter counts and
the useful-FLOPs count for every arch x every shape at full size (both
sides without allocation: ``jax.eval_shape`` there, the meta device
here); the shape trees of the parameters, the train state and the decode
state leaf for leaf; the schedule functions over a grid of (S, L) with
corrupted schedules, and the schedules the executors actually ran held
to Lemma 3.1; the utilities on the same values and trees; the shape
registry and the arch list."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import utils as jutils  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import OptimConfig as JOptimConfig  # noqa: E402
from repro.roofline import model_math as jmath  # noqa: E402
from repro.train.state import train_state_specs as j_train_state_specs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import utils as tutils  # noqa: E402
from repro_torch.core import diagonal as diag  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core.schedule import StackLayout  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.blocks import make_apply_block  # noqa: E402
from repro_torch.models.grouped_blocks import make_grouped_apply  # noqa: E402
from repro_torch.optim import OptimConfig  # noqa: E402
from repro_torch.roofline import model_math as tmath  # noqa: E402
from repro_torch.serve import state_store  # noqa: E402
from repro_torch.train import train_state_specs  # noqa: E402

SPEC_ARCHS = ["llama-1b-armt", "qwen2-moe-a2.7b", "jamba-1.5-large-398b",
              "falcon-mamba-7b", "whisper-medium"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32,
          "int64": torch.int64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops (the suite runs in
    parallel workers); the count before is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Configs, counts and FLOPs
# ---------------------------------------------------------------------------

def test_shapes_assigned_archs_and_list_archs_match_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert len(tconfigs.list_archs()) == 14
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, s in tconfigs.SHAPES.items():
        j = jconfigs.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)
    for arch in tconfigs.ASSIGNED_ARCHS:
        tconfigs.get_config(arch)        # every assigned arch resolves in the port


@pytest.fixture(scope="module")
def ref_counts():
    """{arch: (param_counts, {shape: model_flops}, embedding_params)} of the
    reference, each arch's parameter tree traced once (model_flops calls
    param_counts per shape: its param_specs is cached here)."""
    cached = functools.lru_cache(maxsize=None)(jmath.param_specs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmath, "param_specs", lambda cfg, dtype=None: cached(cfg, dtype))
        out = {}
        for arch in jconfigs.list_archs():
            cfg = jconfigs.get_config(arch)
            out[arch] = (jmath.param_counts(cfg),
                         {s: jmath.model_flops(cfg, shape)
                          for s, shape in jconfigs.SHAPES.items()},
                         jmath.embedding_params(cfg))
    return out


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_param_counts_and_model_flops_match_reference(arch, ref_counts):
    cfg = tconfigs.get_config(arch)
    counts, flops, emb = ref_counts[arch]
    assert tmath.param_counts(cfg) == counts
    assert tmath.embedding_params(cfg) == emb
    for s, shape in tconfigs.SHAPES.items():
        assert tmath.model_flops(cfg, shape) == flops[s], s
    if cfg.moe is not None:          # the routed-expert rule found the experts
        assert counts[1] < counts[0]


def test_param_specs_allocate_nothing():
    """kimi-k2's 1 T and jamba's 398 B parameters as meta tensors."""
    for arch in ("kimi-k2-1t-a32b", "jamba-1.5-large-398b"):
        specs = tmodel.param_specs(tconfigs.get_config(arch))
        leaves = tutils.tree_leaves(specs)
        assert all(t.device.type == "meta" for t in leaves)
        assert tutils.tree_params(specs) > 3e11
    bf = tmodel.param_specs(tconfigs.get_config("falcon-mamba-7b"), dtype=torch.float32)
    assert bf["embed"].dtype == torch.float32 and bf["pattern"][0]["mixer"]["A_log"].dtype \
        == torch.float32


# ---------------------------------------------------------------------------
# Shape trees, leaf for leaf
# ---------------------------------------------------------------------------

def _jspec(tree):
    """{path: (shape, dtype name)} of a reference shape tree."""
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return {"/".join(key(k) for k in path): (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tspec(tree):
    """{path: (shape, dtype name)} of a port tree; a host-int leaf (the
    scalar ``pos``) as a 0-d int."""
    out = {}
    for path, leaf in tutils.tree_flatten_with_path(tree):
        if isinstance(leaf, int):
            out[path] = ((), "int")
        else:
            assert leaf.device.type == "meta", path
            name = {v: k for k, v in DTYPES.items()}[leaf.dtype]
            out[path] = (tuple(leaf.shape), name)
    return out


def _same_tree(mine, ref, pos_ok=None):
    assert mine.keys() == ref.keys()
    for k in ref:
        if k == "pos" and pos_ok is not None:
            assert pos_ok(mine[k], ref[k]), (mine[k], ref[k])
        else:
            assert mine[k] == ref[k], k


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_and_train_state_specs_match_reference(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    _same_tree(_tspec(tmodel.param_specs(tc)), _jspec(jmodel.param_specs(jc)))
    _same_tree(_tspec(tmodel.param_specs(tc, dtype=torch.float32)),
               _jspec(jmodel.param_specs(jc, jnp.float32)))
    _same_tree(_tspec(train_state_specs(tc, OptimConfig())),
               _jspec(j_train_state_specs(jc, JOptimConfig())))


def _pos_departure(mine, ref):
    """The port's ``pos``: a host int where the reference has an int32
    scalar, int64 where it has int32 [B] per slot."""
    if ref == ((), "int32"):
        return mine == ((), "int")
    return mine == (ref[0], "int64") and ref[1] == "int32"


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_decode_state_shapes_match_reference(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for serve_mode in ("armt", "cache"):
        if serve_mode == "armt" and not tc.is_recurrent:
            continue
        for per_slot in (False, True):
            for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
                ref = jmodel.decode_state_shapes(jc, 3, serve_mode=serve_mode, max_len=2048,
                                                 dtype=jdt, per_slot_pos=per_slot)
                mine = tmodel.decode_state_shapes(tc, 3, serve_mode=serve_mode, max_len=2048,
                                                  dtype=tdt, per_slot_pos=per_slot)
                _same_tree(_tspec(mine), _jspec(ref), pos_ok=_pos_departure)


# ---------------------------------------------------------------------------
# The schedule functions, and the schedules the executors ran
# ---------------------------------------------------------------------------

GRID = [(1, 1), (1, 4), (4, 1), (3, 3), (5, 2), (2, 7), (6, 4)]


def _raises(fn, *args):
    """The exception message fn raises, or None."""
    try:
        fn(*args)
    except (AssertionError, ValueError, KeyError) as e:
        return f"{type(e).__name__ if isinstance(e, KeyError) else ''}{e}"
    return None


def _corruptions(S, L):
    """A list of (name, schedule) damaged from the diagonal one."""
    g = tsched.diagonal_groups(S, L)
    out = [("diagonal", g),
           ("sequential", [[(s, l)] for s in range(S) for l in range(L)]),
           ("layer-major", [[(s, l)] for l in range(L) for s in range(S)]),
           ("padded", g + [[]]),
           ("empty front", [[]] + g)]
    out.append(("twice", [grp + ([grp[0]] if i == len(g) - 1 else [])
                          for i, grp in enumerate(g)]))
    out.append(("missing", [grp[1:] if i == len(g) - 1 else grp
                            for i, grp in enumerate(g)]))
    if S * L > 1:
        # a dependency broken: the last cell moved to the front
        last = g[-1][-1]
        out.append(("broken", [[last]] + [[c for c in grp if c != last] for grp in g]))
        # two groups merged: still valid only where no dependency crosses them
        out.append(("merged", [g[0] + g[1]] + g[2:]))
        out.append(("reversed", list(reversed(g))))
    if S > 1:
        out.append(("out of grid", [[c if c != (0, 0) else (S, 0) for c in grp]
                                    for grp in g]))
    return out


@pytest.mark.parametrize("S,L", GRID)
def test_schedule_checks_match_reference(S, L):
    for s in range(S + 1):
        for l in range(L + 1):
            assert tsched.cell_dependencies(s, l) == jsched.cell_dependencies(s, l)
    assert tsched.diagonal_groups(S, L) == jsched.diagonal_groups(S, L)
    for name, groups in _corruptions(S, L):
        mine = _raises(tsched.validate_schedule, groups, S, L)
        ref = _raises(jsched.validate_schedule, groups, S, L)
        assert mine == ref, (name, mine, ref)
        assert tsched.is_minimal(groups, S, L) == jsched.is_minimal(groups, S, L), name
    kinds = {name: _raises(tsched.validate_schedule, g, S, L) for name, g in _corruptions(S, L)}
    assert kinds["diagonal"] is None and tsched.is_minimal(tsched.diagonal_groups(S, L), S, L)
    assert "twice" in kinds["twice"] and "cover" in kinds["missing"]
    if S * L > 1:
        assert "dependency" in kinds["broken"]
    for step in range(S + L + 2):
        assert tsched.groups_remaining(step, S, L) == jsched.groups_remaining(step, S, L)


def _embedded(cfg, n_seg, seed=0):
    params = tmodel.init_params(cfg, seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    seg = cfg.armt.segment_len
    toks = torch.randint(0, cfg.vocab, (1, n_seg * seg), generator=gen)
    return params, toks


def _held(groups, S, L):
    tsched.validate_schedule(groups, S, L)
    assert tsched.is_minimal(groups, S, L)
    assert groups == tsched.diagonal_groups(S, L)


@pytest.mark.parametrize("arch", ["llama-1b-armt", "jamba-1.5-large-398b", "kimi-k2-1t-a32b"])
def test_executed_diagonal_schedule_is_lemma_3_1(arch):
    """The cells each band step of run_diagonal ran (the fused cells, and
    the plain blocks slot by slot; jamba's strided positions, kimi's
    prelude slot) are the minimal schedule; the sequential executor's are
    the S*L one-cell steps, valid and not minimal."""
    cfg = tconfigs.get_smoke_config(arch)
    params, toks = _embedded(cfg, 3)
    L = cfg.n_layers
    for fused in (True, False):
        with torch.no_grad(), tsched.recording_cells() as runs:
            tmodel.forward_hidden(params, cfg, toks, schedule="diagonal", fused=fused)
        assert len(runs) == 1
        _held(runs[0], 3, L)
    with torch.no_grad(), tsched.recording_cells() as runs:
        tmodel.forward_hidden(params, cfg, toks, schedule="sequential", eager=True)
    (groups,) = runs
    tsched.validate_schedule(groups, 3, L)
    assert len(groups) == 3 * L and not tsched.is_minimal(groups, 3, L)
    # off when no block is open
    with torch.no_grad():
        tmodel.forward_hidden(params, cfg, toks, schedule="diagonal")
    assert tsched._cell_log is None


def test_executed_pipeline_pool_and_grad_schedules_are_lemma_3_1():
    """The resumable pipeline (k = 3 per call, overshooting the grid), the
    pooled step over carries at different cursors, and the out-of-place
    form under gradients each ran the minimal schedule."""
    cfg = tconfigs.get_smoke_config("llama-1b-armt")
    params, _ = _embedded(cfg, 1)
    layout = StackLayout.from_config(cfg)
    L = layout.n_layers
    apply, gapply = make_apply_block(cfg, "segmented"), make_grouped_apply(cfg, "segmented")
    exec_params = {"prelude": params["prelude"], "pattern": params["pattern"]}
    seg, D = cfg.armt.segment_len + cfg.armt.num_mem_tokens, cfg.d_model
    gen = torch.Generator().manual_seed(3)

    def segments(S):
        return torch.randn(S, 1, seg, D, generator=gen)

    state0 = tmodel.init_state(cfg, 1, "cpu")
    with torch.no_grad(), tsched.recording_cells() as runs:
        xs, carry = diag.pipeline_init(layout, state0, segments(5))
        while carry["step"] < tsched.n_diagonal_groups(5, L):
            diag.pipeline_step(layout, exec_params, xs, carry, apply, n_groups=3,
                               grouped_apply=gapply)
        # a pool: members of 2, 4 and 3 segments, the second started 2 steps ahead
        pool = [diag.pipeline_init(layout, state0, segments(S)) for S in (2, 4, 3)]
        diag.pipeline_step(layout, exec_params, *pool[1], apply, n_groups=2,
                           grouped_apply=gapply)
        for _ in range(6):
            diag.pipeline_step_pool(layout, exec_params, [x for x, _ in pool],
                                    [c for _, c in pool], apply, n_groups=1,
                                    grouped_apply=gapply)
    assert len(runs) == 4
    _held(runs[0], 5, L)
    for groups, S in zip(runs[1:], (4, 2, 3)):      # in the order of their first step
        _held(groups, S, L)
    with tsched.recording_cells() as runs:
        p = tutils.tree_map(lambda t: t.clone().requires_grad_(), exec_params)
        ys, _ = diag.run_diagonal(layout, p, state0, segments(4), apply, grouped_apply=gapply)
        ys.sum().backward()
    (groups,) = runs
    _held(groups, 4, L)


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------

def test_utils_match_reference():
    for x in range(0, 40):
        for m in (1, 3, 8, 16):
            assert tutils.round_up(x, m) == jutils.round_up(x, m)
            assert tutils.cdiv(x, m) == jutils.cdiv(x, m)
    for n in (0, 1, 999, 1000, 1023, 1024, 1536, 10**6, 2**20, 5 * 2**30, 3.7e12, 2**50,
              1.2e15, 2**60 * 3, 1.5e18, -2048, 0.5):
        assert tutils.fmt_bytes(n) == jutils.fmt_bytes(n), n
        assert tutils.fmt_count(n) == jutils.fmt_count(n), n
    shapes = {"a": ((3, 4), np.float32, torch.float32), "b": ((7,), jnp.bfloat16,
                                                              torch.bfloat16),
              "c": ((2, 2, 5), np.int32, torch.int32), "d": ((), np.float32, torch.float32)}
    jtree = {"x": {k: jnp.zeros(s, d) for k, (s, d, _) in shapes.items()},
             "y": (jnp.ones((4, 4), jnp.bfloat16),)}
    ttree = {"x": {k: torch.zeros(s, dtype=d) for k, (s, _, d) in shapes.items()},
             "y": (torch.ones(4, 4, dtype=torch.bfloat16),), "pos": 5}
    assert tutils.tree_bytes(ttree) == jutils.tree_bytes(jtree)
    assert tutils.tree_params(ttree) == jutils.tree_params(jtree)
    meta = tutils.tree_map(lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t, ttree)
    assert tutils.tree_bytes(meta) == jutils.tree_bytes(jax.eval_shape(lambda: jtree))
    # the stores' byte counter is this function, not a copy
    assert state_store.tree_nbytes is tutils.tree_bytes
    jc = jutils.cast_tree(jtree, jnp.float32)
    tc = tutils.cast_tree(ttree, torch.float32)
    assert _tspec_any(tc) == {k: v for k, v in _jspec(jc).items()}
    assert tc["pos"] == 5


def _tspec_any(tree):
    names = {v: k for k, v in DTYPES.items()}
    return {p: (tuple(t.shape), names[t.dtype]) for p, t in tutils.tree_flatten_with_path(tree)
            if isinstance(t, torch.Tensor)}


def test_timers_wait_and_measure():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2}
    s = tutils.timeit_median(fn, torch.ones(4), warmup=2, iters=3)
    assert len(calls) == 5 and 0 <= s < 5
    with tutils.Timer() as t:
        sum(range(1000))
    assert 0 <= t.s < 5
