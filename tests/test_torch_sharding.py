"""The port's sharding rules (``repro_torch.parallel.sharding``) and mesh
parsing (``repro_torch.launch.mesh``) against the reference's, with no
devices: the reference's rules on a ``jax.sharding.AbstractMesh``, the
port's on its ``AbstractMesh`` of the same shape, over every config's smoke
tree, leaf by leaf; the fallback warnings' text and dedup, the
``sharding_fallback_total`` counter and its reset, both ways; and
``parse_mesh``'s accepted specs and error messages on the same specs."""
import functools
import logging

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import OptimConfig as JOptimConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro.serve import telemetry as jtel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import OptimConfig  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.parallel import sharding as tshd  # noqa: E402
from repro_torch.serve import telemetry as ttel  # noqa: E402

MESHES = [{"data": 2, "model": 4}, {"data": 1, "model": 1},
          {"pod": 2, "data": 2, "model": 2}, {"data": 2, "stage": 2},
          {"stage": 2, "model": 4}]
ARCHS = tconfigs.list_archs()
BATCH, MAXLEN = 4, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def meshes(shape):
    return (JAbstractMesh(tuple(shape.values()), tuple(shape)),
            tmesh.AbstractMesh(tuple(shape.values()), tuple(shape)))


def jflat(tree):
    """{path names: spec tuple} of a reference sharding (or spec) tree."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, (jax.sharding.NamedSharding,
                                                   jax.sharding.PartitionSpec)))[0]:
        spec = s.spec if hasattr(s, "spec") else s
        out[tuple(jshd._path_names(path))] = tuple(spec)
    return out


def tflat(tree):
    return {tuple(names): tuple(tshd.spec_of(s)) for names, s in tshd._flatten_with_path(tree)}


def same(jtree, ttree):
    j, t = jflat(jtree), tflat(ttree)
    assert j.keys() == t.keys(), sorted(set(j) ^ set(t))
    bad = {k: (j[k], t[k]) for k in j if j[k] != t[k]}
    assert not bad, bad
    return len(j)


def to_jax(tree):
    """A port shape tree as the reference's ShapeDtypeStructs."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return jax.ShapeDtypeStruct(tuple(x.shape), jnp.float32)
        return jax.ShapeDtypeStruct((), jnp.int32)
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(to_jax(v) for v in tree)
    return one(tree)


@functools.lru_cache(maxsize=None)
def trees(arch):
    """(reference param shapes, port param shapes) of the smoke config."""
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    return jcfg, tcfg, jmodel.param_specs(jcfg), tmodel.param_specs(tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch):
    jcfg, tcfg, jp, tp = trees(arch)
    jocfg, tocfg = JOptimConfig(factored_v=True), OptimConfig(factored_v=True)
    jopt = jax.eval_shape(lambda p: j_adamw_init(p, jocfg), jp)
    topt = adamw_init(tp, tocfg)
    n = 0
    for shape in MESHES:
        jm, tm = meshes(shape)
        n += same(jshd.param_specs(jp, jm), tshd.param_specs(tp, tm))
        n += same(jshd.param_specs(jp, jm, fsdp=True), tshd.param_specs(tp, tm, fsdp=True))
        if "stage" in shape:
            n += same(jshd.param_specs(jp, jm, stacked_axis="stage"),
                      tshd.param_specs(tp, tm, stacked_axis="stage"))
        for z1 in (True, False):
            n += same(jshd.opt_state_specs(jopt, jp, jm, zero1=z1),
                      tshd.opt_state_specs(topt, tp, tm, zero1=z1))
    assert n > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_and_carry_specs_match_reference(arch):
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    for mode in ("armt", "cache"):
        if mode == "armt" and tcfg.armt is None and not tcfg.is_recurrent:
            continue
        for per_slot in (True, False):
            for batch in (1, BATCH):
                jst = jmodel.decode_state_shapes(jcfg, batch, serve_mode=mode, max_len=MAXLEN,
                                                 dtype=jnp.float32, per_slot_pos=per_slot)
                tst = tmodel.decode_state_shapes(tcfg, batch, serve_mode=mode, max_len=MAXLEN,
                                                 dtype=torch.float32, per_slot_pos=per_slot)
                for shape in MESHES:
                    jm, tm = meshes(shape)
                    kw = {"stacked_axis": "stage"} if "stage" in shape else {}
                    same(jshd.decode_state_specs(jst, jm, batch, **kw),
                         tshd.decode_state_specs(tst, tm, batch, **kw))
    # the diagonal executor's carries: a synthetic carry of the port's
    # executor state, the same shapes on both sides
    state = tmodel.init_state(tcfg, BATCH, "meta", torch.float32)
    L, T, D, S = len(tcfg.layer_types), 12, tcfg.d_model, 3
    cap = {"prelude": tuple({k: torch.empty((S + L - 1,) + tuple(v.shape), device="meta")
                             for k, v in d.items()} for d in state["prelude"]),
           "pattern": tuple({k: torch.empty((S + L - 1,) + tuple(v.shape), device="meta")
                             for k, v in d.items()} for d in state["pattern"])}
    carry = {"buf": torch.empty(L, BATCH, T, D, device="meta"), "state": state,
             "step": 0, "ys": torch.empty(S, BATCH, T, D, device="meta"),
             "win": torch.empty(2, BATCH, T, D, device="meta"),
             "brow": torch.empty(S, BATCH, D, device="meta"), "cap": cap}
    pool = tmodel._tree_map(lambda p, t: torch.empty((3,) + tuple(getattr(t, "shape", ())),
                                                     device="meta"), carry)
    for shape in MESHES:
        jm, tm = meshes(shape)
        for kw in ({}, {"stacked_axis": "stage"} if "stage" in shape else {}):
            for batch in (1, BATCH):
                same(jshd.pipeline_carry_specs(to_jax(carry), jm, L, batch, **kw),
                     tshd.pipeline_carry_specs(carry, tm, L, batch, **kw))
                same(jshd.pool_carry_specs(to_jax(pool), jm, L, batch, **kw),
                     tshd.pool_carry_specs(pool, tm, L, batch, **kw))


def test_batch_slot_and_replicated_specs_match_reference():
    for shape in MESHES:
        jm, tm = meshes(shape)
        for batch in (1, 2, 3, 4, 8):
            jb = {"tokens": jax.ShapeDtypeStruct((batch, 16), jnp.int32),
                  "labels": jax.ShapeDtypeStruct((batch, 16), jnp.int32)}
            tb = {"tokens": torch.empty(batch, 16, device="meta"),
                  "labels": torch.empty(batch, 16, device="meta")}
            same(jshd.batch_specs(jm, jb), tshd.batch_specs(tm, tb))
            assert jshd.batch_axes(jm, batch) == tshd.batch_axes(tm, batch)
            for n_layers in (3, 4, 16):
                j, t = (jshd.slot_buf_spec(jm, n_layers, batch),
                        tshd.slot_buf_spec(tm, n_layers, batch))
                assert (j is None and t is None) or tuple(j) == tuple(t), (shape, j, t)
        for f in ("dp_axes", "dp_size", "tp_size", "stage_size"):
            assert getattr(jshd, f)(jm) == getattr(tshd, f)(tm)
        assert tuple(jshd.replicated(jm).spec) == tuple(tshd.replicated(tm).spec) == ()


def _fallback_lines(caplog, logger):
    return [r.getMessage() for r in caplog.records
            if r.name == logger and "sharding-fallback" in r.getMessage()]


def _fallback_counters(reg):
    return {k: v for k, v in reg.counters.items() if k.startswith("sharding_fallback_total")}


def test_fallback_warnings_and_counter_match_reference(caplog):
    """The same fallbacks log the same lines (one per distinct site) and
    count the same series; reset clears both views, both ways."""
    jshd.reset_fallback_warnings()
    tshd.reset_fallback_warnings()
    jm, tm = meshes({"data": 3, "model": 16})
    _, _, jp, tp = trees("qwen2.5-32b")
    jst = jmodel.decode_state_shapes(jconfigs.get_smoke_config("qwen2.5-32b"), 5,
                                     serve_mode="armt", max_len=MAXLEN, dtype=jnp.float32,
                                     per_slot_pos=True)
    tst = tmodel.decode_state_shapes(tconfigs.get_smoke_config("qwen2.5-32b"), 5,
                                     serve_mode="armt", max_len=MAXLEN,
                                     dtype=torch.float32, per_slot_pos=True)
    with caplog.at_level(logging.WARNING):
        for _ in range(2):              # the second pass logs nothing new
            jshd.param_specs(jp, jm)
            tshd.param_specs(tp, tm)
            jshd.decode_state_specs(jst, jm, 5)
            tshd.decode_state_specs(tst, tm, 5)
            jshd.param_leaf_spec(["pattern", "attn", "wq"], (30, 30), 16)
            tshd.param_leaf_spec(["pattern", "attn", "wq"], (30, 30), 16)
    jl = _fallback_lines(caplog, "repro.parallel.sharding")
    tl = _fallback_lines(caplog, "repro_torch.parallel.sharding")
    assert jl and sorted(jl) == sorted(tl)     # jax walks dict keys sorted
    assert len(tl) == len(set(tl))
    assert any("leaf=pattern.attn.wq dim=1 size=30 axis=model axis_size=16" in m for m in tl)
    jc = _fallback_counters(jtel.default_registry())
    tc = _fallback_counters(ttel.default_registry())
    assert jc and jc == tc and max(tc.values()) >= 2     # not deduplicated
    # reset: the counter goes and the dedup set with it
    tshd.reset_fallback_warnings()
    assert not _fallback_counters(ttel.default_registry())
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        tshd.param_leaf_spec(["pattern", "attn", "wq"], (30, 30), 16)
    assert len(_fallback_lines(caplog, "repro_torch.parallel.sharding")) == 1
    # the registry's reset clears the dedup set too
    ttel.default_registry().reset()
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        tshd.param_leaf_spec(["pattern", "attn", "wq"], (30, 30), 16)
    assert len(_fallback_lines(caplog, "repro_torch.parallel.sharding")) == 1
    assert _fallback_counters(ttel.default_registry())
    # batch = 1 is quiet, batch > 1 that cannot fill the dp axes warns
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert tshd.batch_axes(tm, 1, leaf="admission") is None
        assert tshd.batch_axes(tm, 2, leaf="pool") is None
    assert [m for m in _fallback_lines(caplog, "repro_torch.parallel.sharding")
            if "leaf=pool" in m]
    jshd.reset_fallback_warnings()
    tshd.reset_fallback_warnings()


@pytest.mark.parametrize("spec,n", [
    ("data=2,model=4", 8), ("data,model=4", 8), ("model=2,data", 8),
    ("pod=2,data,model=2", 8), ("data=2,stage=2", 4), ("stage,model=4", 8),
    ("data=1,model=1", 1), ("data,model=1", 1), (" data = ,model=1", 1),
    ("banana=2", 1), ("data,model", 1), ("data=1,data=1", 1), ("data=64,model=2", 1),
    ("data=1", 2), ("data=0", 1), (" , ", 1), ("data,model=3", 8), ("model=-1", 1)])
def test_parse_mesh_matches_reference(spec, n):
    devices = jax.devices()[:1] * n
    try:
        jm = jmesh.parse_mesh(spec, devices=devices)
        want = (tuple(jm.axis_names), tuple(jm.devices.shape))
    except ValueError as e:
        want = ("error", str(e))
    try:
        tm = tmesh.parse_mesh(spec, devices=n)
        got = (tm.axis_names, tuple(tm.shape.values()))
    except ValueError as e:
        got = ("error", str(e))
    assert got == want


def test_hardware_constants_are_the_h100s():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.NVLINK_BW == 450e9
    for name in ("PEAK_FLOPS_BF16", "HBM_BW"):
        assert getattr(tmesh, name) != getattr(jmesh, name)
