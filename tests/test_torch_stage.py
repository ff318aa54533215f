"""The 'stage' axis of the port's mesh-native serving
(``ServeEngine(mesh=...)`` with ``stage`` in the mesh): the diagonal
executor run as pipeline parallelism across ranks, each rank one block of
L / stage consecutive layers, on the CPU over ``torch.distributed`` with
gloo.

In process: a one-rank ``stage=1`` mesh equals the mesh-less engine to the
bit; the block a rank holds (the first rank's, on an ``AbstractMesh``);
where 'stage' does not divide the layers (a 3-layer smoke on ``stage=2``),
the reference's fallback: the ``slot_buf`` warning and
``sharding_fallback_total{kind="slot_buf"}``, every stage rank the whole
stack; the hand-off primitives on a one-rank axis.

Four ranks, each a process of its own (spawned once, rendezvous on a
``FileStore`` under the test's tmp_path, with a hard timeout), on the
smoke llama-1b-armt and h2o-danube-1.8b widened to 4 layers (two a stage
on ``stage=2``), fp32. Each property prints one ``OK <name>`` marker from
rank 0 once every rank has checked it:

  * ``stage=4`` and ``data=2,stage=2``: ``generate`` (tokens, every step's
    logits, the final state), the diagonal and the sequential prefill
    (hidden states, final state), ``serve()`` blocking and interleaved
    with pooled admissions, a prefix-cache hit and sessions from the stage
    mesh to one device and back equal the mesh-less engine to the bit. On
    ``data=2`` a B = 2 batch splits by rows, and on the CPU a row computed
    alone rounds otherwise than in a batch of two (the B = 1 cell fuses the
    memory update), so there the reference is each row's mesh-less run
    alone; a B = 1 request is replicated over 'data' and held to the
    mesh-less engine as it is;
  * ``stage=2,model=2``: tokens equal, logits within 1e-4 (the all-reduce
    rounds otherwise);
  * the hidden states of a 2-segment forward within 1e-5 relative of the
    JAX reference's single-device ``forward_hidden`` (computed here, passed
    as numpy);
  * the union over the stage ranks of the (segment, layer) cells their
    band steps recorded passes ``validate_schedule`` and ``is_minimal``
    (Lemma 3.1), and every rank's own cells are its block's layers only;
  * ``gather_tree`` after ``shard_tree`` is the identity on a decode state
    whose stacked leaves are cut over 'stage';
  * the serve CLI with ``--mesh data=2,stage=2`` gives the mesh-less CLI's
    tokens."""
import dataclasses
import logging
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel import sharding as tshd  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve import telemetry as ttel  # noqa: E402
from repro_torch.utils import tree_flatten_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama-1b-armt", "h2o-danube-1.8b")
N_LAYERS = 4
MESHES = ("stage=4", "data=2,stage=2", "stage=2,model=2")
WORLD, TIMEOUT_S = 4, 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_state(a, b):
    return all(torch.equal(_bits(x[k]), _bits(y[k]))
               for part in ("prelude", "pattern") for x, y in zip(a[part], b[part])
               for k in x) and torch.equal(torch.as_tensor(a["pos"]), torch.as_tensor(b["pos"]))


def _widened(arch):
    return dataclasses.replace(t_smoke(arch), n_layers=N_LAYERS)


@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist
    tmesh.init_distributed("gloo", store_path=str(tmp_path / "store"), rank=0, world_size=1)
    yield tmesh.parse_mesh("stage=1")
    dist.destroy_process_group()


def test_one_rank_stage_mesh_equals_meshless_to_the_bit(one_rank):
    cfg = _widened("llama-1b-armt")
    params = tmodel.init_params(cfg, 0, device="cpu")
    seg = cfg.armt.segment_len
    ref = ServeEngine(params, cfg, device="cpu", max_len=256)
    eng = ServeEngine(params, cfg, device="cpu", max_len=256, mesh=one_rank)
    assert eng.params is params and eng._sp is None and eng.stacked_axis == "stage"
    prompts = np.random.default_rng(1).integers(8, cfg.vocab, (2, 2 * seg + 5))
    a, b = ref.generate(prompts, 12, keep=True), eng.generate(prompts, 12, keep=True)
    assert np.array_equal(a.tokens, b.tokens)
    assert torch.equal(_bits(a.logits), _bits(b.logits))
    assert _same_state(a.state, b.state)
    rng = np.random.default_rng(7)
    reqs = [Request(f"r{i}", rng.integers(8, cfg.vocab, (n,)).astype(np.int32), 5)
            for i, n in enumerate([2 * seg, seg + 3, 7])]

    def stream(e):
        return [(ev.req_id, ev.token, ev.index) for ev in e.serve(reqs, n_slots=2, chunk=3)]
    assert stream(eng) == stream(ref)


@pytest.mark.parametrize("spec,block", [("data=1,stage=2", (0, 1)), ("stage=4", (0, 1)),
                                        ("stage=2,model=2", (0, 2))])
def test_stage_block_of_the_first_rank(spec, block):
    """On an ``AbstractMesh`` (the first rank's coordinates) the engine holds
    the first block of L / stage layers: its config, params and decode
    state are the block's; embed, final_norm and head stay whole."""
    n_layers = {"data=1,stage=2": 2}.get(spec, 4)
    cfg = dataclasses.replace(t_smoke("llama-1b-armt"), n_layers=n_layers)
    params = tmodel.init_params(cfg, 0, device="cpu")
    sizes = dict(e.split("=") for e in spec.split(","))
    mesh = tmesh.AbstractMesh(tuple(int(v) for v in sizes.values()), tuple(sizes))
    eng = ServeEngine(params, cfg, device="cpu", max_len=64, mesh=mesh)
    L_loc = block[1] - block[0]
    assert eng.stacked_axis == "stage"
    assert (eng._sp.lo, eng._sp.hi, eng._sp.n_layers) == (block[0], block[1], n_layers)
    assert eng.cfg.n_layers == L_loc and eng.full_cfg is cfg
    assert eng._grid_layers == n_layers and eng._n_layers == L_loc
    wq = eng.params["pattern"][0]["attn"]["wq"]
    assert wq.shape[0] == L_loc
    assert set(eng.params) == set(params)
    assert eng.params["final_norm"]["w"].shape == params["final_norm"]["w"].shape
    if "model" not in sizes:    # a block of rows: a view of the whole leaf
        assert wq.data_ptr() == params["pattern"][0]["attn"]["wq"].data_ptr()
        assert eng.params["embed"] is params["embed"]
    st = eng.decode_state(2)
    assert st["pattern"][0]["A"].shape[0] == L_loc
    assert eng.prefill_carry_bytes(4) < ServeEngine(params, cfg, device="cpu",
                                                    max_len=64).prefill_carry_bytes(4)


def _fallback(caplog, kind):
    return [r.getMessage() for r in caplog.records
            if r.name == "repro_torch.parallel.sharding" and f"kind={kind}" in r.getMessage()]


def test_stage_that_does_not_divide_the_layers_falls_back(caplog):
    """3 layers on stage=2: the reference's fallback, not a refusal. The
    slot buffer's rule warns (one line) and counts
    ``sharding_fallback_total{kind="slot_buf"}``; the stacked leaves stay
    whole and every stage rank runs the whole stack."""
    tshd.reset_fallback_warnings()
    cfg = dataclasses.replace(t_smoke("llama-1b-armt"), n_layers=3)
    params = tmodel.init_params(cfg, 0, device="cpu")
    mesh = tmesh.AbstractMesh((2,), ("stage",))
    with caplog.at_level(logging.WARNING):
        eng = ServeEngine(params, cfg, device="cpu", max_len=64, mesh=mesh)
    lines = _fallback(caplog, "slot_buf")
    assert lines == ["sharding-fallback kind=slot_buf leaf=buf dim=0 size=3 axis=stage "
                     "axis_size=2 -> replicated"]
    counters = {k: v for k, v in ttel.default_registry().counters.items()
                if k.startswith("sharding_fallback_total") and "slot_buf" in k}
    assert list(counters.values()) == [1]
    assert _fallback(caplog, "param")
    assert eng._sp is None and eng.cfg.n_layers == 3 and eng._grid_layers == 3
    assert eng.params["pattern"][0]["attn"]["wq"].shape[0] == 3
    specs = eng.state_sharding(2)
    assert tshd.spec_of(specs["pattern"][0]["A"])[0] is None
    # the whole stack, as the mesh-less engine runs it
    ref = ServeEngine(params, cfg, device="cpu", max_len=64)
    prompts = np.random.default_rng(2).integers(8, cfg.vocab, (1, 2 * cfg.armt.segment_len))
    with comm.parallel(eng._tp, eng._sp):
        h, fin = tmodel.forward_hidden(eng.params, eng.cfg, torch.from_numpy(prompts))
    h0, fin0 = tmodel.forward_hidden(params, cfg, torch.from_numpy(prompts))
    assert torch.equal(_bits(h), _bits(h0))
    assert ref.cfg.n_layers == eng.cfg.n_layers
    tshd.reset_fallback_warnings()


def test_stage_primitives_on_one_rank_axis():
    """stage_range over a mesh without the axis, or of one rank, is the
    whole stack; the hand-off and the broadcast are the identity there,
    with no collective; outside a stage context ``stage_last`` is too."""
    x = torch.arange(6.0).reshape(2, 3)
    one = tmesh.AbstractMesh((1, 1), ("data", "stage"))
    assert comm.stage_range(8, None) == (0, 8)
    assert comm.stage_range(8, one) == (0, 8)
    assert comm.stage_range(8, tmesh.AbstractMesh((4,), ("stage",))) == (0, 2)
    assert comm.stage_shift(x, one) is x
    assert comm.stage_shift(x, tmesh.AbstractMesh((2,), ("data",))) is x
    assert comm.stage_broadcast(x, one) is x
    assert comm.stage_last(x) is x and comm.current_stage() is None
    cfg = _widened("llama-1b-armt")
    assert tmodel.local_config(cfg, 1, 1) is cfg
    assert tmodel.local_config(cfg, 1, 2).n_layers == 2
    assert tmodel.local_config(cfg, 2, 4).n_layers == 1
    with pytest.raises(ValueError, match="4 layers do not split into 3 stage blocks"):
        tmodel.local_config(cfg, 1, 3)


_RANK_SCRIPT = r'''
import dataclasses
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import get_smoke_config
from repro_torch.core import diagonal as diag
from repro_torch.core.schedule import is_minimal, recording_cells, validate_schedule
from repro_torch.launch.mesh import init_distributed, parse_mesh
from repro_torch.models import model as M
from repro_torch.parallel import comm
from repro_torch.serve import PrefixCache, Request, ServeEngine, SessionStore
from repro_torch.utils import tree_flatten_with_path, tree_unflatten

rank, world, store, data = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
init_distributed("gloo", store_path=store, rank=rank, world_size=world)
ref_np = np.load(data)
MAXLEN, NEW = 256, 8


def ok(name):
    dist.barrier()
    if rank == 0:
        print("OK", name, flush=True)


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same(a, b):
    return a.shape == b.shape and torch.equal(bits(a), bits(b))


def same_tree(a, b):
    return all(same(x[k], y[k]) for part in ("prelude", "pattern")
               for x, y in zip(a[part], b[part]) for k in x)


def near(a, b, tol=1e-4):
    return a.shape == b.shape and (a - b).abs().max().item() <= tol


for spec in ("stage=4", "data=2,stage=2", "stage=2,model=2"):
    mesh = parse_mesh(spec)
    exact = "model" not in spec
    split = "data" in spec
    for arch in ("llama-1b-armt", "h2o-danube-1.8b"):
        cfg = dataclasses.replace(get_smoke_config(arch), n_layers=4)
        like = M.init_params(cfg, 0, device="cpu")
        params = tree_unflatten(like, [torch.from_numpy(ref_np[f"{arch}:{p}"])
                                       for p, _ in tree_flatten_with_path(like)])
        seg = cfg.armt.segment_len
        rng = np.random.default_rng(7)
        tag = f"{spec} {arch}"
        eng = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, mesh=mesh)
        ref = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN)
        sp = eng._sp
        assert sp is not None and eng.cfg.n_layers == 4 // sp.size
        assert eng.params["pattern"][0]["attn"]["wq"].shape[0] == 4 // sp.size

        # generate: B = 1 (replicated over data), and B = 2 (split by rows
        # over data: the reference is each row alone)
        p1 = rng.integers(8, cfg.vocab, (1, 3 * seg + 5))
        a, b = ref.generate(p1, 12, keep=True), eng.generate(p1, 12, keep=True)
        assert np.array_equal(a.tokens, b.tokens), (tag, a.tokens, b.tokens)
        if exact:
            assert same(a.logits, b.logits) and same_tree(a.state, b.state), tag
        else:
            assert near(a.logits, b.logits), tag
        p2 = rng.integers(8, cfg.vocab, (2, 2 * seg + 3))
        b2 = eng.generate(p2, 12, keep=True)
        rows = [ref.generate(p2[i:i + 1], 12, keep=True) for i in range(2)] if split \
            else [ref.generate(p2, 12, keep=True)]
        want_tok = np.concatenate([r.tokens for r in rows])
        want_lg = torch.cat([r.logits for r in rows])
        assert np.array_equal(b2.tokens, want_tok), (tag, b2.tokens, want_tok)
        if exact:
            assert same(b2.logits, want_lg), tag
            for part in ("prelude", "pattern"):
                for x, *ys in zip(b2.state[part], *(r.state[part] for r in rows)):
                    for k in x:
                        dim = 1 if part == "pattern" else 0
                        assert same(x[k], torch.cat([y[k] for y in ys], dim)), (tag, k)
        else:
            assert near(b2.logits, want_lg), tag
        # cache mode: the prompt as one chunk through the stages
        ec = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, serve_mode="cache",
                         mesh=mesh)
        rc = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, serve_mode="cache")
        c, d = rc.generate(p1, 12, keep=True), ec.generate(p1, 12, keep=True)
        assert np.array_equal(c.tokens, d.tokens), tag
        assert same(c.logits, d.logits) if exact else near(c.logits, d.logits), tag
        ok(f"generate {tag}")

        # the prefill under both schedules: hidden states and final state
        for sched in ("diagonal", "sequential"):
            h0, f0 = ref.forward_hidden(p1[:, :3 * seg], schedule=sched)
            h1, f1 = eng.forward_hidden(p1[:, :3 * seg], schedule=sched)
            if exact:
                assert same(h0, h1) and same_tree(f0, f1), (tag, sched)
            else:
                assert near(h0, h1, 1e-4), (tag, sched)
        ok(f"prefill {tag}")

        # continuous serve: blocking, and interleaved with pooled admissions
        reqs = [Request(f"r{i}", rng.integers(8, cfg.vocab, (n,)).astype(np.int32), 5)
                for i, n in enumerate([3 * seg, 2 * seg + 3, 7, seg - 1, 4 * seg + 1])]

        def stream(e, **kw):
            return [(ev.req_id, ev.token, ev.index)
                    for ev in e.serve(reqs, n_slots=3, chunk=3, **kw)]
        for kw in ({"prefill_groups_per_chunk": 0}, {"prefill_groups_per_chunk": 2}):
            diag.pool_counts.update(steps=0, member_steps=0)
            got = stream(eng, **kw)
            pooled = diag.pool_counts["steps"]
            assert got == stream(ref, **kw), (tag, kw)
            assert pooled > 0 or kw["prefill_groups_per_chunk"] == 0, (tag, pooled)
        ok(f"serve {tag}")

        if exact:
            # the prefix cache on the stage mesh: a miss, a full and a partial hit
            pcs = [ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, mesh=m,
                               prefix_cache=PrefixCache(seg, max_bytes=64 << 20))
                   for m in (mesh, None)]
            sys_p = rng.integers(8, cfg.vocab, (2 * seg,)).astype(np.int32)
            q = np.concatenate([sys_p, rng.integers(8, cfg.vocab, (5,)).astype(np.int32)])
            outs = [[e.generate(x[None], NEW, keep=True) for x in (q, q, sys_p)] for e in pcs]
            assert [r.cached_segments for r in outs[0]] == [0, 2, 2], tag
            for x, y in zip(*outs):
                assert np.array_equal(x.tokens, y.tokens) and same(x.logits, y.logits), tag
            snap = pcs[0].prefix_cache.match(sys_p)[1]
            A = snap.state["pattern"][0]["A"]
            assert A.device.type == "cpu" and A.shape[0] == 4, (tag, A.shape)
            ok(f"prefix_cache {tag}")

            # sessions: stage mesh -> one device, and one device -> stage mesh
            t1 = rng.integers(8, cfg.vocab, (seg + 3,)).astype(np.int32)
            t2 = rng.integers(8, cfg.vocab, (seg // 2,)).astype(np.int32)
            ref_s = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN,
                                session_store=SessionStore())
            w1 = ref_s.generate(t1[None], NEW, session_id="s", keep=True)
            w2 = ref_s.generate(t2[None], NEW, session_id="s", keep=True)
            for first, second in ((mesh, None), (None, mesh)):
                st = SessionStore()
                g1 = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, mesh=first,
                                 session_store=st).generate(t1[None], NEW, session_id="s")
                g2 = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, mesh=second,
                                 session_store=st).generate(t2[None], NEW, session_id="s",
                                                            keep=True)
                assert np.array_equal(g1.tokens, w1.tokens), tag
                assert g2.resumed and np.array_equal(g2.tokens, w2.tokens), tag
                assert same(g2.logits, w2.logits) and same_tree(g2.state, w2.state), tag
            ok(f"sessions {tag}")

        if spec == "stage=4":
            # the forward against the JAX reference's single-device forward_hidden
            h, _ = eng.forward_hidden(ref_np[f"{arch}:tokens"])
            want = torch.from_numpy(ref_np[f"{arch}:hidden"])
            rel = ((h - want).norm() / want.norm()).item()
            assert rel <= 1e-5, (arch, rel)
            ok(f"forward_vs_jax {arch} rel_err {rel:.2e}")

            # Lemma 3.1 across ranks: the union of the cells the stages ran
            S = 3
            with recording_cells() as runs:
                eng.forward_hidden(p1[:, :S * seg])
            mine = runs[0]
            assert {l for g in mine for _, l in g} == set(range(sp.lo, sp.hi)), (rank, mine)
            every = [None] * world
            dist.all_gather_object(every, mine)
            n = max(len(g) for g in every)
            groups = [sorted(c for g in every if i < len(g) for c in g[i]) for i in range(n)]
            validate_schedule(groups, S, 4)
            assert is_minimal(groups, S, 4), groups
            ok(f"lemma31 {arch}")

        # gather_tree after shard_tree: the identity on a stage-cut decode state
        whole = M.decode_state_init(cfg, 4, dtype=torch.float32, device="cpu",
                                    per_slot_pos=True)
        g = torch.Generator().manual_seed(0)    # the same values on every rank
        whole = {**{p: tuple({k: torch.randn(v.shape, generator=g) for k, v in d.items()}
                             for d in whole[p]) for p in ("prelude", "pattern")},
                 "pos": torch.arange(4)}
        specs = eng.state_sharding(4, per_slot_pos=True)
        local = comm.shard_tree(whole, specs, mesh)
        assert local["pattern"][0]["A"].shape[0] == 4 // sp.size
        back = comm.gather_tree(local, specs, mesh)
        assert all(torch.equal(x[k], y[k]) for p in ("prelude", "pattern")
                   for x, y in zip(whole[p], back[p]) for k in x)
        ok(f"gather_shard_identity {tag}")

# the CLI on data=2,stage=2 (the smoke config's 2 layers, one a stage): the
# mesh-less CLI's tokens
from repro_torch.launch import serve as launch_serve
argv = ["--arch", "llama-1b-armt", "--smoke", "--device", "cpu", "--prompt-len", "37",
        "--max-new", "6"]
got = launch_serve.main(argv + ["--mesh", "data=2,stage=2"])["tokens"]
assert np.array_equal(got, launch_serve.main(argv)["tokens"])
ok("cli data=2,stage=2")
dist.destroy_process_group()
'''

MARKERS = ([f"{m} {s} {a}" for s in MESHES for a in ARCHS
            for m in ("generate", "prefill", "serve", "gather_shard_identity")]
           + [f"{m} {s} {a}" for s in MESHES if "model" not in s for a in ARCHS
              for m in ("prefix_cache", "sessions")]
           + [f"{m} {a}" for a in ARCHS for m in ("forward_vs_jax", "lemma31")]
           + ["cli data=2,stage=2"])


def _reference_npz(path: Path) -> None:
    """Each arch's params (the reference's at 4 layers, converted) and the
    reference's single-device hidden states of a 2-segment, B = 2 prompt,
    fp32."""
    out = {}
    jax.config.update("jax_default_matmul_precision", "highest")
    for arch in ARCHS:
        jc = dataclasses.replace(j_smoke(arch), n_layers=N_LAYERS)
        jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        for p, leaf in tree_flatten_with_path(tp):
            out[f"{arch}:{p}"] = leaf.numpy()
        toks = np.random.default_rng(3).integers(8, jc.vocab, (2, 2 * jc.armt.segment_len))
        jh, _ = jmodel.forward_hidden(jp, jc, jnp.asarray(toks), schedule="diagonal")
        out[f"{arch}:tokens"], out[f"{arch}:hidden"] = toks, np.asarray(jh)
    np.savez(path, **out)


def test_four_gloo_ranks_stage_meshes(tmp_path):
    data = tmp_path / "ref.npz"
    _reference_npz(data)
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent(_RANK_SCRIPT))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(WORLD),
                               str(tmp_path / "store"), str(data)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(WORLD)]
    outs, timed_out = [], False
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0])
    report = "\n".join(f"--- rank {r} ---\n{o[-3000:]}" for r, o in enumerate(outs))
    assert not timed_out, f"the ranks did not finish in {TIMEOUT_S} s\n{report}"
    assert all(p.returncode == 0 for p in procs), report
    for m in MARKERS:
        assert f"OK {m}" in outs[0], (m, report)
    print(outs[0])
