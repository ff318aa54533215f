"""Mesh-native serving of the port (``ServeEngine(mesh=...)``) on the CPU
over ``torch.distributed`` with gloo.

In process: a one-rank group, ``data=1,model=1``: ``generate`` (tokens,
every step's logits, the final state) and ``serve()`` equal the mesh-less
engine's to the bit, as nothing is cut on one rank; the engine's refusals.

Four ranks, ``data=2,model=2``, each a process of its own (spawned by one
test, rendezvous on a ``FileStore`` under the test's tmp_path, so parallel
test workers never share a port), on the smoke llama-1b-armt and
h2o-danube-1.8b (dense ARMT) in both serve modes. Each property prints one
``OK <name>`` marker from rank 0 once every rank has checked it:
``generate`` at B = 2 on a prompt of two segments and a tail, token for
token against the mesh-less engine (every step's logits within 1e-4);
the forward's hidden states against the JAX reference's single-device
``forward_hidden`` (fp32, 2 segments; computed here, passed as numpy):
||h - h_ref|| / ||h_ref|| within 1e-5; continuous ``serve()`` with more
requests than slots and mixed lengths, interleaved (pooled admissions)
and blocking; a sampled generate; the prefix cache on the mesh (a
partial and a full-prefix hit); a session captured on 2x2 resumed
mesh-less, and the reverse; scheduler sessions through the mesh engine;
``gather_tree`` after ``shard_tree`` the identity on a decode state. The
ranks have a hard timeout, past which the test fails with their output."""
import dataclasses
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
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.utils import tree_flatten_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama-1b-armt", "h2o-danube-1.8b")
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


@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist
    tmesh.init_distributed("gloo", store_path=str(tmp_path / "store"), rank=0, world_size=1)
    yield tmesh.parse_mesh("data=1,model=1")
    dist.destroy_process_group()


@pytest.mark.parametrize("serve_mode", ["armt", "cache"])
def test_one_rank_mesh_equals_meshless_to_the_bit(one_rank, serve_mode):
    cfg = t_smoke("llama-1b-armt")
    params = tmodel.init_params(cfg, 0, device="cpu")
    seg = cfg.armt.segment_len
    ref = ServeEngine(params, cfg, device="cpu", max_len=256, serve_mode=serve_mode)
    eng = ServeEngine(params, cfg, device="cpu", max_len=256, serve_mode=serve_mode,
                      mesh=one_rank)
    assert eng.params is params and eng.cfg is cfg and eng._tp is None
    prompts = np.random.default_rng(1).integers(8, cfg.vocab, (2, 2 * seg + 5))
    a, b = ref.generate(prompts, 12, keep=True), eng.generate(prompts, 12, keep=True)
    assert np.array_equal(a.tokens, b.tokens)
    assert torch.equal(_bits(a.logits), _bits(b.logits))
    assert _same_state(a.state, b.state)
    rng = np.random.default_rng(7)
    reqs = [Request(f"r{i}", rng.integers(8, cfg.vocab, (n,)).astype(np.int32), 5)
            for i, n in enumerate([2 * seg, seg + 3, 7, seg - 1])]

    def stream(e):
        return [(ev.req_id, ev.token, ev.index) for ev in e.serve(reqs, n_slots=2, chunk=3)]
    assert stream(eng) == stream(ref)
    # the CLI on the one-rank mesh: the engine's tokens
    argv = ["--arch", "llama-1b-armt", "--smoke", "--device", "cpu", "--serve-mode",
            serve_mode, "--prompt-len", str(2 * seg + 3), "--max-new", "6"]
    assert np.array_equal(launch_serve.main(argv + ["--mesh", "data,model=1"])["tokens"],
                          launch_serve.main(argv)["tokens"])


def test_mesh_refusals():
    """A config outside the dense ARMT family and heads the model axis does
    not divide are refused, each with a one-line reason; a stage axis is
    served, each rank one block of the layers (here the first rank's)."""
    cfg = t_smoke("llama-1b-armt")
    params = tmodel.init_params(cfg, 0, device="cpu")
    eng = ServeEngine(params, cfg, device="cpu",
                      mesh=tmesh.AbstractMesh((1, 2), ("data", "stage")))
    assert eng.stacked_axis == "stage"
    assert (eng._sp.lo, eng._sp.hi, eng._sp.n_layers) == (0, 1, cfg.n_layers)
    assert eng.cfg.n_layers == 1 and eng.params["pattern"][0]["attn"]["wq"].shape[0] == 1
    fcfg = t_smoke("falcon-mamba-7b")
    fparams = tmodel.init_params(fcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="dense ARMT family.*ROADMAP Queue 1"):
        ServeEngine(fparams, fcfg, device="cpu", max_len=64,
                    mesh=tmesh.AbstractMesh((1, 1), ("data", "model")))
    with pytest.raises(ValueError, match="n_kv_heads 2 does not divide"):
        tmodel.local_config(cfg, 4)
    with pytest.raises(ValueError, match="d_ff 64 does not divide"):
        tmodel.local_config(dataclasses.replace(cfg, n_heads=3, n_kv_heads=3), 3)
    local = tmodel.local_config(cfg, 2)
    assert (local.n_heads, local.n_kv_heads, local.d_ff, local.head_dim,
            local.armt.d_val) == (2, 1, 32, 8, 16)
    assert tmodel.local_config(cfg, 1) is cfg


_RANK_SCRIPT = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import init_distributed, parse_mesh
from repro_torch.models import model as M
from repro_torch.parallel import comm
from repro_torch.serve import PrefixCache, Request, ServeEngine, SessionStore
from repro_torch.utils import tree_flatten_with_path, tree_unflatten

rank, world, store, data = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
init_distributed("gloo", store_path=store, rank=rank, world_size=world)
mesh = parse_mesh("data=2,model=2")
ref_np = np.load(data)
MAXLEN, NEW = 256, 8


def ok(name):
    torch.distributed.barrier()
    if rank == 0:
        print("OK", name, flush=True)


for arch in ("llama-1b-armt", "h2o-danube-1.8b"):
    cfg = get_smoke_config(arch)
    like = M.init_params(cfg, 0, device="cpu")
    params = tree_unflatten(like, [torch.from_numpy(ref_np[f"{arch}:{p}"])
                                   for p, _ in tree_flatten_with_path(like)])
    seg = cfg.armt.segment_len
    rng = np.random.default_rng(7)
    for mode in ("armt", "cache"):
        ref = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, serve_mode=mode)
        eng = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, serve_mode=mode,
                          mesh=mesh)
        # generate: B = 2 (one row a data rank), two segments and a tail
        prompts = rng.integers(8, cfg.vocab, (2, 2 * seg + 5))
        a, b = ref.generate(prompts, 12, keep=True), eng.generate(prompts, 12, keep=True)
        assert np.array_equal(a.tokens, b.tokens), (arch, mode, a.tokens, b.tokens)
        err = (a.logits - b.logits).abs().max().item()
        assert err <= 1e-4, (arch, mode, err)
        for part in ("prelude", "pattern"):
            for x, y in zip(a.state[part], b.state[part]):
                for k in x:
                    assert x[k].shape == y[k].shape, (k, x[k].shape, y[k].shape)
        ok(f"generate {arch} {mode}")
        # continuous serve: more requests than slots, mixed lengths
        reqs = [Request(f"r{i}", rng.integers(8, cfg.vocab, (n,)).astype(np.int32), 5)
                for i, n in enumerate([2 * seg, seg + 3, 7, seg - 1, 3 * seg + 1])]
        outs = {}
        for ev in eng.serve(reqs, n_slots=2, chunk=3):
            outs.setdefault(ev.req_id, []).append(ev.token)
        for r in reqs:
            assert outs[r.req_id] == ref.generate(np.asarray(r.prompt)[None], 5
                                                  ).tokens[0].tolist(), (arch, mode, r.req_id)
        # blocking admission gives the same streams
        blocking = {}
        for ev in eng.serve(reqs, n_slots=2, chunk=3, prefill_groups_per_chunk=0):
            blocking.setdefault(ev.req_id, []).append(ev.token)
        assert blocking == outs, (arch, mode)
        ok(f"serve {arch} {mode}")
    # sampling: every rank of a model group draws the same token
    p1 = rng.integers(8, cfg.vocab, (1, seg + 3))
    kw = dict(temperature=0.8, top_k=40, seed=5)
    assert np.array_equal(eng.generate(p1, 8, **kw).tokens, ref.generate(p1, 8, **kw).tokens)
    ok(f"sampled {arch}")

    eng = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, mesh=mesh)
    ref = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN)
    # the forward against the JAX reference's single-device forward_hidden
    toks = ref_np[f"{arch}:tokens"]
    h, fin = eng.forward_hidden(toks)
    want = torch.from_numpy(ref_np[f"{arch}:hidden"])
    rel = ((h - want).norm() / want.norm()).item()
    assert rel <= 1e-5, (arch, rel)
    ok(f"forward_vs_jax {arch} rel_err {rel:.2e}")

    # the prefix cache on the mesh: a partial and a full-prefix hit
    eng_pc = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, mesh=mesh,
                         prefix_cache=PrefixCache(seg, max_bytes=64 << 20))
    sys_p = rng.integers(8, cfg.vocab, (2 * seg,)).astype(np.int32)
    p1 = np.concatenate([sys_p, rng.integers(8, cfg.vocab, (5,)).astype(np.int32)])
    r1 = eng_pc.generate(p1[None], NEW)
    r2 = eng_pc.generate(p1[None], NEW)
    r3 = eng_pc.generate(sys_p[None], NEW)
    assert (r1.cached_segments, r2.cached_segments, r3.cached_segments) == (0, 2, 2)
    assert np.array_equal(r2.tokens, ref.generate(p1[None], NEW).tokens)
    assert np.array_equal(r3.tokens, ref.generate(sys_p[None], NEW).tokens)
    snap = eng_pc.prefix_cache.match(sys_p)[1]
    assert all(t.device.type == "cpu" and t.shape[-1] == cfg.d_model
               for t in (snap.state["pattern"][0]["A"],))
    ok(f"prefix_cache {arch}")

    # sessions across meshes: 2x2 -> one device, one device -> 2x2
    t1 = rng.integers(8, cfg.vocab, (seg + 3,)).astype(np.int32)
    t2 = rng.integers(8, cfg.vocab, (seg // 2,)).astype(np.int32)
    ref_s = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, session_store=SessionStore())
    b1 = ref_s.generate(t1[None], NEW, session_id="s")
    b2 = ref_s.generate(t2[None], NEW, session_id="s")
    store1 = SessionStore()
    a1 = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, mesh=mesh,
                     session_store=store1).generate(t1[None], NEW, session_id="s")
    a2 = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN,
                     session_store=store1).generate(t2[None], NEW, session_id="s")
    assert np.array_equal(a1.tokens, b1.tokens)
    assert a2.resumed and np.array_equal(a2.tokens, b2.tokens)
    ok(f"session_2x2_to_1dev {arch}")
    store2 = SessionStore()
    ServeEngine(params, cfg, device="cpu", max_len=MAXLEN,
                session_store=store2).generate(t1[None], NEW, session_id="z")
    c2 = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, mesh=mesh,
                     session_store=store2).generate(t2[None], NEW, session_id="z")
    assert c2.resumed and np.array_equal(c2.tokens, b2.tokens)
    ok(f"session_1dev_to_2x2 {arch}")

    # scheduler sessions through the mesh engine
    eng_s = ServeEngine(params, cfg, device="cpu", max_len=MAXLEN, mesh=mesh,
                        session_store=SessionStore())
    outs = {}
    for turn in ([Request("q", t1, NEW, session_id="w"),
                  Request("x", t2, NEW, session_id="v")],
                 [Request("q2", t2, NEW, session_id="w")]):
        for ev in eng_s.serve(turn, n_slots=2, chunk=3):
            outs.setdefault(ev.req_id, []).append(ev.token)
    assert outs["q"] == b1.tokens[0].tolist() and outs["q2"] == b2.tokens[0].tolist()
    ok(f"scheduler_sessions {arch}")

    # gather_tree after shard_tree: the identity on a decode state
    whole = M.decode_state_init(cfg, 4, dtype=torch.float32, device="cpu",
                                per_slot_pos=True)
    g = torch.Generator().manual_seed(0)    # the same values on every rank
    whole = {**{p: tuple({k: torch.randn(v.shape, generator=g) for k, v in d.items()}
                         for d in whole[p]) for p in ("prelude", "pattern")},
             "pos": torch.arange(4)}
    specs = eng.state_sharding(4, per_slot_pos=True)
    local = comm.shard_tree(whole, specs, mesh)
    assert local["pattern"][0]["A"].shape[-1] == cfg.d_model // 2
    assert local["pattern"][0]["k"].shape[1] == 2
    back = comm.gather_tree(local, specs, mesh)
    assert all(torch.equal(x[k], y[k]) for p in ("prelude", "pattern")
               for x, y in zip(whole[p], back[p]) for k in x)
    assert torch.equal(back["pos"], whole["pos"])
    ok(f"gather_shard_identity {arch}")
torch.distributed.destroy_process_group()
'''

MARKERS = ([f"{m} {a} {mode}" for a in ARCHS for m in ("generate", "serve")
            for mode in ("armt", "cache")]
           + [f"{m} {a}" for a in ARCHS for m in (
               "prefix_cache", "session_2x2_to_1dev", "session_1dev_to_2x2",
               "scheduler_sessions", "gather_shard_identity", "sampled")]
           + [f"forward_vs_jax {a}" for a in ARCHS])


def _reference_npz(path: Path) -> None:
    """Each arch's params (the reference's, converted) and the reference's
    single-device hidden states of a 2-segment, B = 2 prompt, fp32."""
    out = {}
    jax.config.update("jax_default_matmul_precision", "highest")
    for arch in ARCHS:
        jc, tc = j_smoke(arch), t_smoke(arch)
        jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        for p, leaf in tree_flatten_with_path(tp):
            out[f"{arch}:{p}"] = leaf.numpy()
        toks = np.random.default_rng(3).integers(8, jc.vocab, (2, 2 * jc.armt.segment_len))
        jh, _ = jmodel.forward_hidden(jp, jc, jnp.asarray(toks), schedule="diagonal")
        out[f"{arch}:tokens"], out[f"{arch}:hidden"] = toks, np.asarray(jh)
    np.savez(path, **out)


def test_four_gloo_ranks_data2_model2(tmp_path):
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
