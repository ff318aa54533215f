"""Training on a mesh (``make_train_step(mesh=)``, ``train_loop(mesh=)``,
``shard_batch``, ZeRO-1, the collectives' gradients, ``launch.train
--distributed``) on the CPU over ``torch.distributed`` with gloo.

Four ranks, each a process of its own, spawned once for the module (a
FileStore under the module's tmp dir, ``OMP_NUM_THREADS=1``, a hard
timeout): the ranks run every scenario below in order and rank 0 prints
``OK <name>`` (or ``FAIL <name>``) once every rank has checked it; each
test waits for its own marker with a timeout of its own. The JAX
reference's single-device ``make_train_step`` (the smoke llama-1b-armt,
fp32, 2 segments, its params converted to the port) is computed in this
process while the ranks run their other scenarios, and handed to them as
``.npz``:

  * one step at ``data=2,model=2`` and at ``data=4``, two microbatches, a
    batch of one row on ``data=2,model=2`` (every data rank holds the row;
    the mask count summed over the axis counts it once), the needle
    task's loss mask: the loss, ``grad_norm`` and ``lr`` within 1e-5
    (relative) of the reference's; every new param within 1e-5 of the
    reference's (relative, the leaf's norm); every new moment within 1e-5
    of the reference's, relative to the norm of the reference's whole
    moment tree (``m``, ``v``): the gradient's scale. A leaf whose
    gradient cancels (the ARMT memory's ``wq``) moves ~2e-5 relative to
    its own norm under any change of summation order, the mesh-less
    step's microbatching included, and Adam's first step carries that to
    the params' elements with a near-zero gradient (lr * g / (|g| + eps)),
    so neither is held elementwise;
  * the same step at ``data=2,model=2`` against the port's mesh-less step
    for qwen2.5-32b (QKV biases cut over 'model', an untied head) and
    chameleon-34b (q/k norm weights read inside the split attention), at
    the same tolerances;
  * ZeRO-1 against the replicated optimizer (``zero1=False``) on the same
    mesh, ``data=2,model=2`` and ``data=4``: params and moments to the bit;
  * three ``train_loop(mesh=)`` steps against two, a checkpoint and one
    resumed: the losses and the final local state to the bit; the mesh
    checkpoint restores mesh-less (the whole state, to the bit) and a
    mesh-less loop resumes from it; a mesh-less checkpoint resumes on the
    mesh; only rank 0 writes ``metrics.jsonl``;
  * ``launch.train.main([... "--distributed", "--mesh", "data=2,model=2",
    "--smoke", "--device", "cpu"])`` ends with the in-process loop's loss
    (the ranks joined the group already: ``init_distributed`` keeps it);
  * each collective's gradient (``all_reduce``, ``enter``, ``all_gather``,
    ``broadcast``, over one axis and over two) against the whole
    computation's on one rank;
  * ``compressed_psum`` over the four ranks within 1e-6 of the sum of the
    reference's per-rank dequantized blocks, and within 0.02 (relative to
    the largest) of the exact sum, as the reference asserts.

In process: a one-rank mesh step equals the mesh-less step to the bit,
and the refusals (a 'stage' axis, ``fsdp=True``, MoE).
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import OptimConfig as JOptimConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim.compression import dequantize_int8 as j_dequantize  # noqa: E402
from repro.optim.compression import quantize_int8 as j_quantize  # noqa: E402
from repro.train.state import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import needle_qa  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import OptimConfig, adamw_init  # noqa: E402
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.state import train_specs  # noqa: E402
from repro_torch.utils import tree_flatten_with_path, tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama-1b-armt"
WORLD, B, N_TOK = 4, 4, 32          # 2 segments of 16
LR, TOL = 1e-3, 1e-5
SPAWN_S, WAIT_S = 240, 90           # the ranks' hard limit; a marker's own wait
JAX_CASES = ("data=2,model=2", "data=4", "microbatches=2", "replicated_b1", "needle_mask")
N_NUDGES = 3                        # the reference's own spread: steps from nudged params


def _jpaths(tree):
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return {"/".join(key(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reference(path: Path) -> None:
    """The reference's params (converted to the port's leaves), the batches
    and each case's step (jitted, the sequential schedule: the same
    function), and the compression case's per-rank dequantized blocks;
    written to ``path`` atomically."""
    jax.config.update("jax_default_matmul_precision", "highest")
    jc = j_smoke(ARCH)
    jp = jax.jit(lambda key: jmodel.init_params(jc, key))(jax.random.PRNGKey(0))
    out = {f"param:{p}": t.numpy() for p, t in tree_flatten_with_path(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"))}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab, (B, N_TOK + 1)).astype(np.int32)
    needle = next(needle_qa(jc.vocab, B, N_TOK, seed=3))
    batches = {"data=2,model=2": ({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 1),
               "microbatches=2": ({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 2),
               "replicated_b1": ({"tokens": toks[:1, :-1], "labels": toks[:1, 1:]}, 1),
               "needle_mask": ({k: needle[k] for k in ("tokens", "labels", "loss_mask")}, 1)}
    jocfg = JOptimConfig(lr=LR, warmup_steps=1, total_steps=10)
    leaves, tdef = jax.tree_util.tree_flatten(jp)
    nudged = []
    for n in range(N_NUDGES):
        noise = jax.random.split(jax.random.PRNGKey(1 + n), len(leaves))
        nudged.append(jax.tree_util.tree_unflatten(tdef, [
            l * (1 + 1e-7 * jax.random.normal(k, l.shape)) for l, k in zip(leaves, noise)]))
    for case, (batch, mb) in batches.items():
        step = jax.jit(j_make_train_step(jc, jocfg, schedule="sequential", microbatches=mb))
        for tag, p0 in [("", jp)] + [(f"nudged{n}_", q) for n, q in enumerate(nudged)]:
            state, metrics = step({"params": p0, "opt": j_adamw_init(p0, jocfg)}, batch)
            for p, v in _jpaths(state).items():
                out[f"{case}:{tag}state:{p}"] = v
            for k, v in metrics.items():
                out[f"{case}:{tag}metric:{k}"] = np.asarray(v)
        for k, v in batch.items():
            out[f"{case}:batch:{k}"] = np.asarray(v)
    xs = np.random.default_rng(5).standard_normal((WORLD, 8, 300)).astype(np.float32) * 3
    deq = [np.asarray(j_dequantize(*j_quantize(jnp.asarray(x)), x.shape[-1])) for x in xs]
    out["psum:x"], out["psum:deq_sum"] = xs, np.sum(deq, axis=0)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **out)
    os.replace(tmp, path)


_RANK_SCRIPT = r'''
import os, shutil, sys, time, traceback
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data import lm_stream, needle_qa, shard_batch
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import init_distributed, parse_mesh
from repro_torch.models import model as M
from repro_torch.optim import OptimConfig, adamw_init
from repro_torch.optim.compression import compressed_psum
from repro_torch.parallel import comm
from repro_torch.train import init_train_state, make_train_step, train_loop
from repro_torch.train.state import train_specs
from repro_torch.utils import tree_flatten_with_path, tree_leaves, tree_unflatten

rank, world, store, ref_path, work = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                      sys.argv[4], sys.argv[5])
init_distributed("gloo", store_path=store, rank=rank, world_size=world)
ARCH, B, N_TOK, LR, TOL = "llama-1b-armt", 4, 32, 1e-3, 1e-5
cfg = get_smoke_config(ARCH)
ocfg = OptimConfig(lr=LR, warmup_steps=1, total_steps=10)
meshes = {s: parse_mesh(s) for s in ("data=2,model=2", "data=4")}
mesh = meshes["data=2,model=2"]


def report(name, fn):
    """fn() -> (ok, detail) on every rank; OK/FAIL from rank 0 once all agree."""
    try:
        ok, detail = fn()
    except Exception:
        ok, detail = False, traceback.format_exc()
    if not ok:
        print(f"rank {rank} {name}: {detail}", flush=True)
    flag = torch.tensor([1 if ok else 0])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    if rank == 0:
        print(("OK " if flag.item() else "FAIL ") + name + " " + str(detail)[:400], flush=True)


def bits_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                                           else x, y.view(torch.int32)
                                           if y.dtype == torch.float32 else y)
        for x, y in zip(la, lb))


def start(params, m):
    """The whole state from params and zero moments, cut to this rank's view."""
    return comm.shard_tree({"params": params, "opt": adamw_init(params, ocfg)},
                           train_specs(cfg, ocfg, m), m)


def host_batch(rng, b=B):
    t = rng.integers(0, cfg.vocab, (b, N_TOK + 1))
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def flat(tree):
    return {p: t.double().numpy() for p, t in tree_flatten_with_path(tree)}


def compare(got, got_metrics, want, want_metrics):
    """The worst relative errors of a step's outcome ({path: array} and the
    metrics) against another's: the scalars each against itself, every
    leaf of params, m and v against the norm of its whole tree in
    ``want`` (the module's doc) -> (worst error, the three worst)."""
    errs = {k: abs(float(got_metrics[k]) - float(want_metrics[k])) / abs(float(want_metrics[k]))
            for k in ("loss", "grad_norm", "lr")}
    kind = lambda p: p.split("/")[1] if p.startswith("opt/") else "params"
    scale = {}
    for p, w in want.items():
        scale[kind(p)] = scale.get(kind(p), 0.0) + float(np.sum(np.square(w, dtype=np.float64)))
    for p, t in got.items():
        if p != "opt/step":
            errs[p] = float(np.linalg.norm(t - want[p])) / np.sqrt(scale[kind(p)])
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    return worst[0][1], worst[:3]


local = M.init_params(cfg, 0, device="cpu")


# -- the collectives' gradients against the whole computation ----------------
def collectives():
    out = []
    g = torch.Generator().manual_seed(11)
    xs = torch.randn(world, 3, 5, generator=g, dtype=torch.float64)
    w = torch.randn(3, 5, generator=g, dtype=torch.float64)
    for axes in ("model", ("data", "model")):
        n, me = mesh.count(axes), mesh.coord(axes)
        members = [mesh.rank_at(axes, i) for i in range(n)]
        tag = axes if isinstance(axes, str) else "+".join(axes)
        cases = {   # (this rank's computation of x, the whole one of the group's leaves)
            "all_reduce": (lambda x: (comm.all_reduce(x, mesh, axes).square() * w).sum(),
                           lambda ls: (sum(ls).square() * w).sum()),
            "all_gather": (lambda x: comm.all_gather(x, mesh, axes, 1).sin().sum(),
                           lambda ls: torch.cat(ls, 1).sin().sum()),
            "broadcast": (lambda x: (comm.broadcast(x, mesh, axes, 1).exp() * w).sum(),
                          lambda ls: (ls[1].exp() * w).sum()),
        }
        for name, (on_rank, whole) in cases.items():
            x = xs[rank].clone().requires_grad_()
            on_rank(x).backward()
            leaves = [xs[r].clone().requires_grad_() for r in members]
            whole(leaves).backward()
            want = leaves[me].grad
            want = torch.zeros_like(x) if want is None else want
            out.append((f"{name} {tag}", float((x.grad - want).abs().max())))
        # enter: a replicated x (the same on every rank of the group) entering a
        # split, each rank's term x^2 (w + r), the terms summed by an all-reduce
        x = xs[members[0]].clone().requires_grad_()
        comm.all_reduce((comm.enter(x, mesh, axes).square() * (w + me)).sum(),
                        mesh, axes).backward()
        leaf = xs[members[0]].clone().requires_grad_()
        sum((leaf.square() * (w + r)).sum() for r in range(n)).backward()
        out.append((f"enter {tag}", float((x.grad - leaf.grad).abs().max())))
    return max(e for _, e in out) <= 1e-12, out


report("collective_grads", collectives)


# -- ZeRO-1 against the replicated optimizer ----------------------------------
def zero1(spec):
    m = meshes[spec]
    batch = shard_batch(host_batch(np.random.default_rng(1)), m, "cpu")
    outs = []
    for z in (True, False):
        specs = train_specs(cfg, ocfg, m, zero1=z)
        st = comm.shard_tree({"params": local, "opt": adamw_init(local, ocfg)}, specs, m)
        new, met = make_train_step(cfg, ocfg, schedule="diagonal", mesh=m, zero1=z)(st, batch)
        outs.append((comm.gather_tree(new, specs, m), met, st))
    (a, ma, st), (b, mb, _) = outs
    kept = sum(x.numel() for x in tree_leaves(st["opt"]["m"]))
    return (bits_equal(a, b) and all(torch.equal(ma[k], mb[k]) for k in ma),
            f"m: {kept} of {sum(x.numel() for x in tree_leaves(local))} elements a rank")


for spec in meshes:
    report(f"zero1_bits {spec}", lambda: zero1(spec))


# -- the loop: resume, checkpoints both ways, the journal ---------------------
def loop(d, steps, m=mesh, **kw):
    return train_loop(cfg, ocfg, lm_stream(cfg.vocab, B, N_TOK, seed=0), steps=steps,
                      ckpt_dir=str(d), ckpt_every=100, schedule="diagonal", device="cpu",
                      seed=0, mesh=m, **kw)


def resume():
    d1, d2 = f"{work}/loop_a", f"{work}/loop_b"
    a = loop(d1, 3)
    loop(d2, 2)
    b = loop(d2, 3)
    lines = len(open(f"{d1}/metrics.jsonl").read().splitlines()) if rank == 0 else 3
    ok = (b["history"][0]["step"] == 2 and len(b["history"]) == 1
          and b["history"][0]["loss"] == a["history"][2]["loss"]
          and bits_equal(a["state"], b["state"]) and lines == 3)
    return ok, f"losses {[h['loss'] for h in a['history']]}, journal {lines} lines"


report("loop_resume_bits", resume)


def mesh_to_meshless():
    d1 = f"{work}/loop_a"
    whole = comm.gather_tree(loop(d1, 3)["state"], train_specs(cfg, ocfg, mesh), mesh)
    ok, detail = True, ""
    if rank == 0:
        like = init_train_state(cfg, ocfg, 0, device="cpu")
        restored = CheckpointManager(d1).restore(like, 3)
        shutil.copytree(d1, f"{work}/loop_c")
        more = loop(f"{work}/loop_c", 4, m=None)
        ok = bits_equal(restored, whole) and more["history"][0]["step"] == 3
        detail = f"mesh-less step 3 loss {more['history'][0]['loss']:.6f}"
    dist.barrier()
    return ok, detail


report("ckpt_mesh_to_meshless", mesh_to_meshless)


def meshless_to_mesh():
    d3 = f"{work}/loop_d"
    if rank == 0:
        loop(d3, 2, m=None)
    dist.barrier()
    b = loop(d3, 3)
    a = loop(f"{work}/loop_e", 3)
    la, lb = a["history"][2]["loss"], b["history"][0]["loss"]
    return (b["history"][0]["step"] == 2 and abs(la - lb) <= 1e-4 * abs(la),
            f"step 2 loss {lb:.6f} resumed, {la:.6f} on the mesh throughout")


report("ckpt_meshless_to_mesh", meshless_to_mesh)


# -- the CLI ------------------------------------------------------------------
def cli():
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq-len", "32", "--task", "lm", "--distributed", "--mesh", "data=2,model=2"]
    out = launch_train.main(argv)
    scfg = get_smoke_config(ARCH, seq_len=32)
    cocfg = OptimConfig(lr=3e-4, total_steps=2, warmup_steps=10)
    want = train_loop(scfg, cocfg, lm_stream(scfg.vocab, 4, 32, seed=0), steps=2,
                      schedule="auto", device="cpu", seed=0, mesh=parse_mesh("data=2,model=2"))
    a, b = out["history"][-1]["loss"], want["history"][-1]["loss"]
    return a == b, f"final loss {a} / {b}"


report("cli_distributed", cli)

# -- the reference's numbers (written by the parent meanwhile) ----------------
t0 = time.time()
while not os.path.exists(ref_path) and time.time() - t0 < 120:
    time.sleep(0.2)
ref = np.load(ref_path)


def psum():
    x = torch.from_numpy(ref["psum:x"][rank])
    got = compressed_psum(x, mesh, ("data", "model"))
    want, exact = ref["psum:deq_sum"], ref["psum:x"].sum(0)
    e1 = float(np.abs(got.numpy() - want).max())
    e2 = float(np.abs(got.numpy() - exact).max() / np.abs(exact).max())
    return e1 <= 1e-6 and e2 < 0.02, f"to the reference's blocks {e1:.2e}, to the sum {e2:.4f}"


report("compressed_psum", psum)

jparams = tree_unflatten(local, [torch.from_numpy(ref[f"param:{p}"])
                                 for p, _ in tree_flatten_with_path(local)])


def vs_jax(case):
    spec, key, mb = {"data=2,model=2": ("data=2,model=2", "data=2,model=2", 1),
                     "data=4": ("data=4", "data=2,model=2", 1),
                     "microbatches=2": ("data=2,model=2", "microbatches=2", 2),
                     "replicated_b1": ("data=2,model=2", "replicated_b1", 1),
                     "needle_mask": ("data=2,model=2", "needle_mask", 1)}[case]
    m = meshes[spec]
    host = {k.split(":")[2]: ref[k] for k in ref.files if k.startswith(f"{key}:batch:")}
    specs = train_specs(cfg, ocfg, m)
    new, met = make_train_step(cfg, ocfg, schedule="diagonal", mesh=m, microbatches=mb)(
        start(jparams, m), shard_batch(host, m, "cpu", microbatches=mb))
    def part(what):
        return {k.split(":", 2)[2]: ref[k].astype(np.float64) for k in ref.files
                if k.startswith(f"{key}:{what}:")}
    want, wm = part("state"), part("metric")
    # the reference's own spread: its steps from params nudged by 1e-7
    # (relative), against the step from its params
    spread = max(compare(part(f"nudged{n}_state"), part(f"nudged{n}_metric"), want, wm)[0]
                 for n in range(3))
    gate = max(TOL, 3 * spread)
    err, worst = compare(flat(comm.gather_tree(new, specs, m)), met, want, wm)
    return err <= gate and met["skipped"].item() == 0.0, (
        f"gate {gate:.2e} (the reference's spread {spread:.2e}), worst {worst}")


for case in ("data=2,model=2", "data=4", "microbatches=2", "replicated_b1", "needle_mask"):
    report(f"step_vs_jax {case}", lambda: vs_jax(case))


def vs_meshless(arch, m=mesh, needle=False):
    c = get_smoke_config(arch)
    p = M.init_params(c, 0, device="cpu")
    for blk in p["pattern"]:        # the reference's biases and q/k norms are not all ones/zeros
        for k in ("bq", "bk", "bv"):
            if k in blk["attn"]:
                blk["attn"][k].normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
        for k in ("qn", "kn"):
            if k in blk["attn"]:
                blk["attn"][k]["w"].uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(3))
    host = host_batch(np.random.default_rng(4))
    if needle:
        host = {k: v for k, v in next(needle_qa(c.vocab, B, N_TOK, seed=3)).items()
                if k != "answer"}
    state = {"params": p, "opt": adamw_init(p, ocfg)}
    ws, wm = make_train_step(c, ocfg, schedule="diagonal")(
        state, {k: torch.from_numpy(v) for k, v in host.items()})
    specs = train_specs(c, ocfg, m)
    new, met = make_train_step(c, ocfg, schedule="diagonal", mesh=m)(
        comm.shard_tree(state, specs, m), shard_batch(host, m, "cpu"))
    err, worst = compare(flat(comm.gather_tree(new, specs, m)), met, flat(ws), wm)
    return err <= TOL, worst


for arch in ("qwen2.5-32b", "chameleon-34b"):
    report(f"step_vs_meshless {arch}", lambda: vs_meshless(arch))
# the needle mask's count over data=4 (one row a rank), against the port's
# own mesh-less step: the same rounding of each row's memory update
report("step_vs_meshless needle_mask data=4",
       lambda: vs_meshless(ARCH, meshes["data=4"], needle=True))

dist.barrier()
if rank == 0:
    print("DONE", flush=True)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks, spawned once; the JAX reference written while they
    run their first scenarios. Yields wait(name) -> rank 0's line for the
    marker, failing with every rank's output on FAIL, an early exit or the
    wait's own timeout."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    script = tmp / "rank.py"
    script.write_text(textwrap.dedent(_RANK_SCRIPT))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    logs = [tmp / f"rank{r}.log" for r in range(WORLD)]
    files = [open(p, "w") for p in logs]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(WORLD),
                               str(tmp / "store"), str(tmp / "ref.npz"), str(tmp)],
                              stdout=f, stderr=subprocess.STDOUT, text=True, env=env)
             for r, f in enumerate(files)]
    t_start = time.time()
    _reference(tmp / "ref.npz")

    def report():
        return "\n".join(f"--- rank {r} ---\n{p.read_text()[-3000:]}"
                         for r, p in enumerate(logs))

    def wait(name, timeout=WAIT_S):
        t0 = time.time()
        while True:
            for line in logs[0].read_text().splitlines():
                if line.startswith(("OK ", "FAIL ")) and line.split(" ", 1)[1].startswith(
                        name + " ") or line in (f"OK {name}", f"FAIL {name}"):
                    assert line.startswith("OK "), report()
                    return line
            now = time.time()
            if (any(p.poll() not in (None, 0) for p in procs) or now - t0 > timeout
                    or now - t_start > SPAWN_S):
                raise AssertionError(f"no marker {name!r} (waited {now - t0:.0f} s)\n"
                                     + report())
            time.sleep(0.2)

    yield wait
    deadline = t_start + SPAWN_S
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in files:
        f.close()


def test_collective_gradients_match_the_whole_computation(ranks):
    print(ranks("collective_grads"))


@pytest.mark.parametrize("spec", ["data=2,model=2", "data=4"])
def test_zero1_equals_replicated_optimizer_to_the_bit(ranks, spec):
    print(ranks(f"zero1_bits {spec}"))


def test_mesh_loop_resumes_to_the_bit(ranks):
    print(ranks("loop_resume_bits"))


def test_mesh_checkpoint_restores_meshless(ranks):
    print(ranks("ckpt_mesh_to_meshless"))


def test_meshless_checkpoint_resumes_on_the_mesh(ranks):
    print(ranks("ckpt_meshless_to_mesh"))


def test_distributed_cli_matches_in_process_loop(ranks):
    print(ranks("cli_distributed"))


def test_compressed_psum_on_four_ranks(ranks):
    print(ranks("compressed_psum"))


@pytest.mark.parametrize("case", JAX_CASES)
def test_mesh_step_matches_reference(ranks, case):
    print(ranks(f"step_vs_jax {case}"))


@pytest.mark.parametrize("case", ["qwen2.5-32b", "chameleon-34b", "needle_mask data=4"])
def test_mesh_step_matches_meshless(ranks, case):
    print(ranks(f"step_vs_meshless {case}"))


# ---------------------------------------------------------------------------
# in process: one rank, and the refusals
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist
    tmesh.init_distributed("gloo", store_path=str(tmp_path / "store"), rank=0, world_size=1)
    yield tmesh.parse_mesh("data=1,model=1")
    dist.destroy_process_group()


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_one_rank_mesh_step_equals_meshless_to_the_bit(one_rank):
    """data=1,model=1: nothing is cut and every collective is the identity,
    so two steps (ZeRO-1 on, the batch through shard_batch) give the
    mesh-less steps' params, moments and metrics to the bit."""
    cfg = t_smoke(ARCH)
    ocfg = OptimConfig(lr=LR, warmup_steps=1, total_steps=10)
    params = tmodel.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    from repro_torch.data import shard_batch
    a = {"params": params, "opt": adamw_init(params, ocfg)}
    b = comm.shard_tree(a, train_specs(cfg, ocfg, one_rank), one_rank)
    plain = make_train_step(cfg, ocfg, schedule="diagonal")
    on_mesh = make_train_step(cfg, ocfg, schedule="diagonal", mesh=one_rank)
    for _ in range(2):
        t = rng.integers(0, cfg.vocab, (2, N_TOK + 1))
        host = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        a, ma = plain(a, {k: torch.from_numpy(v) for k, v in host.items()})
        b, mb = on_mesh(b, shard_batch(host, one_rank, "cpu"))
        assert all(torch.equal(_bits(ma[k]), _bits(mb[k])) for k in ma)
        assert all(torch.equal(_bits(x), _bits(y))
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_mesh_training_refusals(one_rank):
    """A 'stage' axis (the reference trains on none), fsdp=True (item 10)
    and a MoE config (item 8) are refused by name; so is gradients through
    a stage hand-off."""
    ocfg = OptimConfig()
    cfg = t_smoke(ARCH)
    with pytest.raises(ValueError, match="no stage axis"):
        make_train_step(cfg, ocfg, mesh=tmesh.AbstractMesh((1, 2), ("data", "stage")))
    with pytest.raises(ValueError, match="item 10"):
        make_train_step(cfg, ocfg, mesh=one_rank, fsdp=True)
    with pytest.raises(ValueError, match="item 8"):
        make_train_step(t_smoke("qwen2-moe-a2.7b"), ocfg, mesh=one_rank)
    two = tmesh.AbstractMesh((2,), ("stage",))
    two.backend = "gloo"
    with pytest.raises(ValueError, match="no 'stage'"):
        comm.stage_shift(torch.ones(2, requires_grad=True), two)
