"""The port's serve CLI (``python -m repro_torch.launch.serve``) at smoke
size on the CPU: every mode's tokens equal, to the bit, to
``ServeEngine.generate``/``serve`` called directly with params from the
same seed and the same prompts (single greedy and sampled, continuous
blocking, interleaved and fused, the prefix cache, a two-turn session
spilled to a store directory); the trace, metrics and profile outputs;
the ``--continuous`` requests equal, token for token, to the reference
CLI's (its engine replaced by a recorder); the refusals. And the port's
four examples, each run once with the fewest steps that reach every path."""
import importlib.util
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve import (PrefixCache, RequestError, ServeEngine,  # noqa: E402
                               SessionStore, validate_chrome_trace)
from repro_torch.utils import tree_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama-1b-armt"
BASE = ["--arch", ARCH, "--smoke", "--device", "cpu", "--prompt-len", "40", "--max-new", "6"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops (the suite runs in
    parallel workers); the count before is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The smoke config, params drawn from seed 0 as the CLI draws them, and
    the engine's max_len the CLI gives it for BASE."""
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, torch.Generator(device="cpu").manual_seed(0), device="cpu")
    seg = cfg.armt.segment_len
    return cfg, params, 40 + seg // 2 + 6, seg


def _engine(setup, **kw):
    cfg, params, max_len, _ = setup
    return ServeEngine(params, cfg, device="cpu", max_len=max_len, **kw)


def _streams(events):
    out = {}
    for ev in events:
        if not isinstance(ev, RequestError):
            out.setdefault(ev.req_id, []).append(ev.token)
    return out


@pytest.mark.parametrize("extra,sample", [([], None),
                                          (["--temperature", "0.8", "--top-k", "5",
                                            "--seed", "0"], (0.8, 5)),
                                          (["--schedule", "sequential", "--batch", "1"], None)])
def test_single_mode_equals_direct_generate(setup, extra, sample, capsys):
    res = cli.main(BASE + extra)
    cfg, params, _, _ = setup
    assert res["mode"] == "single" and res["n_params"] == tree_params(params)
    B = 1 if "--batch" in extra else 2
    want = np.random.default_rng(1).integers(8, cfg.vocab, (B, 40))
    assert np.array_equal(res["prompts"], want)
    eng = _engine(setup, schedule="sequential" if "sequential" in extra else "diagonal")
    kw = {} if sample is None else dict(temperature=sample[0], top_k=sample[1], seed=0)
    direct = eng.generate(want, 6, **kw)
    assert res["tokens"].shape == (B, 6) and res["finite"]
    assert np.array_equal(res["tokens"], direct.tokens)
    assert "generated (%d, 6) tokens" % B in capsys.readouterr().out


@pytest.mark.parametrize("extra,kw", [
    (["--prefill-groups-per-chunk", "0"], dict(prefill_groups_per_chunk=0)),
    ([], {}),
    (["--fused-admission", "--max-concurrent-admissions", "2"],
     dict(fused_admission=True, max_concurrent_admissions=2)),
])
def test_continuous_equals_direct_serve(setup, extra, kw):
    res = cli.main(BASE + ["--continuous", "--requests", "5", "--slots", "2",
                           "--chunk", "4"] + extra)
    assert res["mode"] == "continuous" and not res["errors"]
    assert [r.req_id for r in res["requests"]] == [f"r{i}" for i in range(5)]
    direct = _streams(_engine(setup).serve(res["requests"], n_slots=2, chunk=4, **kw))
    assert res["streams"] == direct
    assert all(len(v) == 6 for v in direct.values()) and res["n_tokens"] == 30


def test_prefix_cache_and_outputs(setup, tmp_path, capsys):
    """--prefix-cache with --trace-out (valid), --metrics, --metrics-out and
    --profile-dir: the streams equal a direct serve with a cache."""
    trace, metrics, prof = tmp_path / "t.json", tmp_path / "m.json", tmp_path / "prof"
    res = cli.main(BASE + ["--continuous", "--prefix-cache", "--requests", "4",
                           "--slots", "2", "--trace-out", str(trace), "--metrics",
                           "--metrics-out", str(metrics), "--profile-dir", str(prof)])
    _, _, _, seg = setup
    sys_prompt = res["requests"][0].prompt[:seg]
    assert all(np.array_equal(r.prompt[:seg], sys_prompt) for r in res["requests"])
    eng = _engine(setup, prefix_cache=PrefixCache(seg, max_bytes=64 << 20))
    assert res["streams"] == _streams(eng.serve(res["requests"], n_slots=2, chunk=8))
    st = res["prefix_cache"]
    assert st == eng.prefix_cache.stats.as_dict() and st["hits"] + st["misses"] > 0
    assert validate_chrome_trace(str(trace)) == []
    snap = json.loads(metrics.read_text())
    assert "program_counts" in snap and "prefix_cache" in snap
    out = capsys.readouterr().out
    assert "metrics:" in out and "prefix-cache:" in out
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    # the scheduler's and the engine's record_function spans are in the profile
    assert {"serve.decode_chunk", "serve.diag_stage"} <= names


def test_session_store_equals_direct_two_turns(setup, tmp_path):
    res = cli.main(BASE + ["--session-store", "--store-dir", str(tmp_path / "store"),
                           "--session-mb", "0.001"])
    assert res["mode"] == "session" and res["resumed"]
    eng = _engine(setup, session_store=SessionStore(max_bytes=1000,
                                                    spill_dir=str(tmp_path / "direct")))
    p1, p2 = res["prompts"]
    _, _, _, seg = setup
    assert p2.shape == (1, max(8, seg // 2))
    r1 = eng.generate(p1, 6, session_id="demo")
    r2 = eng.generate(p2, 6, session_id="demo")
    assert r2.resumed and eng.session_store.stats.spills > 0
    assert np.array_equal(res["tokens"][0], r1.tokens)
    assert np.array_equal(res["tokens"][1], r2.tokens)
    assert any((tmp_path / "store").iterdir())


class _Recorder:
    """Stands in for the reference's ServeEngine: its serve records the
    requests and yields nothing."""
    seen: list = []

    def __init__(self, *a, **kw):
        pass

    def serve(self, reqs, **kw):
        _Recorder.seen.append(list(reqs))
        return iter(())

    def metrics_snapshot(self):
        return {}


@pytest.mark.parametrize("prefix", [False, True])
def test_continuous_requests_equal_reference_cli(prefix, monkeypatch, capsys):
    import repro.serve
    from repro.launch import serve as jcli
    argv = ["--arch", ARCH, "--smoke", "--continuous", "--requests", "5", "--prompt-len",
            "40", "--max-new", "6", "--seed", "3"] + (["--prefix-cache"] if prefix else [])
    _Recorder.seen = []
    monkeypatch.setattr(repro.serve, "ServeEngine", _Recorder)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jcli.main()
    (ref,) = _Recorder.seen
    cfg = get_smoke_config(ARCH)
    mine = cli.continuous_requests(cfg, prompt_len=40, n_requests=5, max_new=6, seed=3,
                                   prefix_cache=prefix)
    assert [(r.req_id, r.max_new, r.prompt.dtype) for r in mine] == [
        (r.req_id, r.max_new, r.prompt.dtype) for r in ref]
    for a, b in zip(mine, ref):
        assert np.array_equal(a.prompt, b.prompt)
    # and the CLI serves exactly those
    res = cli.main(argv + ["--device", "cpu"])
    for a, b in zip(res["requests"], ref):
        assert a.req_id == b.req_id and np.array_equal(a.prompt, b.prompt)


def test_refusals(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--arch", "whisper-medium", "--smoke", "--device", "cpu"])
    assert e.value.code not in (0, None) and "enc_frames" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        cli.main(BASE + ["--continuous", "--temperature", "0.5"])
    assert e.value.code == 2
    assert "--temperature/--top-k apply to single-batch mode only" in capsys.readouterr().err


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart", ["--steps", "2"]),
    ("torch_compare_schedules", ["--arch", "jamba-1.5-large-398b", "--n-seg", "3"]),
    ("torch_long_context_inference", ["--prompt-len", "384", "--max-new", "4",
                                      "--batch", "1"]),
    ("torch_train_needle", ["--steps", "2", "--eval-batch", "4"]),
])
def test_examples_run(name, argv, tmp_path):
    if name == "torch_train_needle":
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    out = _example(name).main(argv + ["--device", "cpu"])
    if name == "torch_quickstart":
        # the fused cell's bands: on the CPU torch's batched matmul rounds a
        # band of another width differently (4 segments, fp32)
        assert out["max_diff"] < 1e-3 and out["tokens"].shape == (2, 8)
    elif name == "torch_compare_schedules":
        assert out["max_diff"] < 1e-5
        assert out["diagonal"]["steps"] == 3 + 8 - 1 and out["diagonal"]["minimal"]
        assert out["sequential"]["steps"] == 3 * 8 and not out["sequential"]["minimal"]
        assert out["diagonal"]["cells"] == out["sequential"]["cells"] == 24
    elif name == "torch_long_context_inference":
        assert np.array_equal(out["sequential"]["tokens"], out["diagonal"]["tokens"])
        assert out["kv_bytes"] > out["armt_bytes"] > 0
    else:
        assert out["last_step"] == 2 and len(out["accuracy"]) == 4
        assert any(tmp_path.iterdir())
