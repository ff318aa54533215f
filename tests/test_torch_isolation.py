"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points refuse to run anywhere but the card unless
the caller asks for the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"import jax|from jax|from repro\b|import repro\b")


def test_port_imports_without_jax_or_reference():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.serve, repro_torch.convert, repro_torch.kernels.ops\n"
            "import repro_torch.checkpoint, repro_torch.serve.state_store\n"
            "import repro_torch.serve.telemetry\n"
            "import repro_torch.models.model, repro_torch.configs.whisper_medium\n"
            "import repro_torch.train, repro_torch.optim, repro_torch.data\n"
            "import repro_torch.launch.train, repro_torch.core.rmt\n"
            "import repro_torch.launch.serve, repro_torch.roofline.model_math\n"
            "import repro_torch.utils\n"
            "import repro_torch.kernels.dispatch, repro_torch.kernels.autotune\n"
            "import repro_torch.launch.mesh, repro_torch.parallel.sharding\n"
            "import repro_torch.parallel.comm\n"
            "import repro_torch.optim.compression, repro_torch.data.loader\n"
            "import repro_torch.train.loop, repro_torch.train.state\n"
            "import importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('tune_kernels', "
            f"{str(ROOT / 'tools' / 'tune_kernels.py')!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules"
            " if sys.modules[m] is not None)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_source_names_jax_or_the_reference():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py"))
             + sorted((ROOT / "examples").glob("torch_*.py")))
    assert len(list((ROOT / "examples").glob("torch_*.py"))) == 4
    assert len(files) > 10
    offenders = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
                 for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if FORBIDDEN.search(line)]
    assert not offenders, offenders


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import Request, ServeEngine
    cfg = get_smoke_config("llama-1b-armt")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(params, cfg)
    engine = ServeEngine(params, cfg, device="cpu")
    assert engine.device.type == "cpu"
    # serve runs where its engine runs: the CPU only when the engine was
    # asked for it
    events = list(engine.serve([Request(0, np.arange(5), 3)], n_slots=1, chunk=2))
    assert [e.index for e in events] == [0, 1, 2] and events[-1].done
    # the falcon-mamba path: the same rule
    mcfg = get_smoke_config("falcon-mamba-7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(mcfg, 0)
    mparams = init_params(mcfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(mparams, mcfg, max_len=16)
    mengine = ServeEngine(mparams, mcfg, device="cpu", max_len=16)
    assert mengine.device.type == "cpu" and mengine.seg_len == 16
    events = list(mengine.serve([Request(0, np.arange(20), 3)], n_slots=1, chunk=2))
    assert [e.index for e in events] == [0, 1, 2] and events[-1].done
    # training: the state and the loop take the card unless asked for the CPU
    from repro_torch.data import lm_stream
    from repro_torch.optim import OptimConfig
    from repro_torch.train import init_train_state, train_loop
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg, OptimConfig(), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop(cfg, OptimConfig(), lm_stream(cfg.vocab, 1, 16), steps=1)
    assert init_train_state(cfg, OptimConfig(), 0, device="cpu")["params"]["embed"].device.type \
        == "cpu"
    # the serve CLI: the card unless --device cpu is given
    from repro_torch.launch import serve as launch_serve
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "llama-1b-armt", "--smoke"])
    # and the port's examples
    import importlib.util
    for path in sorted((ROOT / "examples").glob("torch_*.py")):
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])
