"""The port stands alone: nothing under ``src/repro_torch/`` (nor
``chip_smoke.py``, nor the port's examples ``examples/torch_*.py``)
imports ``jax``, the JAX package ``repro``, or ``msgpack`` and
``ml_dtypes`` (which the machine with the card does not have: the port's
checkpoints carry their own codec), and its entry points run on the card
unless the caller asks for the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


def _sources():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) >= 2
    return files + examples + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imported(ast.parse(path.read_text())):
        assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_importing_every_module_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (f"import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            f"assert not bad, bad\n"
            f"print(len({mods!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == len(mods)


def test_serving_engine_defaults_to_cuda():
    from repro_torch.configs import get_config
    from repro_torch.serving import ServingEngine
    cfg = get_config("llama3-8b").reduced()
    if torch.cuda.is_available():
        eng = ServingEngine(cfg, batch_size=1, max_len=8)
        assert eng.frozen["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            ServingEngine(cfg, batch_size=1, max_len=8)


def test_serve_cli_defaults_to_cuda():
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        serve.main(["--steps", "1", "--batch", "2", "--cache-len", "8"])
    else:
        with pytest.raises(RuntimeError):
            serve.main(["--steps", "1"])


def test_population_telemetry_and_analysis_modules_are_checked():
    """The populations, telemetry's export and sinks, and the report are
    among the sources the checks above walk (and import)."""
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"population/__init__.py", "population/registry.py",
            "population/sampler.py", "population/runtime.py",
            "telemetry/export.py", "telemetry/sinks.py",
            "analysis/__init__.py",
            "analysis/telemetry_report.py"} <= names
