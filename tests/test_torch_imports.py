"""Package and device hygiene of the PyTorch port.

The port imports neither JAX nor the JAX package (it keeps its own copies
of what it needs), and its entry points refuse to run without a card
unless the caller asks for the CPU.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            text = arg.value if isinstance(arg, ast.Constant) else "".join(
                v.value for v in arg.values if isinstance(v, ast.Constant))
            yield text.split(".")[0], node.lineno


def test_port_imports_neither_jax_nor_the_jax_package():
    # the port's package, its chip smoke and its card scripts (the sweeps)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "scripts").glob("*.py"))
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f) if mod in FORBIDDEN]
    assert not bad, bad


def _run(args, **env):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=120,
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **env})


def test_serve_cli_without_a_card_fails_and_names_the_gpu():
    res = _run(["-m", "repro_torch.launch.serve", "--smoke", "--requests", "1"],
               CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "GPU" in res.stderr and "--device cpu" in res.stderr


def test_entry_points_default_to_cuda_and_raise_without_one(monkeypatch):
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.models import registry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("codeqwen1.5-7b", "mamba2-370m"):
        _, model = registry.load(arch, smoke=True)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            model.init_params(0, CascadeConfig(mode="serve_fp4"))
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        params_from_numpy({"w": [1.0]})


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without a card the chip smoke exits non-zero and prints no result;
    alone in a directory (without the port) it fails too."""
    res = _run([str(ROOT / "chip_smoke.py")], CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0 and '"ok": true' not in res.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0 and '"ok": true' not in res.stdout
