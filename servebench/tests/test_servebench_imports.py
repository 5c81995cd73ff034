"""What the benchmark may import: nothing under ``servebench/`` imports JAX,
jaxlib, flax or the JAX package ``repro`` (top-level names compared whole:
``repro_torch`` is the port), and the reference imports nothing of the
port."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in _top_level_imports(path)
    assert _top_level_imports(path) <= {"__future__", "math", "typing", "torch", "servebench"}


def test_names_compare_whole():
    mod = ast.parse("import repro_torch.serve\nfrom repro_torch import ops\n")
    names = set()
    for node in ast.walk(mod):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names == {"repro_torch"} and "repro" not in names
