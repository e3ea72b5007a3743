"""Nothing under azbench/ imports JAX or the JAX package, and the reference
imports nothing of the program; module names are compared by their whole
top-level name (the program's name begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)
PROGRAM = "alphazero_reversi_tpu_torch"


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax(path):
    found = set(top_level_imports(path)) & set(harness.FORBIDDEN)
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert PROGRAM not in set(top_level_imports(path))


def test_the_check_compares_whole_names():
    assert "alphazero_reversi_tpu" in harness.FORBIDDEN
    assert PROGRAM.split(".")[0] not in harness.FORBIDDEN
