"""Nothing under portbench/ imports JAX or the JAX package, compared by
whole top-level names (the port's `repro_torch` begins with `repro`), and
the reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
STDLIB_AND_NUMPY = {"__future__", "contextlib", "heapq", "pickle",
                    "select", "struct", "subprocess", "sys", "pathlib",
                    "numpy"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def test_the_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import repro.core\nfrom jax import numpy\n")
    assert _imports(bad) & FORBIDDEN == {"repro", "jax"}
    ok = tmp_path / "ok.py"
    ok.write_text("import repro_torch.core\n")
    assert not _imports(ok) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    assert _imports(HERE / "reference.py") <= STDLIB_AND_NUMPY
