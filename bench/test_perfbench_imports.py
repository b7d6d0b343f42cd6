"""Nothing under bench/ imports JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is the port, ``repro`` the JAX package),
and the reference imports nothing of the port."""
import ast

import pytest

from bench.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted((ROOT / "bench").rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not (_imports(path) & FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "bench" / "reference").rglob("*.py"):
        names = _imports(path)
        assert "repro_torch" not in names and "bench" not in names, path


def test_the_check_compares_whole_names():
    from bench.harness import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.search",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["repro.search.serve", "jax.numpy", "flax",
                              "jaxlib"]) == ["flax", "jax", "jaxlib",
                                             "repro"]
