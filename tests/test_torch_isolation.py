"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package ``repro``,
and each imports nothing but torch, numpy, the standard library and
``repro_torch`` (the machine with the card has no ``ml_dtypes``)."""
import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")
ALLOWED = {"torch", "numpy", "repro_torch", "__future__"}


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_only_torch_numpy_and_stdlib(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] not in ALLOWED
           and m.split(".")[0] not in sys.stdlib_module_names]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_allowed_list_refuses_ml_dtypes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nimport ml_dtypes\n")
    assert [m for m in _imported_modules(bad)
            if m not in ALLOWED and m not in sys.stdlib_module_names] == [
                "ml_dtypes"]
