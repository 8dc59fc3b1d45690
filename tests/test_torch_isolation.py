"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package ``repro``,
and each imports nothing but torch, numpy, the standard library and
``repro_torch`` (the machine with the card has no ``ml_dtypes``).  A
module imported by name from a string (the registry's lazy runners) is
caught by a scan of the string constants, and ``python -m
repro_torch.launch run simulate`` is run to list what it really
imports."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")
ALLOWED = {"torch", "numpy", "repro_torch", "__future__"}
# a string that is a dotted module path of the JAX package
REPRO_MODULE = re.compile(r"(jax|jaxlib|repro)(\.[A-Za-z_]\w*)+")


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


def _repro_module_strings(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and REPRO_MODULE.fullmatch(node.value.strip())]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_string_names_a_jax_or_repro_module(path):
    bad = _repro_module_strings(path)
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_the_string_scan_catches_a_lazy_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text('import importlib\n'
                   'LAZY = {"train": "repro.api.runners.train"}\n'
                   'importlib.import_module(LAZY["train"])\n'
                   'DOC = "a repro.api spec, in prose"\n')
    assert _repro_module_strings(bad) == ["repro.api.runners.train"]


def test_run_simulate_imports_no_jax_no_repro_and_no_torch(tmp_path):
    """``-X importtime`` lists every module the command imports, to the
    end of the run."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "repro_torch.launch",
         "run", "simulate", "--campaign", "deforestation",
         "--workdir", str(tmp_path)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    mods = {line.rsplit("|", 1)[1].strip() for line in
            proc.stderr.splitlines() if line.startswith("import time:")}
    assert "repro_torch.api.runners.simulate" in mods
    top = {m.split(".")[0] for m in mods}
    assert not top & {"jax", "jaxlib", "repro", "torch"}, sorted(
        m for m in mods if m.split(".")[0] in ("jax", "repro", "torch"))
