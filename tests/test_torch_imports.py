"""The port stands alone: no module of it, nor chip_smoke.py, imports JAX or
the JAX package, and chip_smoke.py fails without a card or without the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "painlessinferenceacceleration_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "painlessinferenceacceleration_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_every_kernel_source_is_built():
    from painlessinferenceacceleration_tpu_torch import _build

    assert sorted(_build.SOURCES) == sorted(p.stem for p in (PORT / "csrc").glob("*.cu"))


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    r = _run_smoke(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    r = _run_smoke(ROOT)
    assert r.returncode != 0 and r.stdout == ""
