"""The port's import boundary: no module of beach_seg_tpu_torch, not
chip_smoke.py and not the port's scripts (scripts/*torch*.py) import jax,
flax, optax or beach_seg_tpu."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "beach_seg_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "beach_seg_tpu")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Blocker())
import beach_seg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(beach_seg_tpu_torch.__path__, "beach_seg_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names))
"""


def test_port_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15  # every module of the package was imported


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


SCRIPTS = sorted((ROOT / "scripts").glob("*torch*.py"))


def test_port_scripts_are_scanned():
    names = {p.name for p in SCRIPTS}
    assert {"bench_torch_parts.py", "bench_torch_attn_parts.py", "ablate_torch_kernels.py", "profile_torch_predict.py"} <= names


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + SCRIPTS, ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_forbidden_import_statements(path):
    assert not _imported_roots(path) & set(BLOCKED)
