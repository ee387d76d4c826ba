"""The port's import boundary: no module of beach_seg_tpu_torch, not
chip_smoke.py and not the port's scripts (scripts/*torch*.py) import jax,
flax, optax or beach_seg_tpu, and no C++ or CUDA source of the port
includes a file of the JAX package. The scene engine also imports on a host
without PyYAML."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "beach_seg_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "beach_seg_tpu")

_BLOCKER = """
import importlib, pkgutil, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Blocker())
"""

_IMPORT_ALL = _BLOCKER.format(blocked=BLOCKED) + """
import beach_seg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(beach_seg_tpu_torch.__path__, "beach_seg_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(" ".join(names))
"""

# the subpackages and modules of the scene engines' slices
ENGINE_MODULES = {
    "beach_seg_tpu_torch.infer.zero_shot", "beach_seg_tpu_torch.infer.legacy", "beach_seg_tpu_torch.infer.processor",
    "beach_seg_tpu_torch.infer.device_votes", "beach_seg_tpu_torch.geo.line_metrics",
    "beach_seg_tpu_torch.geo", "beach_seg_tpu_torch.geo.tiff", "beach_seg_tpu_torch.geo.mosaic",
    "beach_seg_tpu_torch.native", "beach_seg_tpu_torch.native.build", "beach_seg_tpu_torch.data",
    "beach_seg_tpu_torch.data.dataset", "beach_seg_tpu_torch.data.prefetch", "beach_seg_tpu_torch.infer",
    "beach_seg_tpu_torch.infer.accumulator", "beach_seg_tpu_torch.infer.predict", "beach_seg_tpu_torch.utils.confix",
    "beach_seg_tpu_torch.utils.logging", "beach_seg_tpu_torch.models.seggpt.load", "beach_seg_tpu_torch.train.checkpoint",
}

# the modules of the training runtime's slice
TRAINING_MODULES = {
    "beach_seg_tpu_torch.train.loop", "beach_seg_tpu_torch.train.loggers", "beach_seg_tpu_torch.train.checkpoint",
    "beach_seg_tpu_torch.utils.profiling", "beach_seg_tpu_torch.utils.env",
}


# the modules of the last slice: multi-GPU, the CLIs, the notebook helpers
LAST_SLICE_MODULES = {
    "beach_seg_tpu_torch.parallel", "beach_seg_tpu_torch.parallel.mesh", "beach_seg_tpu_torch.parallel.distributed",
    "beach_seg_tpu_torch.ops.sharding", "beach_seg_tpu_torch.geo.notebook_utils", "beach_seg_tpu_torch.cli",
    *(f"beach_seg_tpu_torch.cli.{name}" for name in
      ("train", "predict", "predict_no_prompt", "legacy", "compare", "convert_checkpoint")),
}


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


def test_port_imports_with_jax_blocked():
    res = _run(_IMPORT_ALL)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 64  # every module of the package was imported
    assert ENGINE_MODULES <= names and TRAINING_MODULES <= names and LAST_SLICE_MODULES <= names


def test_engine_imports_without_pyyaml():
    """confix imports yaml only where it reads or writes YAML."""
    res = _run(_BLOCKER.format(blocked=(*BLOCKED, "yaml")) + "import beach_seg_tpu_torch.infer.predict\n")
    assert res.returncode == 0, res.stderr


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


SCANNED = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + SCRIPTS


def test_native_build_is_scanned():
    assert PORT / "native" / "build.py" in SCANNED


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statements(path):
    assert not _imported_roots(path) & set(BLOCKED)


NATIVE_SOURCES = sorted([*PORT.rglob("*.cc"), *PORT.rglob("*.cu"), *PORT.rglob("*.cuh")])


@pytest.mark.parametrize("path", NATIVE_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_native_sources_include_nothing_of_the_jax_package(path):
    includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', path.read_text(), flags=re.M)
    assert includes  # the pattern reads this file's includes
    assert not [i for i in includes if re.search(r"(^|/)beach_seg_tpu/", i)], includes


def test_native_sources_are_scanned():
    names = {p.name for p in NATIVE_SOURCES}
    assert {"tiffio.cc", "geom.cc", "attn_qkv_rel.cu", "ln_mlp.cu", "gemm_sm90.cuh"} <= names
