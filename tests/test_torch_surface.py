"""The port's public surface against the JAX package's: every name a JAX
``__init__.py`` imports resolves in the port's counterpart package, every
JAX module has a port module of the same path, and every public function,
class and constant of a JAX module is in its port module, apart from the
absences listed below, each with its reason. The JAX side is read by AST,
so this needs no JAX device and imports no JAX module."""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "beach_seg_tpu"

# dotted paths under the package (a subpackage, a module, or module.name)
ABSENT = {
    "ops.pallas_attn": "TPU-only Pallas kernels: their CUDA counterparts are ops.cuda_attn, "
                       "the entry fused_attention is exported from ops",
    "ops.pallas_mlp": "TPU-only Pallas kernels: their CUDA counterparts are ops.cuda_mlp",
    "utils.profiling.enable_compilation_cache": "no XLA compilation cache to point at: the port compiles no "
                                                "programs at run time (its kernels are built once into _build/)",
}


def _dotted(path: Path) -> str:
    parts = path.relative_to(JAX_PKG).with_suffix("").parts
    return ".".join(p for p in parts if p != "__init__")


def _absent(dotted: str) -> bool:
    parts = dotted.split(".")
    return any(".".join(parts[:i]) in ABSENT for i in range(1, len(parts) + 1))


def _port(dotted: str):
    return importlib.import_module("beach_seg_tpu_torch" + (f".{dotted}" if dotted else ""))


JAX_MODULES = sorted(JAX_PKG.rglob("*.py"))
INITS = [p for p in JAX_MODULES if p.name == "__init__.py"]


def _init_names(path: Path) -> list[str]:
    """The names a package's __init__.py imports from its own package."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module and node.module.split(".")[0] == "beach_seg_tpu":
            names += [a.asname or a.name for a in node.names]
    return names


def _public(path: Path) -> list[str]:
    """Top-level public functions, classes and UPPER_CASE constants."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name) and t.id.isupper()]
    return [n for n in names if not n.startswith("_")]


def test_the_absences_name_real_jax_modules_and_names():
    """Each absence is something the JAX package has (no stale entries)."""
    modules = {_dotted(p) for p in JAX_MODULES}
    for dotted in ABSENT:
        if dotted not in modules:
            mod, name = dotted.rsplit(".", 1)
            assert mod in modules and name in _public(JAX_PKG / (mod.replace(".", "/") + ".py")), dotted


@pytest.mark.parametrize("init", INITS, ids=lambda p: _dotted(p) or "beach_seg_tpu")
def test_package_exports_resolve(init):
    dotted = _dotted(init)
    if _absent(dotted):  # a listed absence stays absent until its item lands
        with pytest.raises(ImportError):
            _port(dotted)
        return
    pkg = _port(dotted)
    missing = [n for n in _init_names(init) if not hasattr(pkg, n) and not _absent(f"{dotted}.{n}".strip("."))]
    assert not missing, f"beach_seg_tpu_torch.{dotted} lacks {missing}"


@pytest.mark.parametrize("path", [p for p in JAX_MODULES if p.name != "__init__.py"], ids=_dotted)
def test_module_and_its_public_names_exist(path):
    dotted = _dotted(path)
    if _absent(dotted):
        with pytest.raises(ImportError):
            _port(dotted)
        return
    mod = _port(dotted)
    missing = [n for n in _public(path) if not hasattr(mod, n) and not _absent(f"{dotted}.{n}")]
    assert not missing, f"beach_seg_tpu_torch.{dotted} lacks {missing}"


def test_the_top_level_exports_the_configs():
    import beach_seg_tpu_torch as port

    assert port.CLASSES == ("nodata", "sand", "water", "veg")
    assert {"BeachSegConfig", "PredictionConfig", "PredConfig", "LegacyConfig"} <= set(dir(port))
    doc = port.__doc__
    surface, absent = doc.split("Deliberately absent:")
    for dotted in ("parallel", "cli", "geo.notebook_utils", "ops.sharding"):
        assert f"beach_seg_tpu_torch.{dotted}" in surface, f"the package docstring does not list {dotted}"
        assert dotted not in absent, f"the package docstring still lists {dotted} as absent"
    for dotted in ABSENT:
        assert dotted.split(".")[-1] in absent, f"the package docstring does not list the absence of {dotted}"
