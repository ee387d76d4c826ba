"""Builds the port's CUDA sources (``ops/csrc/*.cu``) on first use.

Each source has a plain C interface and is compiled by ``nvcc`` into its own
shared library for ``sm_90a`` (device code that several sources share lives
in ``csrc/*.cuh``), then loaded with ``ctypes``: every pointer and
the stream pass as ``c_void_p``, every entry returns its ``cudaError_t``.
Libraries go into ``beach_seg_tpu_torch/_build/`` (git-ignored), named by a
hash of the source and the flags, so an edited source is rebuilt and a fresh
checkout builds from nothing. Importing this module builds nothing and needs
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# every source in csrc/, one shared library each
KERNELS = ("attn_qkv_rel", "ln_mlp", "attn_bwd", "ln_mlp_dx", "attn_packed", "attn_fused", "attn_qkv", "gemm_f32x3",
           "attn_qkv_rope", "swiglu_mlp")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# name → {"seconds": build wall time (0.0 when cached), "log": nvcc output}
build_info: dict[str, dict] = {}
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc from ``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then the
    toolkit's default install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _lib_path(name: str) -> Path:
    # the headers a source may include are hashed with it
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> dict[str, dict]:
    """Compile the named sources that have no library yet, all ``nvcc``
    processes at once; raise with the compiler output if any fails."""
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    for n in names:
        build_info.setdefault(n, {"seconds": 0.0, "log": ""})
    if not todo:
        return build_info
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for n, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        build_info[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return build_info


def load(name: str, prototypes: dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; declare each entry's
    argument types and an ``int`` (``cudaError_t``) return."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in prototypes.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
