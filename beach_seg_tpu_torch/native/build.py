"""Build/load the native host-I/O library (tiffio.cc + geom.cc), the port's
copy of ``beach_seg_tpu/native/build.py``.

The library is compiled with ``g++ -O2`` (linking zlib) on first use into
``beach_seg_tpu_torch/_build/`` (git-ignored), named by a hash of the sources
and the flags, so an edited source is rebuilt and a fresh checkout builds from
nothing. The compiler writes to a per-process temporary file that is renamed
into place, so processes that build at once (the spawn-context mosaic pool)
cannot load a half-written library. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = _NATIVE_DIR.parent / "_build"
_SOURCES = ("tiffio.cc", "geom.cc")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_handle: ctypes.CDLL | None = None
_lock = threading.Lock()


def lib_path() -> Path:
    digest = hashlib.sha1(
        b"".join((_NATIVE_DIR / s).read_bytes() for s in _SOURCES) + " ".join(_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"libbstnative-{digest}.so"


def build() -> Path:
    out = lib_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), *(str(_NATIVE_DIR / s) for s in _SOURCES), "-lz"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed: {' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Load (building if absent). Set BEACH_SEG_TPU_NO_NATIVE=1 to force the
    NumPy fallbacks in geo/rasterize.py and geo/contours.py (the TIFF codec
    has no fallback and always requires the native library)."""
    global _handle
    if os.environ.get("BEACH_SEG_TPU_NO_NATIVE"):
        raise RuntimeError("native library disabled via BEACH_SEG_TPU_NO_NATIVE")
    with _lock:
        if _handle is None:
            path = lib_path()
            if not path.exists():
                build()
            _handle = ctypes.CDLL(str(path))
    return _handle
