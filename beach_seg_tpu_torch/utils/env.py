"""Environment knobs and a minimal .env loader (counterpart of
``beach_seg_tpu/utils/env.py``, kept as its own copy: the port imports
nothing of the JAX package; ref base.env + src/train.py:128-130
``load_dotenv(find_dotenv())``)."""

from __future__ import annotations

import os
from pathlib import Path


def env_flag(name: str) -> bool:
    """Parse a boolean env knob: unset or "0" is off, anything else is on.

    Single source of truth for the BEACH_SEG_TPU_* feature flags so sites
    that must agree cannot drift apart in how they parse the value.
    """
    return os.environ.get(name, "") not in ("", "0")


def find_dotenv(start: Path | None = None, name: str = ".env") -> Path | None:
    """Walk up from ``start`` (cwd) until a ``.env`` file is found."""
    d = Path(start or os.getcwd()).resolve()
    for parent in [d, *d.parents]:
        candidate = parent / name
        if candidate.is_file():
            return candidate
    return None


def load_dotenv(path: Path | str | None = None, override: bool = False) -> bool:
    """Load KEY=VALUE lines into os.environ. Returns True if a file loaded."""
    p = Path(path) if path else find_dotenv()
    if p is None or not Path(p).is_file():
        return False
    for line in Path(p).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip().strip("'\"")
        if override or key not in os.environ:
            os.environ[key] = value
    return True
