"""Run-dir + logger management (ref: src/util/util.py:5-35,
src/train.py:39-53).

``setup_logger`` writes to a per-run ``log.log`` plus console; ``allocate_run_dir``
reproduces the auto-numbered ``<root>/<project>/<stage>/00000`` run directories
with multi-process reuse (process index > 0 reuses the latest dir, matching the
reference's NODE_RANK behavior at src/train.py:39-53).
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path


def setup_logger(save_dir: Path, rank: int = 0, name: str = "beach_seg_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")

    save_dir.mkdir(parents=True, exist_ok=True)
    suffix = "" if rank == 0 else f".rank{rank}"
    fh = logging.FileHandler(save_dir / f"log{suffix}.log")
    fh.setFormatter(fmt)
    logger.addHandler(fh)

    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    return logger


def allocate_run_dir(root: Path, project: str, stage: str, process_index: int = 0) -> Path:
    """Next zero-padded numbered run dir; non-zero ranks reuse the latest."""
    base = root / project / stage
    base.mkdir(parents=True, exist_ok=True)
    existing = sorted(int(p.name) for p in base.iterdir() if p.is_dir() and p.name.isdigit())
    if process_index > 0:
        if not existing:
            raise RuntimeError(f"rank {process_index} found no run dir under {base}")
        run = base / f"{existing[-1]:05d}"
    else:
        nxt = (existing[-1] + 1) if existing else 0
        run = base / f"{nxt:05d}"
        run.mkdir(parents=True, exist_ok=True)
    return run
