"""Multi-process start (counterpart of ``beach_seg_tpu/parallel/distributed.py``).

The port runs one process per device. ``maybe_initialize`` brings up
``torch.distributed`` when the caller asks for more than one process or a
launcher set its variables (``torchrun``: ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), the counterparts of the
TPU pod variables the JAX package reads. Data loading stays per process:
``host_batch_slice`` gives each data rank its rows of the global batch (ref
src/config.py:81-91, src/train.py:39-53).

Unlike the JAX package, which logs a failed start and carries on in one
process, a failed start raises here: a run that quietly uses one device of
several is a different run.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import torch
import torch.distributed as dist

from beach_seg_tpu_torch.ops.sharding import DATA_AXIS, axis_rank, axis_size
from beach_seg_tpu_torch.utils.logging import allocate_run_dir

logger = logging.getLogger(__name__)

LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def maybe_initialize(world_size: int = 1, platform: str = "", backend: str | None = None) -> None:
    """Start ``torch.distributed`` from the launcher's variables when
    ``world_size > 1`` or they are set; otherwise do nothing. ``backend``
    defaults to gloo for ``platform="cpu"`` and NCCL for the card (one card
    a rank); ranks that share a card pass ``backend="gloo"``. On the card
    each rank takes device ``LOCAL_RANK`` (modulo the cards present)."""
    if dist.is_initialized():
        return
    if world_size <= 1 and not any(v in os.environ for v in LAUNCHER_VARS):
        return
    env_world = int(os.environ.get("WORLD_SIZE", world_size))
    if world_size > 1 and env_world != world_size:
        raise ValueError(f"world_size={world_size}, but the launcher's WORLD_SIZE is {env_world}")
    if backend is None:
        backend = "gloo" if platform == "cpu" else "nccl"
    if platform != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass platform=cpu to run the ranks on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://")
    logger.info("torch.distributed up: rank %d of %d, %s", dist.get_rank(), dist.get_world_size(), backend)


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def host_batch_slice(global_batch: int, mesh=None) -> tuple[int, int]:
    """(start, size) of this rank's rows of a global batch, split over the
    data ranks of ``mesh`` (without a mesh, over every process)."""
    n = axis_size(mesh, DATA_AXIS) if mesh is not None else process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} data ranks")
    per = global_batch // n
    r = axis_rank(mesh, DATA_AXIS) if mesh is not None else process_index()
    return r * per, per


def shared_run_dir(root: Path, project: str, stage: str) -> Path:
    """Rank 0 allocates the next numbered run dir; the other ranks take the
    same one after a barrier (``utils.logging.allocate_run_dir``)."""
    rank = process_index()
    run_dir = allocate_run_dir(root, project, stage, 0) if rank == 0 else None
    barrier()
    return run_dir if run_dir is not None else allocate_run_dir(root, project, stage, rank)
