"""The (data, model) device mesh and the tensor-parallel weight shards
(counterpart of ``beach_seg_tpu/parallel/mesh.py``).

One process runs per device; the mesh lays the ``torch.distributed`` ranks
out data-major, as the JAX package lays out its devices:

  - ``data``: splits the batch of crops (the reference's scaling unit);
    gradients, loss sums and confusion matrices are summed over it.
  - ``model``: tensor parallelism of the frozen backbone, Megatron's split:
    each rank holds whole heads of qkv and the matching rows of proj, a
    column block of lin1 and the rows of lin2, a column block of the
    decoder embed (``_TP_RULES``); ``ops.sharding`` holds the collectives.

Unlike the JAX package, whose explicit smaller mesh may use a prefix of the
devices, the mesh must cover every rank: with one process per device, a
rank outside the mesh would idle.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from beach_seg_tpu_torch.ops.sharding import DATA_AXIS, MODEL_AXIS, axis_rank, model_axis_size
from beach_seg_tpu_torch.parallel.distributed import host_batch_slice, process_count


def make_mesh(data: int = -1, model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over the process group's ranks, data-major;
    ``data=-1`` → ``world_size // model``. Without a process group (one
    process) it starts a one-rank gloo group in memory and returns the 1×1
    mesh. Raises unless ``data × model`` is the number of ranks."""
    n = process_count()
    if model < 1 or n % model:
        raise ValueError(f"mesh_model={model} does not divide the {n} ranks")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}×{model} must cover the {n} ranks (one process a device)")
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: DeviceMesh, global_batch: int) -> tuple[int, int]:
    """(start, size) of this rank's rows of a global batch."""
    return host_batch_slice(global_batch, mesh)


def replicated(mesh: DeviceMesh, tree: Any) -> Any:
    """Every rank holds the whole value: the identity."""
    return tree


def shard_batch(mesh: DeviceMesh, tree: dict) -> dict:
    """This rank's rows of a global batch dict (leading axis)."""
    lo, sz = batch_sharding(mesh, len(next(iter(tree.values()))))
    return {k: v[lo : lo + sz] for k, v in tree.items()}


def put_batch(mesh: DeviceMesh, tree: dict, device) -> dict:
    """This rank's rows of a batch (from ``iterate_batches(row_slice=…)``)
    as tensors on ``device``; list values (dates) stay on the host."""
    return {k: torch.as_tensor(v).to(device) if isinstance(v, np.ndarray) else v for k, v in tree.items()}


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of ``k`` ≥ ``n`` (batches must divide the data axis)."""
    return -(-n // k) * k


_TP_RULES: tuple[tuple[str, tuple], ...] = (
    # (parameter-name substring, partition spec) — first match wins; the rest
    # is replicated. Column-parallel qkv/lin1/embed, row-parallel proj/lin2.
    # qkv is (C, 3, C) with head-major output channels: splitting the last
    # dim gives each rank whole heads of q, k and v.
    ("qkv_kernel", (None, None, MODEL_AXIS)),
    ("qkv_bias", (None, MODEL_AXIS)),
    ("lin1_kernel", (None, MODEL_AXIS)),
    ("lin1_bias", (MODEL_AXIS,)),
    ("proj_kernel", (MODEL_AXIS, None)),
    ("lin2_kernel", (MODEL_AXIS, None)),
    ("embed_kernel", (None, MODEL_AXIS)),
    ("embed_bias", (MODEL_AXIS,)),
)


def tp_shard(state: dict[str, torch.Tensor], model_size: int, model_rank: int) -> dict[str, torch.Tensor]:
    """Rank ``model_rank``'s block of each parameter by ``_TP_RULES`` (the
    rest whole), for a model axis of ``model_size`` ranks."""
    out = {}
    for name, t in state.items():
        spec = next((s for needle, s in _TP_RULES if needle in name), None)
        if spec is None or model_size == 1:
            out[name] = t
            continue
        dim = spec.index(MODEL_AXIS)
        if t.shape[dim] % model_size:
            raise ValueError(f"{name} {tuple(t.shape)}: dim {dim} does not split over {model_size} model ranks")
        width = t.shape[dim] // model_size
        out[name] = t.narrow(dim, model_rank * width, width).contiguous()
    return out


def param_sharding(mesh: DeviceMesh, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """This rank's tensor-parallel shards of a SegGPT state dict; with
    model=1 the state itself."""
    return tp_shard(state, model_axis_size(mesh), axis_rank(mesh, MODEL_AXIS))


def shard_model(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Put ``model`` (a ``SegGPT``) on ``mesh``: swap each parameter for this
    rank's shard and hand every module that runs a collective the mesh.
    Raises where the model axis does not split the heads, and for the
    EVA-02 block on more than one model rank."""
    mp = model_axis_size(mesh)
    cfg = model.config
    heads = cfg.num_attention_heads
    if heads % mp:
        raise ValueError(f"mesh_model={mp} does not divide the {heads} attention heads")
    if mp > 1 and cfg.block != "vit":
        raise ValueError(f"mesh_model={mp}: tensor parallelism of the EVA-02 block is not supported")
    full = dict(model.named_parameters())
    for name, t in param_sharding(mesh, {k: v.detach() for k, v in full.items()}).items():
        if t.shape != full[name].shape:
            owner, leaf = name.rsplit(".", 1)
            setattr(model.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=False))
    for m in model.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    return model
