"""Collectives over the port's (data, model) mesh (counterpart of
``beach_seg_tpu/ops/sharding.py``).

The JAX package runs one program over every chip: GSPMD partitions it from
sharding annotations and ``shard_map`` islands wrap the Pallas kernels. The
port runs one process per device (``torch.distributed``), so each rank runs
the program on its own rows and its own weight shards, and the collectives
are written out here:

- the data axis: ``data_sharded_call`` runs a function on this rank's rows
  of a batch every rank holds whole and all-gathers the outputs (the
  engines); ``data_sum`` makes a loss's sums global (the train step).
- the model axis, Megatron's tensor parallelism: ``copy_to_model`` (f) at
  the input of a column-parallel product, ``reduce_from_model`` (g) at the
  output of a row-parallel one, ``gather_from_model`` after a
  column-parallel product whose full output the next op needs.

Every function takes the mesh (``parallel.mesh.make_mesh``; ``None`` is one
device) and is the identity, with no collective, where the axis it uses has
one rank. The collectives take the tensors on their own device: NCCL where
each rank has a card of its own, gloo on the CPU or where ranks share a card.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def axis_size(mesh, name: str) -> int:
    """Ranks along ``name`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (0 without a mesh)."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


def model_axis_size(mesh=None) -> int:
    """Size of ``mesh``'s model axis: the tensor-parallel degree."""
    return axis_size(mesh, MODEL_AXIS)


def _all_reduce(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.get_group(name))
    return out


def _all_gather(x: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, name))]
    dist.all_gather(parts, x, group=mesh.get_group(name))
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.width = mesh, dim, x.shape[dim]
        return _all_gather(x, mesh, MODEL_AXIS, dim)

    @staticmethod
    def backward(ctx, g):
        start = axis_rank(ctx.mesh, MODEL_AXIS) * ctx.width
        return g.narrow(ctx.dim, start, ctx.width), None, None


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh, DATA_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's f: the identity forward, an all-reduce over the model axis
    backward. Put it where a replicated activation enters a column-parallel
    product, so its gradient sums every rank's part."""
    return x if model_axis_size(mesh) == 1 else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's g: an all-reduce over the model axis forward, the identity
    backward (the gradient of a replicated output is the same on every rank).
    ``torch.distributed.nn.functional.all_reduce`` would all-reduce the
    gradient again and multiply it by the axis size."""
    return x if model_axis_size(mesh) == 1 else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The ranks' column blocks of a column-parallel output concatenated
    along ``dim`` in rank order; backward, this rank's block of the
    (replicated) gradient."""
    if model_axis_size(mesh) == 1:
        return x
    return _GatherFromModel.apply(x, mesh, dim % x.ndim)


def data_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the data ranks, with the identity backward: a
    loss divides global sums, every rank holds the same loss, and each
    rank's gradient is then its own rows' share of the global gradient
    (``PromptTuner`` sums the shares)."""
    return x if axis_size(mesh, DATA_AXIS) == 1 else _DataSum.apply(x, mesh)


def all_reduce_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the data ranks (no autograd)."""
    return x if axis_size(mesh, DATA_AXIS) == 1 else _all_reduce(x, mesh, DATA_AXIS)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's rows of ``x``, concatenated in rank order (equal
    row counts on every rank)."""
    return x if axis_size(mesh, DATA_AXIS) == 1 else _all_gather(x, mesh, DATA_AXIS, 0)


def data_sharded_call(
    fn: Callable,
    args: Sequence,
    batched: Sequence[bool],
    mesh,
    out_batched: bool = True,
    batch_unit: int = 1,
):
    """``fn(*args)`` with the batched operands' rows split over the data
    ranks: every rank passes the whole batch, runs ``fn`` on its own rows
    and gets every rank's output rows back, gathered in order.

    ``batched[i]`` marks operands whose dim 0 is ``batch * unit_i``; the
    rest go to ``fn`` whole. ``batch_unit`` is the unit of the smallest
    batched dim 0 (e.g. ``num_heads`` for (B·H, …) operands), so a rank's
    share never cuts through one batch element. A batch that does not
    divide the data ranks is padded with zero rows, in whole batch
    elements, and the outputs are sliced back. ``fn`` returns a tensor or a
    tuple of tensors whose dim 0 is a multiple of the batch
    (``out_batched``), or outputs the same on every rank."""
    n = axis_size(mesh, DATA_AXIS)
    sizes = sorted({a.shape[0] for a, b in zip(args, batched) if b})
    if n == 1 or not sizes:
        return fn(*args)
    b = sizes[0] // batch_unit  # the logical batch
    if b * batch_unit != sizes[0] or any(s % b for s in sizes):
        raise ValueError(f"batched dim 0s {sizes} are not multiples of one batch (batch_unit={batch_unit})")
    pb = -(-b // n) * n  # the padded batch
    per = pb // n
    r = axis_rank(mesh, DATA_AXIS)

    def local(a, is_batched):
        if not is_batched:
            return a
        unit = a.shape[0] // b
        if pb != b:
            a = torch.cat([a, a.new_zeros(((pb - b) * unit, *a.shape[1:]))])
        return a[r * per * unit : (r + 1) * per * unit]

    out = fn(*(local(a, isb) for a, isb in zip(args, batched)))
    if not out_batched:
        return out

    def whole(o):
        o = gather_rows(o, mesh)
        return o[: o.shape[0] // pb * b] if pb != b else o

    return tuple(whole(o) for o in out) if isinstance(out, tuple) else whole(out)
