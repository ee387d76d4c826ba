"""On-device vote accumulation (counterpart of
``beach_seg_tpu/infer/device_votes.py``): a whole batch of crops
scatter-adds its one-hot votes into a scene-sized (H, W, C) int32 counter on
the tensors' device, so the canvas crosses to the host once per date.
Vote positions outside the counter, negative ones included, are dropped
(the accumulator's clipping semantics), and int32 counters fix the
reference's uint8 wraparound.
"""

from __future__ import annotations

import torch


def scatter_votes(
    counter: torch.Tensor,  # (H, W, C) int32, updated in place
    one_hot: torch.Tensor,  # (B, cs, cs, C) int
    xmins: torch.Tensor,  # (B,) int — crop left edges (may be negative)
    ymins: torch.Tensor,  # (B,) int — crop top edges
    valid: torch.Tensor,  # (B,) bool — padded/skipped rows contribute nothing
) -> torch.Tensor:
    """Add each valid crop's votes at its position → ``counter``."""
    b, cs, _, c = one_hot.shape
    h, w = counter.shape[:2]
    dev = counter.device
    ar = torch.arange(cs, dtype=torch.int64, device=dev)
    iy = (ymins.to(dev, torch.int64)[:, None, None] + ar[None, :, None]).expand(b, cs, cs)
    ix = (xmins.to(dev, torch.int64)[:, None, None] + ar[None, None, :]).expand(b, cs, cs)
    keep = valid.to(dev)[:, None, None] & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    counter.index_put_((iy[keep], ix[keep]), one_hot.to(dev)[keep].to(torch.int32), accumulate=True)
    return counter


def zero_counter(out_shape: tuple[int, int], num_classes: int, device=None) -> torch.Tensor:
    return torch.zeros((*out_shape, num_classes), dtype=torch.int32, device=device)
