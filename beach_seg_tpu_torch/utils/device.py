"""Device resolution for the port's entry points.

The rule: an entry point runs on the CUDA device unless its caller asks for
the CPU. ``device=None`` means ``cuda``; with no CUDA device present that
raises instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def _exact_fp32() -> None:
    # The reference forces full-fp32 products where parity depends on them
    # (the PIL/cv2/torch resizes run at Precision.HIGHEST), and its fp32
    # decoder conv is exact fp32. On the card PyTorch would run fp32 convs
    # (and, if enabled, matmuls) in TF32, which keeps ~3 decimal digits, so
    # both are switched off. bf16 GEMMs keep fp32 accumulation as the TPU's
    # MXU does, so cuBLAS may not reduce split-K partials in bf16 either.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``. Raises when CUDA is asked for (or implied) and
    absent; sets the exact-fp32 backend flags on first CUDA use."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        _exact_fp32()
    return dev


def device_for_platform(platform: str) -> torch.device:
    """``BeachSegConfig.platform`` as the device rule: ``""`` or ``"gpu"``
    → CUDA (raising without it), ``"cpu"`` → the CPU, anything else
    raises."""
    if platform in ("", "gpu"):
        return resolve_device(None)
    if platform == "cpu":
        return resolve_device("cpu")
    raise ValueError(f"platform={platform!r}: the port takes '' or 'gpu' (the CUDA device) or 'cpu'")
