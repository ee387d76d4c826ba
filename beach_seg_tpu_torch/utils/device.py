"""Device resolution for the port's entry points, and constants kept on a
device.

The rule: an entry point runs on the CUDA device unless its caller asks for
the CPU. ``device=None`` means ``cuda``; with no CUDA device present that
raises instead of carrying on quietly on the CPU.

``device_constant`` keeps a tensor that depends only on shapes (a resize
matrix, a rel-pos index, the masked-position mask) on its device after its
first use: copying host data to the card blocks the host until the card's
queue has drained, so a forward that uploaded its constants on every call
would wait on the card once for each.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from beach_seg_tpu_torch.utils.profiling import tensor_from_host

# (host function, its arguments, indexed device) → the tensor on that device
_CONSTANTS: dict[tuple, torch.Tensor] = {}


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


def indexed_device(device: str | torch.device | None) -> torch.device:
    """``device`` with its index: ``cuda`` → ``cuda:<current device>``, so
    that both spellings name one card; ``None`` → the CPU."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_constant(host_fn: Callable, *args, device: str | torch.device | None) -> torch.Tensor:
    """``host_fn(*args)``, host data that depends only on ``args`` (sizes,
    a method name), as a tensor on ``device``. The first call for a
    (``host_fn``, ``args``, device) copies it there under
    :func:`tensor_from_host` (a ``bst.sync`` range while tracing); every
    later call returns that same tensor and neither launches nor waits.

    The tensor is shared by every caller in the process, so it is read-only
    by contract: no caller writes it in place. It is built outside inference
    mode and carries no autograd history, so autograd may save it for a
    backward whatever mode the first call ran in. Two threads that miss
    at once both copy, and the later of the two equal tensors stays."""
    dev = indexed_device(device)
    key = (host_fn, args, dev)
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = tensor_from_host(host_fn(*args), device=dev)
    return t
