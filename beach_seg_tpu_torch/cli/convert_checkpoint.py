"""Convert an HF torch SegGPT checkpoint to the framework's npz format (the
JAX package's, which both packages load).

    python -m beach_seg_tpu_torch.cli.convert_checkpoint <src> <dst.npz>

``src``: a local HF checkpoint directory (model.safetensors /
pytorch_model.bin) or a hub id (network required).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    src, dst = sys.argv[1], Path(sys.argv[2])

    from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig
    from beach_seg_tpu_torch.models.seggpt.convert import convert_torch_state_dict, save_params
    from beach_seg_tpu_torch.models.seggpt.load import _torch_state_dict

    cfg = SegGPTConfig()
    path = Path(src)
    if path.is_dir():
        sd = _torch_state_dict(path)
    else:
        from transformers.models.seggpt.modeling_seggpt import SegGptForImageSegmentation

        sd = SegGptForImageSegmentation.from_pretrained(src).state_dict()
    params = convert_torch_state_dict(sd, cfg)
    save_params(params, dst)
    n = sum(np.asarray(v).size for v in _flat(params))
    print(f"wrote {dst} ({n/1e6:.1f}M params)")


def _flat(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _flat(v)
        else:
            yield v


if __name__ == "__main__":
    main()
