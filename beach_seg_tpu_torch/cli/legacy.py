"""Legacy ensemble inference CLI (ref src/old/beach_seg.py):

    python -m beach_seg_tpu_torch.cli.legacy data=/data/BorderField \
        prompt_ckpt=/results/.../prompt_batch_tuned.npz crop_size=224

Several processes: ``torchrun --nproc_per_node=N -m beach_seg_tpu_torch.cli.legacy ...
mesh_model=M`` (``parallel.distributed.maybe_initialize`` reads the launcher's
variables). ``platform=cpu`` runs on the CPU; otherwise on the card.
"""

from __future__ import annotations

import sys

from beach_seg_tpu_torch.config import LegacyConfig
from beach_seg_tpu_torch.infer.legacy import run_legacy
from beach_seg_tpu_torch.parallel.distributed import maybe_initialize
from beach_seg_tpu_torch.utils.confix import parse_cli


def main(argv: list[str] | None = None) -> None:
    conf = parse_cli(LegacyConfig, sys.argv[1:] if argv is None else argv)
    maybe_initialize(conf.world_size, conf.platform)
    print(run_legacy(conf))


if __name__ == "__main__":
    main()
