"""Training CLI (ref src/train.py): dotlist overrides, e.g.

    python -m beach_seg_tpu_torch.cli.train data=/data/BorderField epochs=4 \
        checkpoint=/ckpts/seggpt.npz compute_dtype=bfloat16

Several processes: ``torchrun --nproc_per_node=N -m beach_seg_tpu_torch.cli.train ...
mesh_model=M`` (``parallel.distributed.maybe_initialize`` reads the launcher's
variables). ``platform=cpu`` runs on the CPU; otherwise on the card.
"""

from __future__ import annotations

import sys

from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.parallel.distributed import maybe_initialize
from beach_seg_tpu_torch.train.loop import run_training
from beach_seg_tpu_torch.utils.confix import parse_cli


def main(argv: list[str] | None = None) -> None:
    conf = parse_cli(BeachSegConfig, sys.argv[1:] if argv is None else argv)
    maybe_initialize(conf.world_size, conf.platform)
    print(run_training(conf))


if __name__ == "__main__":
    main()
