"""Prompt-tuned inference CLI (ref src/predict.py):

    python -m beach_seg_tpu_torch.cli.predict data=/data/BorderField \
        train_run_dir=/results/beach_seg/train/00000 batch_size=8

Several processes: ``torchrun --nproc_per_node=N -m beach_seg_tpu_torch.cli.predict ...
mesh_model=M`` (``parallel.distributed.maybe_initialize`` reads the launcher's
variables). ``platform=cpu`` runs on the CPU; otherwise on the card.
"""

from __future__ import annotations

import sys

from beach_seg_tpu_torch.config import PredictionConfig
from beach_seg_tpu_torch.infer.predict import run_predict
from beach_seg_tpu_torch.parallel.distributed import maybe_initialize
from beach_seg_tpu_torch.utils.confix import parse_cli


def main(argv: list[str] | None = None) -> None:
    conf = parse_cli(PredictionConfig, sys.argv[1:] if argv is None else argv)
    maybe_initialize(conf.world_size, conf.platform)
    print(run_predict(conf))


if __name__ == "__main__":
    main()
