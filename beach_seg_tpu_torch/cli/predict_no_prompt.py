"""Zero-shot ensemble inference CLI (ref src/predict_no_prompt.py):

    python -m beach_seg_tpu_torch.cli.predict_no_prompt data=/data/BorderField \
        prediction_root=/results checkpoint=/ckpts/seggpt.npz n_prompts=2

Several processes: ``torchrun --nproc_per_node=N -m beach_seg_tpu_torch.cli.predict_no_prompt ...
mesh_model=M`` (``parallel.distributed.maybe_initialize`` reads the launcher's
variables). ``platform=cpu`` runs on the CPU; otherwise on the card.
"""

from __future__ import annotations

import sys

from beach_seg_tpu_torch.config import PredConfig
from beach_seg_tpu_torch.infer.zero_shot import run_zero_shot
from beach_seg_tpu_torch.parallel.distributed import maybe_initialize
from beach_seg_tpu_torch.utils.confix import parse_cli


def main(argv: list[str] | None = None) -> None:
    conf = parse_cli(PredConfig, sys.argv[1:] if argv is None else argv)
    maybe_initialize(conf.world_size, conf.platform)
    print(run_zero_shot(conf))


if __name__ == "__main__":
    main()
