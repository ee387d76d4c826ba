from beach_seg_tpu_torch.infer.accumulator import VoteAccumulator, transform_line
from beach_seg_tpu_torch.infer.legacy import run_legacy
from beach_seg_tpu_torch.infer.predict import resolve_config, run_predict
from beach_seg_tpu_torch.infer.zero_shot import run_zero_shot

__all__ = ["VoteAccumulator", "resolve_config", "run_legacy", "run_predict", "run_zero_shot", "transform_line"]
