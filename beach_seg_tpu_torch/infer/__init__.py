from beach_seg_tpu_torch.infer.accumulator import VoteAccumulator, transform_line
from beach_seg_tpu_torch.infer.predict import resolve_config, run_predict

__all__ = ["VoteAccumulator", "resolve_config", "run_predict", "transform_line"]
