from beach_seg_tpu_torch.train.prompt_tuner import PromptTuner

__all__ = ["PromptTuner"]
