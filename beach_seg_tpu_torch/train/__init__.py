from beach_seg_tpu_torch.train.prompt_tuner import PromptState, PromptTuner

__all__ = ["PromptState", "PromptTuner"]
