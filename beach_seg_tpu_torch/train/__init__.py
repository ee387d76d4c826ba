from beach_seg_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    load_prompt_batch,
    restore_state,
    save_prompt_batch,
    save_state,
)
from beach_seg_tpu_torch.train.loop import model_for_config, run_training
from beach_seg_tpu_torch.train.metrics import confusion_update, f1_from_confusion, iou_from_confusion
from beach_seg_tpu_torch.train.prompt_tuner import PromptState, PromptTuner, lr_schedule, make_optimizer

__all__ = [
    "PromptState",
    "PromptTuner",
    "confusion_update",
    "f1_from_confusion",
    "iou_from_confusion",
    "latest_checkpoint",
    "load_prompt_batch",
    "lr_schedule",
    "make_optimizer",
    "model_for_config",
    "restore_state",
    "run_training",
    "save_prompt_batch",
    "save_state",
]
