"""CLI entry points: train, predict, predict_no_prompt, legacy, compare,
convert_checkpoint — all invoked as ``python -m beach_seg_tpu_torch.cli.<name>``
(under ``torchrun`` for several processes)."""
