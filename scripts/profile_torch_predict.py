"""Where the time of the torch port's predict step (or train step) goes, on
one CUDA card.

    python3 scripts/profile_torch_predict.py [--backbone large|huge] [--dtype bfloat16|float32] [--batch 8] [--calls 3] [--train]

Builds the backbone at full width and depth (``train.loop.model_for_config``:
ViT-L, or ViT-H with ``--backbone huge``; seeded random weights, bf16, or
fp32 with ``--dtype float32``, the default BeachSegConfig's compute dtype),
warms ``PromptTuner.predict_step`` up on B uint8 112×112 crops (with
``--train``: ``PromptTuner.train_step`` on B 448×448 tiles, as
chip_smoke.py drives it), then traces ``--calls`` calls with
``torch.profiler``. Prints the card, the host seconds per call, the
device-busy share of the traced window, and the device time per kernel name
(top 25) as JSON lines. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", choices=("large", "huge"), default="large")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16", help="BeachSegConfig.compute_dtype")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--train", action="store_true", help="profile train_step instead of predict_step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_predict: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.train import PromptTuner
    from beach_seg_tpu_torch.train.loop import model_for_config

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    conf = BeachSegConfig(batch_size=args.batch, backbone=args.backbone, compute_dtype=args.dtype)
    model, cfg = model_for_config(conf, device="cuda", seed=0)
    tuner = PromptTuner(model, conf, device="cuda")
    if args.train:
        prompts, batches = chip_smoke.train_path_inputs(conf, 4, 1)
        state = tuner.init_state(prompts[0])
        gen = torch.Generator(device="cuda").manual_seed(0)

        def call():
            tuner.train_step(state, prompts[1], prompts[2], batches[0], generator=gen)
    else:
        prompts, batches = chip_smoke.main_path_inputs(conf, 4, 1)

        def call():
            tuner.predict_step(*prompts, batches[0], out_size=conf.crop_size)

    for _ in range(2):  # warm-up: kernel builds, cuBLAS/cuDNN plans
        call()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.calls):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # device activities only: operator entries (aten::…, the autograd
        # Functions' ranges) repeat their kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    step = "train_step" if args.train else "predict_step"
    print(json.dumps({"card": card, "step": step, "backbone": args.backbone, "dtype": args.dtype, "batch": args.batch,
                      "layers": cfg.num_hidden_layers, "calls": args.calls}))
    print(json.dumps({
        "host_s_per_call": wall / args.calls,
        "device_busy_ms_per_call": busy_us / 1e3 / args.calls,
        "device_busy_share": busy_us / 1e6 / wall,
    }))
    for dev_us, key, count in rows[:25]:
        print(json.dumps({"kernel": key[:120], "ms_per_call": dev_us / 1e3 / args.calls,
                          "launches_per_call": count / args.calls, "share": dev_us / busy_us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
