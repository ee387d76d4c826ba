"""Where the time of one of the torch port's scene engines goes, on one
CUDA card.

    python3 scripts/profile_torch_engines.py [--engine zero_shot|legacy|predict] [--dtype bfloat16|float32] [--dates 8] [--save DIR]

Writes chip_smoke.py's synthetic scene (2048×1024, one reference date and
``--dates`` predict dates), runs the engine once at full width (ViT-L,
seeded random weights, batch 8) to build the kernels and draw the weights,
then twice more: under ``torch.profiler`` (the device-busy time of the
stream, so its idle share; the operator tracing slows the host a little)
and under ``cProfile`` (the host functions that take the stream's time).
Prints the card, each
run's ``timings.json``, the device-busy share of the stream and the top
host functions by their own time and by cumulative time, as JSON lines.
``--save DIR`` copies the last run's outputs of the first predict date
there. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def run_engine(engine: str, data: Path, out: Path, dtype: str) -> Path:
    from beach_seg_tpu_torch.config import LegacyConfig, PredConfig, PredictionConfig
    from beach_seg_tpu_torch.infer import run_legacy, run_predict, run_zero_shot

    common = dict(data=data, model_training_root=out, checkpoint="random", batch_size=8, compute_dtype=dtype)
    if engine == "zero_shot":
        return run_zero_shot(PredConfig(**common))
    if engine == "legacy":
        return run_legacy(LegacyConfig(**common))
    return run_predict(PredictionConfig(**common))


def top(stats: pstats.Stats, key: str, n: int) -> list[dict]:
    stats.sort_stats(key)
    rows = []
    for func in stats.fcn_list[:n]:
        cc, nc, tt, ct, _ = stats.stats[func]
        rows.append({"function": f"{Path(func[0]).name}:{func[1]}({func[2]})", "calls": nc,
                     "own_s": round(tt, 3), "cumulative_s": round(ct, 3)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("zero_shot", "legacy", "predict"), default="zero_shot")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--dates", type=int, default=8)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--save", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_engines: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"card": card, "engine": args.engine, "dtype": args.dtype, "dates": args.dates}), flush=True)
    with tempfile.TemporaryDirectory(prefix="profile_engines_") as tmp:
        root = Path(tmp)
        dates = chip_smoke.write_scene(root / "scene", n_dates=args.dates)
        timings = lambda d: json.loads((d / "timings.json").read_text())  # noqa: E731

        t = time.perf_counter()
        first = run_engine(args.engine, root / "scene", root / "out", args.dtype)
        print(json.dumps({"run": "warm-up", "seconds": round(time.perf_counter() - t, 3), "timings": timings(first)}), flush=True)

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            traced = run_engine(args.engine, root / "scene", root / "out", args.dtype)
            torch.cuda.synchronize()
        busy_us = 0.0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                busy_us += getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
        stream_s = timings(traced)["stream_s"]
        print(json.dumps({"run": "torch.profiler", "timings": timings(traced),
                          "device_busy_s": round(busy_us / 1e6, 3),
                          "device_busy_share_of_stream": round(busy_us / 1e6 / stream_s, 4) if stream_s else None}),
              flush=True)

        prof_host = cProfile.Profile()
        prof_host.enable()
        last = run_engine(args.engine, root / "scene", root / "out", args.dtype)
        prof_host.disable()
        stats = pstats.Stats(prof_host)
        print(json.dumps({"run": "cProfile (host)", "timings": timings(last)}))
        for row in top(stats, "tottime", args.top):
            print(json.dumps({"by": "own", **row}))
        for row in top(stats, "cumulative", args.top):
            print(json.dumps({"by": "cumulative", **row}))
        if args.save is not None:
            args.save.mkdir(parents=True, exist_ok=True)
            for f in last.rglob(f"*{dates[1]}*"):
                shutil.copy(f, args.save / f.name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
