"""Time train.loop.run_training with its prompt exports written in line (as
the JAX package writes them) and on PromptExports' background threads, in
turns on one card: in line, threads, threads, in line, in line, threads.

    python3 scripts/ab_torch_exports.py

The run is chip_smoke.py's phase 19: its scene's reference date (19 crops of
112 tiled to 448), ViT-L with seeded random weights in bf16, batch 8, 2
epochs with the profiler on epoch 0, then a resume to 3 epochs. A 1-epoch
run first draws the weights and loads the kernels. Prints the seconds of
each run beside the card's name and power limit."""
import dataclasses
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from beach_seg_tpu_torch.config import BeachSegConfig  # noqa: E402
from beach_seg_tpu_torch.ops import build  # noqa: E402
from beach_seg_tpu_torch.train import loop  # noqa: E402
from beach_seg_tpu_torch.train.checkpoint import save_prompt_batch  # noqa: E402


def in_line(self, name, pixels, after=None):
    """PromptExports.save, writing at once on the calling thread."""
    host = pixels.detach().cpu().numpy() if hasattr(pixels, "detach") else pixels
    p = self.prompts
    save_prompt_batch(self.run_dir / name, host, p["masks"], p["nodata"], p["crop_idx"], self.dates)
    if after is not None:
        after()


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_torch_exports: no CUDA device available", file=sys.stderr)
        return 2
    card = cs.card_line()
    build.build(*build.KERNELS)
    threaded = loop.PromptExports.save
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cs.write_scene(root / "scene", n_dates=1)
        conf = BeachSegConfig(data=root / "scene", model_training_root=root / "out", checkpoint="random",
                              compute_dtype="bfloat16", crop_size=112, inpt_size=448, batch_size=8, epochs=2,
                              profile=True, log_every_n_steps=1, num_viz_images=2)
        loop.run_training(dataclasses.replace(conf, epochs=1, profile=False))  # warm-up: weights drawn, kernels loaded
        for mode in ("in_line", "threads", "threads", "in_line", "in_line", "threads"):
            loop.PromptExports.save = in_line if mode == "in_line" else threaded
            t = time.perf_counter()
            rd = loop.run_training(conf)
            s1 = time.perf_counter() - t
            t = time.perf_counter()
            loop.run_training(dataclasses.replace(conf, epochs=3, resume_from=rd, profile=False))
            s2 = time.perf_counter() - t
            print(f"exports {mode}: run_training {s1:.3f} s, resume to 3 epochs {s2:.3f} s ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
