"""Two trees of the torch port on one card, in turns: the attention kernels
of ``attn_flash.cuh`` (#1 bf16 clamp, the fp32 #3 at head_dim 80, #6 and #7,
and the bf16 #3, #6 and #7 that share the header), the bf16 attention
backward (#4 at head dims 64 and 80) and the LN→MLP (#2) and its dx (#5) at
ViT-L and ViT-H widths by CUDA events, and the end-to-end
steps (ViT-L and ViT-H bf16 predict_step and train_step, the default fp32
ViT-L config's, and the fp32 ViT-H predict_step) by the host clock around
synchronized calls, with each train step's peak device memory.

    python3 scripts/ab_torch_trees.py [--attn-only] OLD_ROOT NEW_ROOT

runs OLD, NEW, NEW, OLD, each in its own process (its own build of its
kernels, from that tree's sources), and prints one JSON line per run, then
the card's name and power limit. Every tree must have the port's public
entries (``ops.cuda_attn`` wrappers, ``train.loop.model_for_config``,
``PromptTuner``) and a ``chip_smoke.py`` with the seeded input builders.

    python3 scripts/ab_torch_trees.py --one ROOT

measures one tree in this process. ``--attn-only`` measures #1 bf16 (clamp)
alone: at B = 8 and 32 on the ViT-L grid, at 8 heads (a rank of the
two-rank split) and on 64 and 128 rows of Painter's 14×14 windows. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


def measure(root: Path, attn_only: bool = False) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.ops import build, cuda_attn, cuda_mlp
    from beach_seg_tpu_torch.train import PromptTuner
    from beach_seg_tpu_torch.train.loop import model_for_config

    dev = torch.device("cuda")
    t = time.perf_counter()
    build.build(*build.KERNELS)
    res = {"root": str(root), "build_s": time.perf_counter() - t}
    gh, gw = cs.GRID
    bh = cs.B * cs.HEADS
    qkv4, bias, rh_tab, rw_tab = cs.attn_inputs(torch.bfloat16, dev)
    res["attn_qkv_rel_bf16_ms"] = cs.time_ms(
        lambda: cuda_attn.attn_qkv_rel(qkv4, bias, rh_tab, rw_tab, cs.HD**-0.5, gw, cs.HEADS, "clamp"), iters=20, warmup=2)
    del qkv4, bias, rh_tab, rw_tab
    if attn_only:
        for key, b, heads, grid in (("b32", 32, cs.HEADS, cs.GRID), ("h8", cs.B, 8, cs.GRID),
                                    ("win64", 64, cs.HEADS, (14, 14)), ("win128", 128, cs.HEADS, (14, 14))):
            args = (*cs.attn_inputs(torch.bfloat16, dev, b=b, grid=grid, c=heads * cs.HD), cs.HD**-0.5, grid[1], heads,
                    "clamp")
            res[f"attn_qkv_rel_bf16_{key}_ms"] = cs.time_ms(lambda: cuda_attn.attn_qkv_rel(*args), iters=20, warmup=2)
            del args
            torch.cuda.empty_cache()
        return res
    for hd in (cs.HD, cs.HD_H):
        args = (*cs.attn_bwd_inputs(dev, bh, hd=hd), hd**-0.5)
        res[f"attn_bwd_bf16_hd{hd}_ms"] = cs.time_ms(lambda: cuda_attn.attn_bwd(*args), iters=10, warmup=2)
        del args
    for dtype, dt, iters in ((torch.bfloat16, "bf16", 20), (torch.float32, "fp32", 10)):
        qkv, _, _, (rh64, rw64) = cs.qkv_slot_inputs(dev, dtype)
        res[f"attn_qkv_{dt}_ms"] = cs.time_ms(lambda: cuda_attn.attn_qkv(qkv, rh64, rw64, cs.HD**-0.5, gh, gw, cs.HEADS),
                                               iters=iters, warmup=2)
        del qkv, rh64, rw64
        q, k, v, rh, rw = cs.packed_inputs(dev, dtype, bh, cs.HD, seed=8)
        res[f"attn_fused_{dt}_ms"] = cs.time_ms(lambda: cuda_attn.attn_fused(q, k, v, rh, rw, cs.HD**-0.5), iters=iters, warmup=2)
        q, k, v, rh, rw = cs.packed_inputs(dev, dtype, bh, cs.HD_H)
        res[f"attn_packed_{dt}_hd80_ms"] = cs.time_ms(lambda: cuda_attn.attn_packed(q, k, v, rh, rw, cs.HD_H**-0.5, cs.HEADS),
                                                       iters=iters, warmup=2)
        del q, k, v, rh, rw
        torch.cuda.empty_cache()
    for geo, c, m in (("vit_l", cs.C, cs.MLP), ("vit_h", cs.C_H, cs.MLP_H)):
        x, ls, lb, w1, b1, w2, b2, gy = cs.mlp_inputs(dev, 1, cs.B * gh * gw, c, m)
        res[f"ln_mlp_{geo}_ms"] = cs.time_ms(lambda: cuda_mlp.ln_mlp(x, ls, lb, w1, b1, w2, b2, 1e-6, True), iters=20, warmup=2)
        res[f"ln_mlp_dx_{geo}_ms"] = cs.time_ms(lambda: cuda_mlp.ln_mlp_dx(x, ls, lb, w1, b1, w2, gy, 1e-6, True),
                                                iters=20, warmup=2)
        del x, w1, w2, gy
        torch.cuda.empty_cache()

    for name, conf in (("vit_l_bf16", BeachSegConfig(batch_size=cs.B, compute_dtype="bfloat16")),
                       ("vit_h_bf16", BeachSegConfig(batch_size=cs.B, backbone="huge", compute_dtype="bfloat16")),
                       ("vit_l_fp32", BeachSegConfig(batch_size=cs.B)),
                       ("vit_h_fp32", BeachSegConfig(batch_size=cs.B, backbone="huge"))):
        model, _ = model_for_config(conf, device=dev, seed=0)
        tuner = PromptTuner(model, conf, device=dev)
        prompts, batches = cs.main_path_inputs(conf, 4, 5)  # the first call is cold
        secs = []
        for batch in batches:
            t = time.perf_counter()
            tuner.predict_step(*prompts, batch, out_size=conf.crop_size)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        res[f"{name}_predict_s"] = secs
        if name == "vit_h_fp32":  # predict only: no train step of it is driven
            del model, tuner
            torch.cuda.empty_cache()
            continue
        prompts, batches = cs.train_path_inputs(conf, 4, 3)
        state = tuner.init_state(prompts[0])
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for batch in batches:
            t = time.perf_counter()
            state, metrics = tuner.train_step(state, prompts[1], prompts[2], batch, generator=gen)
            metrics["loss"].item()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        res[f"{name}_train_s"] = secs
        res[f"{name}_train_peak_bytes"] = torch.cuda.max_memory_allocated()
        del model, tuner, state
        torch.cuda.empty_cache()
    return res


def main() -> int:
    argv = [a for a in sys.argv[1:] if a != "--attn-only"]
    flags = ["--attn-only"] if len(argv) < len(sys.argv) - 1 else []
    if argv[:1] == ["--one"]:
        import torch

        if not torch.cuda.is_available():
            print("ab_torch_trees: no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(measure(Path(argv[1]).resolve(), attn_only=bool(flags))), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (Path(p).resolve() for p in argv)
    for root in (old, new, new, old):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", str(root), *flags], cwd=root,
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
