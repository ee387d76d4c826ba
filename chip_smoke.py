"""Chip smoke test of the PyTorch/CUDA port (beach_seg_tpu_torch) on one
NVIDIA Hopper card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the seven CUDA sources of ops/csrc with nvcc, in parallel; print
     the build time and ptxas' register / shared-memory / spill lines;
  3. at ViT-L shapes for a batch of 8 tiles (S=1568, C=1024, 16 heads,
     M=4096): each forward kernel against its plain PyTorch version on the
     card, then CUDA-event times of the kernel, the plain version and, for
     attention, scaled_dot_product_attention with the materialized bias (a
     yardstick the port never calls); the qkv-rel attention in bf16 in all
     three softmax modes (stable, clamp: the default, timed; fast) and in
     fp32 (the instance phase 12 runs); the LN→MLP is held to a largest
     error and an error norm (MLP_BF16_REL_TOL, MLP_NORM_TOL) and timed
     beside the bf16 chain of PyTorch calls (F.layer_norm → addmm → GELU →
     addmm, chain_ms, a yardstick the port never calls);
  4. the same for the two backward kernels (attention backward at B·H=128,
     LN→MLP dx at 12544 rows); the attention yardstick is SDPA's backward
     with the bias as a mask that takes a gradient, the MLP's the chain's
     autograd dx;
  5. the predict path: full-width ViT-L (24 layers, seeded random weights,
     bf16) through PromptTuner.predict_step on 3 batches of 8 uint8 112×112
     crops; ids checked for shape, dtype and range; the launch counters must
     rise by 24 attention and 24 MLP launches per call (and 24 of each of
     the MLP's stage kernels ln_rows, lin1_gelu, lin2) and the backward
     kernels stay idle; pred_masks of one batch held against the same
     forward through the plain versions on the card;
  6. the train path: the same model through PromptTuner.train_step, 3 steps
     on seeded batches of 8 448×448 tiles (default augmentations, drop-path
     0.1, loss "nodata") against 4 prompts; the loss must be finite, the
     prompt pixels must move, and each step must launch all four kernels 24
     times; seconds per step and peak device memory; one step's prompt-pixel
     gradient through the kernels held against the plain versions on the
     same draws;
  7. at ViT-H shapes for a batch of 8 tiles (S=1568, C=1280, 16 heads of
     80, M=5120): the packed attention (bf16 and fp32, yardstick SDPA with
     the materialized bias), the attention backward at head_dim 80
     (yardstick SDPA's backward), the LN→MLP and its dx at C=1280, each
     against its plain version on the card, then timed; then each stage
     kernel of the two MLP kernels (ln_rows, lin1_gelu, lin2, dual_dh, dln,
     ln_vjp) against its stage plain version at the ViT-L and ViT-H B=8
     shapes (then timed) and at a ragged N = S + 9 rows;
  8. the ViT-H predict path: model_for_config(backbone="huge", bf16) at full
     width (32 layers, seeded random weights) through predict_step on 3
     batches of 8 crops, 32 packed-attention and 32 MLP launches per call,
     the qkv-rel and backward kernels idle, pred_masks held against the
     plain versions with phase 5's limits;
  9. the ViT-H train path: 3 train_steps as in phase 6, all four of its
     kernels (packed attention, MLP, attention backward, MLP dx) 32 times
     per step, the prompt gradient held against the plain versions with
     phase 6's limits;
 10. the kernels behind the library's attention entries at B=8 ViT-L
     shapes, bf16 and fp32, each against its plain version, then timed
     beside SDPA with the materialized bias: the fused attention (#7,
     attn_fused) and the qkv-layout attention (#6, attn_qkv); then the
     attention backward in fp32 at head dims 64 and 80 (yardstick SDPA's
     fp32 backward);
 11. the entry path: fused_attention (head dims 64 and 80) and
     fused_attention_qkv (rel terms from rel_pos_terms_split) forward and
     backward at B=8 in bf16 and fp32, each call launching its forward
     kernel once and the attention backward once, output and gradients held
     against the plain versions;
 12. the default BeachSegConfig (fp32 ViT-L, model_for_config): 2
     predict_step calls (24 qkv-rel attention launches each; the second is
     the warm time) and 2 train_steps (24 qkv-rel and 24 fp32
     attention-backward launches each, the MLP plain torch), the prompt
     gradient held against the plain versions with fp32 limits;
 13. the small head dims: the packed (#3) and fused (#7) attention and the
     attention backward (#4) at head_dim 16 (the debug backbone's) and 8
     (tiny_config's, zero-padded to 16 by the wrappers), bf16 and fp32, at
     B=8 tiles of 4 heads on the ViT grid, each against its plain version
     with the head_dim-64 tolerances;
 14. the grid (37, 27), whose 64-key tiles cross rel_h slot chunks and whose
     last tile is ragged: #3, #7 and #4 at head dims 64 and 80 and #6, bf16
     and fp32, and #1 bf16 in its three softmax modes, each against its plain
     version;
 15. the debug backbone (BeachSegConfig(debug=True): C=64, 4 layers, 4
     heads of 16) in bf16 and fp32: 3 (2 in fp32) predict_step calls and
     train_steps at B=8, each call launching #3 (and under bf16 the MLP
     kernel #2, at C=64 its narrow instance) 4 times and each step #3 and
     #4 (and #2, #5) 4 times, pred_masks and the prompt gradient held
     against the plain versions with phases 5–6's limits (fp32: phase 12's);
 16. the full-size fp32 ViT-H (BeachSegConfig(backbone="huge"), its default
     compute dtype): 2 predict_step calls (the second is the warm time), 32
     packed-attention launches each (#3 on its split-TF32 body), pred_masks
     held against the plain versions with phase 5's limits;
 17. the tuned-predict scene engine (infer.predict.run_predict) end to end
     at full width: a 2048×1024-pixel, 4-band uint16 scene at 3 m (a wavy
     shoreline across the full width; one reference date and 8 predict
     dates, each two overlapping GeoTIFF tiles) written to disk with the
     port's geo writers, then ViT-L (seeded random weights, batch 8) in bf16
     vote mode, bf16 blend mode (overlap 56), bf16 vote mode through the
     plain versions and fp32 vote mode: per-date GeoTIFFs of the scene's
     shape and CRS with ids in 0..3, mask PNGs and overlays; 24 #1 and 24 #2
     launches (and 24 of each MLP stage kernel) per batch under bf16, 24 #1
     under fp32, the others idle; timings.json's tile count; the bf16 vote
     mosaics equal to the plain run's on ID_AGREEMENT_MIN of the voted
     pixels; stream_tiles_per_sec and the phase seconds of each run;
 18. one JSON line of per-kernel numbers (one entry per kernel, geometry
     and dtype), then the card's name and power limit, then
     {"ok": true, "device": {...}} as the last line.

It exits non-zero without a CUDA device, and needs nothing but this
repository, torch, numpy and the CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

PEAK_BF16 = 989e12  # H100 SXM dense tensor-core FLOP/s (NVIDIA data sheet)
PEAK_TF32 = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s (NVIDIA data sheet)
# fp32-accurate FLOP/s on the tensor cores: split TF32 takes three TF32
# products for each fp32 one (tf32x3.cuh), the route PyTorch's fp32 attention
# takes too, so the least time fp32 attention work needs is 3·FLOPs / 495 TF/s
# (the FP32 units' 67 TF/s is slower)
PEAK_FP32_TC = PEAK_TF32 / 3
FP32_ROUTE = "tensor cores, split TF32: 3 x FLOPs at 495 TF/s"
TF32X3 = "mma.sync m16n8k8 tf32x3"  # the design of the fp32 #1, #3, #4, #6 and #7 instances
# the design of the bf16 #3, #4, #6 and #7 instances (wgmma.cuh)
WGMMA = "wgmma m64nNk16, one warpgroup a block, cp.async ring, rel terms as k steps against the 0/1 slot matrix"
# #1 bf16: attn_flash.cuh's wgmma kernel, its qkv-rel instances
WGMMA_QKV_REL = WGMMA + "; qkv bias added in place, rel terms formed by mma.sync over gathered rows into the slot rows"
SOFTMAX_MODES = ("stable", "clamp", "fast")
HBM = 3.35e12  # bytes/s
B = 8  # tiles per batch (the predict step's batch)
GRID = (56, 28)  # ViT-L and ViT-H canvas 896×448 at 16-pixel patches
# a grid whose 64-key tiles cross rel_h slot chunks (16 rows of 27 keys) and
# whose last tile is ragged (999 = 15·64 + 39); ViT's 16·28 keys are 7 tiles
GRID_CROSS = (37, 27)
C, HEADS, MLP = 1024, 16, 4096
HD = C // HEADS
C_H, MLP_H = 1280, 5120  # ViT-H (huge_config): 16 heads of 80
HD_H = C_H // HEADS
BF16_EPS = 2.0**-8

# tolerances, kernel against its plain version on the same inputs:
# attention bf16/clamp: three bf16 steps at |out| ≤ ~1 (p and out are rounded
# at the same points, fp32 sums in another order may round to the neighbour)
ATTN_BF16_TOL = 3e-2
# and within it, relative to what is compared: the largest error within two
# bf16 steps of max|plain| (a neighbour in the top binade is one), and the
# error's norm within one rounding step of the output's (BF16_EPS·‖plain‖):
# outputs rounded at the same points differ by a neighbour at a few elements,
# while a kernel that drops a key tile, a slot chunk or the tail mask moves
# every row it reaches (scripts/ablate_torch_kernels.py check)
ATTN_BF16_REL_TOL = 4 * BF16_EPS
ATTN_BF16_NORM_TOL = BF16_EPS
# attention fp32/stable: the online softmax rescales partial sums, and the
# split-TF32 products of #1 (~2^-21 a product, the tensor cores' truncating
# accumulation within one 64-key tile, the tiles added in fp32) leave a few
# e-6 at |out| ≤ ~3; the FP32-unit kernels (#3, #6, #7) a few ulps
ATTN_FP32_TOL = 1e-4
# MLP bf16: four bf16 steps of the output's scale
MLP_BF16_REL_TOL = 4 * BF16_EPS
# and the error's norm within one rounding step of the output's
# (BF16_EPS·‖plain‖), for #2, #5 and each of their stage kernels: ln, h and
# dh are rounded at the same points as in the plain versions, so intact
# kernels differ by a neighbour at a few elements (error norms 4.0e-4 to
# 6.8e-4 of the output's for #2 and #5 at C=1024 and 1280, N=45 to 12544, on
# an H100), while a 64-channel K tile or a 128-unit hidden tile left out, or
# gelu' or the LN VJP's xhat term left out, moves every row it reaches
# (scripts/ablate_torch_kernels.py check)
MLP_NORM_TOL = BF16_EPS
# the stage kernels' fp32 outputs, which nothing rounds to bf16: the LN
# statistics (mean, rstd) and dln = dh·W1ᵀ differ from their plain versions
# only by the order of fp32 sums. Read on an H100 at C=1024 and 1280, N=1577
# and 12544: mean and rstd within 2.2e-7 of max|plain| (error norms ≤ 4.6e-8
# of the output's), dln within 7.5e-6 (norms ≤ 6.0e-6). Each limit holds both
# the largest error over max|plain| and the error norm over the output's:
# 1e-6 for the statistics, 1e-4 for dln, where a dln rounded to bf16 reads
# ~1e-3 and an rstd off by 1% reads 1e-2 (tests/test_torch_smoke_limits.py)
MLP_STATS_TOL = 1e-6
MLP_DLN_TOL = 1e-4
# the stage kernels behind #2 and #5 at C % 256 == 0
MLP_STAGES = ("ln_rows", "lin1_gelu", "lin2", "dual_dh", "dln", "ln_vjp")
# the design of #2 and #5 at C % 256 == 0 (gemm_sm90.cuh)
MLP_DESIGN = ("row passes and warp-specialized products: TMA (128-byte swizzle) into a 4-6 stage mbarrier ring, "
              "one producer warp, two consumer warpgroups of wgmma m64nNk16 (128 x 256 or 2 x 128 x 128 tiles), "
              "intermediates in device memory at the TPU kernel's precisions")
# attention backward, kernel vs plain: p (for dV) and dS (for dQ, dK) are bf16
# mma operands in the kernel (fp32 in the plain version), a relative 2^-9 per
# term; dq is rounded to bf16 too: 1% of each output's scale. drh/drw are
# fp32 sums of dS rounded once to bf16: two bf16 steps of their scale
ATTN_BWD_REL_TOL = 1e-2
ATTN_BWD_REL_DRHW = 2 * BF16_EPS
# attention backward in fp32, kernel vs plain: the kernel forms every product
# in split TF32 on the tensor cores (~2^-21 relative a product, each step's
# truncating tensor-core sum added to the total in fp32), the plain version in
# full fp32; beside the order of the sums over S=1568 keys or queries that
# leaves a few e-6 of each output's scale; 1e-4 of it
ATTN_BWD_FP32_REL_TOL = 1e-4
# LN→MLP dx: LN, dh and dx rounded to bf16 at the same points; fp32 sums in
# another order may round to the neighbour: four bf16 steps of the scale
MLP_DX_REL_TOL = 4 * BF16_EPS
# train path, one step's prompt-pixel gradient through the kernels vs the
# plain versions on the same draws: 24 layers of bf16 forward and backward,
# where the kernels round p and dS as bf16 mma operands and fp32 sums run in
# other orders. Measured on an H100: 1 − cosine 3.7e-5, max error 1.24e-2
# of max|grad| (a fifth of the median |grad|). Limits ~27× and ~4× above
# those: a backward kernel wrong in a single layer or in the rel-term fold
# turns the gradient's direction by more than the cosine limit allows
GRAD_1MCOS_MAX = 1e-3
GRAD_REL_TOL = 5e-2
# the same at fp32 (the default BeachSegConfig): the attention kernels' split-
# TF32 products and fp32 sums in other orders against full fp32 products in
# the plain run, so a layer's attention outputs differ by a few e-6 of their
# scale and 24 layers forward and backward grow that at most tenfold; a
# kernel wrong anywhere moves the gradient by far more
GRAD32_1MCOS_MAX = 1e-5
GRAD32_REL_TOL = 1e-3
# main path, pred_masks through kernels vs plain versions after 24 layers of
# bf16 rounding flips: 5% of the output's scale. Random weights paint many
# pixels close to a palette decision boundary, so ids may differ there: ≥ 98%
# equal, and every differing id within the error's reach of a boundary
PRED_REL_TOL = 5e-2
ID_AGREEMENT_MIN = 0.98


def counters():
    """The launch-counting wrappers, by kernel name (ln_mlp and ln_mlp_dx
    count calls; their stage wrappers count stage-kernel launches)."""
    from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp

    return {
        "attn_qkv_rel": cuda_attn.attn_qkv_rel, "ln_mlp": cuda_mlp.ln_mlp,
        "attn_bwd": cuda_attn.attn_bwd, "ln_mlp_dx": cuda_mlp.ln_mlp_dx,
        "attn_packed": cuda_attn.attn_packed, "attn_fused": cuda_attn.attn_fused,
        "attn_qkv": cuda_attn.attn_qkv, **{name: getattr(cuda_mlp, name) for name in MLP_STAGES},
    }


def with_stages(expect: dict) -> dict:
    """``expect`` (launches a call or step) with the stage kernels that its
    ln_mlp and ln_mlp_dx calls launch at C % 256 == 0."""
    f, b = expect.get("ln_mlp", 0), expect.get("ln_mlp_dx", 0)
    stages = {"ln_rows": f + b, "lin1_gelu": f, "lin2": f, "dual_dh": b, "dln": b, "ln_vjp": b}
    return {**expect, **{k: v for k, v in stages.items() if v}}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` launches after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """Least time (ms) the card could take, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / HBM
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attn_bound(b: int, itemsize: int, peak: float) -> tuple[float, str]:
    gh, gw = GRID
    s = gh * gw
    flops = 4 * b * HEADS * s * s * HD + 2 * b * HEADS * s * (gh + gw) * HD  # QKᵀ, PV, rel terms
    nbytes = itemsize * (b * s * 3 * C + b * s * C + 3 * C + (gh + gw) * 64 * HD)
    return bound(flops, nbytes, peak)


def mlp_bound(n: int, c: int = C, m: int = MLP) -> tuple[float, str]:
    flops = 4 * n * c * m
    nbytes = 2 * (2 * n * c + 2 * c * m + m + c) + 4 * 2 * c
    return bound(flops, nbytes, PEAK_BF16)


def attn_inputs(dtype, device, b=B, seed=0, grid=GRID):
    from beach_seg_tpu_torch.ops.attention import rel_tables_padded

    g = torch.Generator(device=device).manual_seed(seed)
    gh, gw = grid
    qkv = torch.randn((b, gh * gw, 3, C), generator=g, device=device)
    bias = 0.1 * torch.randn((3, C), generator=g, device=device)
    rph = 0.1 * torch.randn((2 * gh - 1, HD), generator=g, device=device)
    rpw = 0.1 * torch.randn((2 * gw - 1, HD), generator=g, device=device)
    rh, rw = rel_tables_padded(rph, rpw, grid, grid)
    return [t.to(dtype).contiguous() for t in (qkv, bias, rh, rw)]


def sdpa_yardstick(qkv, bias, rh, rw):
    """One PyTorch call computing the same attention: SDPA over head-split
    q, k, v with the (B, H, S, S) rel-pos bias materialized. Returns a
    closure over prepared inputs so only the SDPA call is timed."""
    from torch.nn import functional as F

    b, s, _, c = qkv.shape
    gh, gw = GRID
    x = qkv + bias
    q, k, v = (x[:, :, i].reshape(b, s, HEADS, HD).transpose(1, 2) for i in range(3))
    q5 = q.reshape(b, HEADS, gh, gw, HD)
    rel_h = torch.einsum("bnyxc,ykc->bnyxk", q5, rh).reshape(b, HEADS, s, 64)
    rel_w = torch.einsum("bnyxc,xkc->bnyxk", q5, rw).reshape(b, HEADS, s, 64)
    kidx = torch.arange(s, device=qkv.device)
    mask = (rel_h[..., kidx // gw] + rel_w[..., kidx % gw]).contiguous()
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=HD**-0.5)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def attn_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """An attention output against its plain version: the largest error,
    max|plain|, and the error's norm over the output's."""
    d = got.float() - want.float()
    return {"err": d.abs().max().item(), "scale": want.float().abs().max().item(),
            "norm": (d.norm() / want.float().norm()).item()}


def attn_within(e: dict, dtype) -> bool:
    """Whether ``attn_errors``' readings meet the forward attention limits."""
    if dtype == torch.float32:
        return e["err"] <= ATTN_FP32_TOL
    return e["err"] <= min(ATTN_BF16_TOL, ATTN_BF16_REL_TOL * e["scale"]) and e["norm"] <= ATTN_BF16_NORM_TOL


def attn_out_check(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A forward attention kernel's output against its plain version: finite,
    fp32 within ATTN_FP32_TOL; bf16 within ATTN_BF16_TOL and the relative
    limits beside it. Returns the largest error."""
    check(bool(torch.isfinite(got).all()), f"{name} output not finite")
    e = attn_errors(got, want)
    if got.dtype == torch.float32:
        limits = f"tol {ATTN_FP32_TOL:.1e}"
    else:
        limits = (f"tol {min(ATTN_BF16_TOL, ATTN_BF16_REL_TOL * e['scale']):.3e}; error norm {e['norm']:.3e} "
                  f"of the output's, tol {ATTN_BF16_NORM_TOL:.3e}")
    log(f"{name}: max_abs_err {e['err']:.3e} ({limits}), max|plain| {e['scale']:.3f}")
    check(attn_within(e, got.dtype), f"{name} disagrees with its plain version: {e}")
    return e["err"]


def bwd_out_check(name: str, got, want, fp32: bool) -> dict:
    """The attention backward's five outputs against its plain version's (bf16:
    ATTN_BWD_REL_TOL of each output's scale, ATTN_BWD_REL_DRHW for drh/drw;
    fp32: ATTN_BWD_FP32_REL_TOL). Returns the largest error of each."""
    errs = {}
    for out, a, w in zip(("dq", "dk", "dv", "drh", "drw"), got, want):
        check(tuple(a.shape) == tuple(w.shape) and bool(torch.isfinite(a).all()), f"{name} {out} shape or not finite")
        err = (a.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        tol = (ATTN_BWD_FP32_REL_TOL if fp32 else ATTN_BWD_REL_DRHW if out in ("drh", "drw") else ATTN_BWD_REL_TOL) * scale
        log(f"{name} {out}: max_abs_err {err:.3e} = {err / scale:.2e} of max|plain| {scale:.3f} (tol {tol:.3e})")
        check(err <= tol, f"{name} {out} disagrees with its plain version: {err} > {tol}")
        errs[out] = err
    return errs


def mlp_inputs(device, seed: int, n: int, c: int, m: int):
    """x, LN scale and bias, W1, b1, W2, b2 and an output cotangent g for n
    rows of width c and m hidden units, seeded; x and g (B, n / B, c), or
    (n, c) where B does not divide n."""
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=device)  # noqa: E731
    bf = torch.bfloat16
    rows = (B, n // B) if n % B == 0 else (n,)
    return (
        rnd(*rows, c).to(bf), 1 + 0.1 * rnd(c), 0.1 * rnd(c), (rnd(c, m) / c**0.5).to(bf),
        (0.1 * rnd(m)).to(bf), (rnd(m, c) / m**0.5).to(bf), (0.1 * rnd(c)).to(bf), rnd(*rows, c).to(bf),
    )


def mlp_within(e: dict, tol_rel: float, tol_norm: float = MLP_NORM_TOL) -> bool:
    """Whether ``attn_errors``' readings of an MLP kernel or stage meet its
    limits: the largest error within ``tol_rel`` of max|plain|, the error's
    norm within ``tol_norm`` of the output's."""
    return e["err"] <= tol_rel * e["scale"] and e["norm"] <= tol_norm


def mlp_out_check(name: str, got: torch.Tensor, want: torch.Tensor, tol_rel: float,
                  tol_norm: float = MLP_NORM_TOL) -> dict:
    """An MLP kernel's or stage's output against its plain version: finite,
    within ``mlp_within``'s limits. Returns the readings."""
    check(tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype, f"{name}: {got.shape} {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name} output not finite")
    e = attn_errors(got, want)
    log(f"{name}: max_abs_err {e['err']:.3e} (tol {tol_rel * e['scale']:.3e} = {tol_rel:.2e}·max|plain| {e['scale']:.3f}); "
        f"error norm {e['norm']:.3e} of the output's (tol {tol_norm:.3e})")
    check(mlp_within(e, tol_rel, tol_norm), f"{name} disagrees with its plain version: {e}")
    return e


def mlp_chain_yardstick(x, ln_scale, ln_bias, w1, b1, w2, b2, g=None):
    """A chain of bf16 PyTorch calls computing the same function, which the
    port never calls: F.layer_norm → addmm → GELU (tanh form) → addmm
    (cuBLAS), or, given ``g``, its autograd dx. Returns a closure over
    prepared inputs (the backward over a retained graph)."""
    from torch.nn import functional as F

    c = x.shape[-1]
    x2 = x.reshape(-1, c).detach().requires_grad_(g is not None)
    lsb, lbb = ln_scale.to(x.dtype), ln_bias.to(x.dtype)
    b2 = torch.zeros(c, dtype=x.dtype, device=x.device) if b2 is None else b2  # dx does not depend on it

    def chain():
        ln = F.layer_norm(x2, (c,), lsb, lbb, 1e-6)
        return torch.addmm(b2, F.gelu(torch.addmm(b1, ln, w1), approximate="tanh"), w2)

    if g is None:
        return chain
    out, g2 = chain(), g.reshape(-1, c)
    return lambda: torch.autograd.grad(out, x2, g2, retain_graph=True)


def mlp_check(key: str, fn, plain, args, tol_rel: float, where: str) -> dict:
    """An MLP kernel (``ln_mlp`` or ``ln_mlp_dx``) against its plain version
    with ``mlp_within``'s limits, then it, the plain version and the bf16
    chain of PyTorch calls timed."""
    got = fn(*args)
    torch.cuda.synchronize()
    e = mlp_out_check(f"{fn.__name__} bf16{where}", got, plain(*args), tol_rel)
    del got
    dx = fn.__name__ == "ln_mlp_dx"
    chain = mlp_chain_yardstick(*args[:6], None if dx else args[6], args[6] if dx else None)
    res = {f"{key}_err": e["err"], f"{key}_norm": e["norm"], f"{key}_ms": time_ms(lambda: fn(*args), iters=10, warmup=2),
           f"{key}_plain_ms": time_ms(lambda: plain(*args), iters=3), f"{key}_chain_ms": time_ms(chain, iters=10, warmup=2)}
    del chain
    return res


def mlp_stage_check(device, n: int, c: int, m: int, seed: int, timed: bool) -> dict:
    """Each stage kernel of #2 and #5 against its stage plain version on the
    plain chain's own intermediates, with ``mlp_within``'s limits: the bf16
    outputs' (MLP_BF16_REL_TOL, MLP_NORM_TOL), the fp32 LN statistics'
    (MLP_STATS_TOL) and dln's (MLP_DLN_TOL); then, if ``timed``, each
    kernel's ms."""
    from beach_seg_tpu_torch.ops import cuda_mlp as M

    x, ls, lb, w1, b1, w2, b2, gy = mlp_inputs(device, seed, n, c, m)
    ln, mean, rstd = M.ln_rows_plain(x, ls, lb, 1e-6)
    h = M.lin1_gelu_plain(ln, w1, b1, True)
    dh = M.dual_dh_plain(ln, gy, w1, b1, w2, True)
    dln = M.dln_plain(dh, w1)
    calls = {
        "ln_rows": (lambda: M.ln_rows(x, ls, lb, 1e-6), (ln, mean, rstd)),
        "lin1_gelu": (lambda: M.lin1_gelu(ln, w1, b1, True), h),
        "lin2": (lambda: M.lin2(h, w2, b2), M.lin2_plain(h, w2, b2)),
        "dual_dh": (lambda: M.dual_dh(ln, gy, w1, b1, w2, True), dh),
        "dln": (lambda: M.dln(dh, w1), dln),
        "ln_vjp": (lambda: M.ln_vjp(dln, x, ls, mean, rstd), M.ln_vjp_plain(dln, x, ls, mean, rstd)),
    }
    res = {}
    for name, (fn, want) in calls.items():
        got = fn()
        torch.cuda.synchronize()
        pairs = zip(("", " mean", " rstd"), got, want) if name == "ln_rows" else [("", got, want)]
        for part, gt, wt in pairs:
            if part:  # ln_rows' fp32 mean and rstd
                tols = (MLP_STATS_TOL, MLP_STATS_TOL)
            elif name == "dln":
                tols = (MLP_DLN_TOL, MLP_DLN_TOL)
            else:
                tols = (MLP_BF16_REL_TOL, MLP_NORM_TOL)
            e = mlp_out_check(f"{name}{part} (N={n}, C={c})", gt, wt, *tols)
            res[f"{name}{part.replace(' ', '_')}_err"] = e["err"]
        if timed:
            res[f"{name}_ms"] = time_ms(fn, iters=10, warmup=2)
    # and with approx=False (GELU and gelu' in their erf forms)
    for name, fn, want in (("lin1_gelu_erf", lambda: M.lin1_gelu(ln, w1, b1, False), M.lin1_gelu_plain(ln, w1, b1, False)),
                           ("dual_dh_erf", lambda: M.dual_dh(ln, gy, w1, b1, w2, False),
                            M.dual_dh_plain(ln, gy, w1, b1, w2, False))):
        res[f"{name}_err"] = mlp_out_check(f"{name} (N={n}, C={c})", fn(), want, MLP_BF16_REL_TOL)["err"]
    return res


def mlp_device_launches(pred: dict, train: dict) -> dict:
    """Device launches a call of ln_mlp and of ln_mlp_dx, from a predict and
    a train path's counts: the forward's stage launches over its calls on
    the predict path; on the train path the dx's (its ln_rows are those left
    after the ln_mlp calls took the forward's share) over its calls. Each
    must equal its number of stage kernels."""
    p, t = pred["launches"], train["launches"]
    fwd = {st: p[st] / p["ln_mlp"] for st in MLP_STAGES[:3]}
    dx_rows = t["ln_rows"] - fwd["ln_rows"] * t["ln_mlp"]
    per_call = {"ln_mlp": sum(fwd.values()),
                "ln_mlp_dx": (dx_rows + sum(t[st] for st in MLP_STAGES[3:])) / t["ln_mlp_dx"]}
    for name, stages in (("ln_mlp", 3), ("ln_mlp_dx", 4)):
        check(per_call[name] == stages, f"{name}: {per_call[name]} device launches a call, want its {stages} stage kernels")
    return per_call


def phase_mlp_stages(device) -> dict:
    """The stage kernels of #2 and #5 against their stage plain versions at
    the main paths' B=8 shapes (ViT-L, ViT-H; then timed) and at a ragged
    N = S + 9 rows of each width."""
    s = GRID[0] * GRID[1]
    res = {}
    for geo, c, m in (("vit_l", C, MLP), ("vit_h", C_H, MLP_H)):
        res[geo] = mlp_stage_check(device, B * s, c, m, seed=11, timed=True)
        res[f"{geo}_ragged"] = mlp_stage_check(device, s + 9, c, m, seed=12, timed=False)
        torch.cuda.empty_cache()
        log(f"stage times (ms, {geo}, B={B}): " + ", ".join(f"{k} {res[geo][f'{k}_ms']:.4f}" for k in MLP_STAGES))
    return res


def phase_kernels(device) -> dict:
    """Kernels against their plain versions at ViT-L shapes, then times."""
    from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp

    res = {}
    gw = GRID[1]
    shape = (B, GRID[0] * gw, C)
    # fp32 stable: the instance the default (fp32) configuration runs
    args = (*attn_inputs(torch.float32, device), HD**-0.5, gw, HEADS, "stable")
    res["attn32_err"] = fwd_check("attn_qkv_rel fp32 stable", cuda_attn.attn_qkv_rel, cuda_attn.attn_qkv_rel_plain, args, shape)
    res["attn32_ms"] = time_ms(lambda: cuda_attn.attn_qkv_rel(*args), iters=3, warmup=1)
    res["attn32_plain_ms"] = time_ms(lambda: cuda_attn.attn_qkv_rel_plain(*args), iters=2)
    res["attn32_library_ms"] = time_ms(sdpa_yardstick(*args[:4]), iters=3, warmup=1)
    res["attn32_bound"] = attn_bound(B, 4, PEAK_FP32_TC)
    torch.cuda.empty_cache()
    # bf16 in every softmax mode (a template instance each), then timed in the main path's (clamp)
    inputs = attn_inputs(torch.bfloat16, device)
    for softmax in SOFTMAX_MODES:
        args = (*inputs, HD**-0.5, gw, HEADS, softmax)
        res[f"attn_err_{softmax}"] = fwd_check(f"attn_qkv_rel bf16 {softmax}", cuda_attn.attn_qkv_rel,
                                               cuda_attn.attn_qkv_rel_plain, args, shape)
    args = (*inputs, HD**-0.5, gw, HEADS, "clamp")
    res["attn_ms"] = time_ms(lambda: cuda_attn.attn_qkv_rel(*args), iters=20, warmup=2)
    res["attn_plain_ms"] = time_ms(lambda: cuda_attn.attn_qkv_rel_plain(*args), iters=3)
    res["attn_library_ms"] = time_ms(sdpa_yardstick(*args[:4]), iters=20, warmup=2)
    res["attn_bound"] = attn_bound(B, 2, PEAK_BF16)
    torch.cuda.empty_cache()

    n = B * GRID[0] * GRID[1]
    *head, b2, _ = mlp_inputs(device, 1, n, C, MLP)
    res.update(mlp_check("mlp", cuda_mlp.ln_mlp, cuda_mlp.ln_mlp_plain, (*head, b2, 1e-6, True), MLP_BF16_REL_TOL, ""))
    res["mlp_bound"] = mlp_bound(n)
    log(
        f"times (ms, B={B}): attn kernel {res['attn_ms']:.4f} plain {res['attn_plain_ms']:.4f} "
        f"sdpa {res['attn_library_ms']:.4f} bound {res['attn_bound'][0]:.4f} ({res['attn_bound'][1]}); "
        f"attn fp32 {res['attn32_ms']:.4f} plain {res['attn32_plain_ms']:.4f} sdpa {res['attn32_library_ms']:.4f} "
        f"bound {res['attn32_bound'][0]:.4f}; mlp kernel {res['mlp_ms']:.4f} plain {res['mlp_plain_ms']:.4f} bound {res['mlp_bound'][0]:.4f} ({res['mlp_bound'][1]}) chain {res['mlp_chain_ms']:.4f}"
    )
    return res


def attn_bwd_bound(bh: int, s: int, hk: int, wk: int, hd: int = HD, itemsize: int = 2,
                   peak: float = PEAK_BF16) -> tuple[float, str]:
    flops = 10 * bh * s * s * hd  # S, dP, dV, dQ, dK
    # q, k, v, g and the rel terms in; dq, drh, drw in their dtype and dk, dv in fp32 out
    nbytes = itemsize * (4 * bh * s * hd + bh * s * (hk + wk)) + bh * s * hd * (itemsize + 4 + 4) + itemsize * bh * s * (hk + wk)
    return bound(flops, nbytes, peak)


def mlp_dx_bound(n: int, c: int = C, m: int = MLP) -> tuple[float, str]:
    flops = 6 * n * c * m
    nbytes = 2 * (3 * n * c + 2 * c * m + m) + 4 * 2 * c
    return bound(flops, nbytes, PEAK_BF16)


def attn_bwd_inputs(device, bh: int, seed: int = 2, hd: int = HD, dtype=torch.bfloat16, grid=GRID):
    """q, k, v, g (B·H, S, hd) and the rel terms at the scale the model's
    rel-pos tables give them."""
    g = torch.Generator(device=device).manual_seed(seed)
    gh, gw = grid
    s = gh * gw
    r = lambda *shape, sc=1.0: (sc * torch.randn(shape, generator=g, device=device)).to(dtype)  # noqa: E731
    return r(bh, s, hd), r(bh, s, hd), r(bh, s, hd), r(bh, s, gh, sc=0.5), r(bh, s, gw, sc=0.5), r(bh, s, hd)


def sdpa_bwd_yardstick(q, k, v, rel_h, rel_w, g):
    """One PyTorch call computing the same gradients: the backward of SDPA
    over (B, H, S, D) q, k, v with the rel bias materialized as a (B, H, S, S)
    mask that takes a gradient (its gradient is dS, from which drh/drw are
    sums). Returns a closure that times the backward alone."""
    from torch.nn import functional as F

    bh, s, d = q.shape
    gw = GRID[1]
    kidx = torch.arange(s, device=q.device)
    mask = (rel_h[..., kidx // gw] + rel_w[..., kidx % gw]).reshape(bh // HEADS, HEADS, s, s).detach().requires_grad_(True)
    qq, kk, vv = (t.reshape(bh // HEADS, HEADS, s, d).detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, scale=d**-0.5)
    gg = g.reshape(bh // HEADS, HEADS, s, d)
    return lambda: torch.autograd.grad(out, (qq, kk, vv, mask), gg, retain_graph=True)


def attn_bwd_check(device, hd: int, where: str, dtype=torch.bfloat16) -> dict:
    """The attention backward at B·H = B·HEADS and head_dim ``hd`` against
    its plain version (bf16: 1% of each output's scale for dq/dk/dv, two
    bf16 steps for drh/drw; fp32: ATTN_BWD_FP32_REL_TOL of each), then it,
    its plain version and SDPA's backward timed."""
    from beach_seg_tpu_torch.ops import cuda_attn
    from beach_seg_tpu_torch.ops.attention import attention_bwd_plain

    gh, gw = GRID
    bh = B * HEADS
    fp32 = dtype == torch.float32
    args = (*attn_bwd_inputs(device, bh, hd=hd, dtype=dtype), hd**-0.5)
    got = cuda_attn.attn_bwd(*args)
    torch.cuda.synchronize()
    want = attention_bwd_plain(*args)
    errs = bwd_out_check(f"attn_bwd{where}", got, want, fp32)
    del got, want
    torch.cuda.empty_cache()
    res = {"attn_bwd_err": max(errs.values()), "attn_bwd_errs": errs}
    res["attn_bwd_ms"] = time_ms(lambda: cuda_attn.attn_bwd(*args), iters=3 if fp32 else 10, warmup=1 if fp32 else 2)
    res["attn_bwd_plain_ms"] = time_ms(lambda: attention_bwd_plain(*args), iters=2)
    torch.cuda.empty_cache()
    res["attn_bwd_library_ms"] = time_ms(sdpa_bwd_yardstick(*args[:6]), iters=3 if fp32 else 10, warmup=2)
    res["attn_bwd_bound"] = attn_bwd_bound(bh, gh * gw, gh, gw, hd, dtype.itemsize, PEAK_FP32_TC if fp32 else PEAK_BF16)
    del args
    torch.cuda.empty_cache()
    return res


def phase_bwd_kernels(device) -> dict:
    """The two backward kernels against their plain versions at the train
    path's B=8 shapes, then times."""
    from beach_seg_tpu_torch.ops import cuda_mlp

    res = attn_bwd_check(device, HD, "")
    n = B * GRID[0] * GRID[1]
    *head, _, gy = mlp_inputs(device, 3, n, C, MLP)
    res.update(mlp_check("mlp_dx", cuda_mlp.ln_mlp_dx, cuda_mlp.ln_mlp_dx_plain, (*head, gy, 1e-6, True), MLP_DX_REL_TOL, ""))
    res["mlp_dx_bound"] = mlp_dx_bound(n)
    log(
        f"times (ms, B={B}): attn_bwd kernel {res['attn_bwd_ms']:.4f} plain {res['attn_bwd_plain_ms']:.4f} "
        f"sdpa bwd {res['attn_bwd_library_ms']:.4f} bound {res['attn_bwd_bound'][0]:.4f} ({res['attn_bwd_bound'][1]}); "
        f"ln_mlp_dx kernel {res['mlp_dx_ms']:.4f} plain {res['mlp_dx_plain_ms']:.4f} "
        f"bound {res['mlp_dx_bound'][0]:.4f} ({res['mlp_dx_bound'][1]}) chain {res['mlp_dx_chain_ms']:.4f}"
    )
    return res


def packed_bound(bh: int, s: int, hk: int, wk: int, hd: int, itemsize: int, peak: float) -> tuple[float, str]:
    flops = 4 * bh * s * s * hd  # QKᵀ, PV
    nbytes = itemsize * (4 * bh * s * hd + bh * s * (hk + wk))  # q, k, v, rel terms in; out
    return bound(flops, nbytes, peak)


def packed_inputs(device, dtype, bh: int, hd: int, seed: int = 4, grid=GRID):
    """q, k, v (B·H, S, hd) and the rel terms at the scale the model's
    rel-pos tables give them."""
    g = torch.Generator(device=device).manual_seed(seed)
    gh, gw = grid
    s = gh * gw
    r = lambda *shape, sc=1.0: (sc * torch.randn(shape, generator=g, device=device)).to(dtype)  # noqa: E731
    return r(bh, s, hd), r(bh, s, hd), r(bh, s, hd), r(bh, s, gh, sc=0.5), r(bh, s, gw, sc=0.5)


def sdpa_packed_yardstick(q, k, v, rel_h, rel_w):
    """One PyTorch call computing the same attention: SDPA over (B, H, S, D)
    q, k, v with the (B, H, S, S) rel-pos bias materialized."""
    from torch.nn import functional as F

    bh, s, d = q.shape
    gw = GRID[1]
    kidx = torch.arange(s, device=q.device)
    mask = (rel_h[..., kidx // gw] + rel_w[..., kidx % gw]).reshape(bh // HEADS, HEADS, s, s).contiguous()
    qq, kk, vv = (t.reshape(bh // HEADS, HEADS, s, d) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, scale=d**-0.5)


def phase_kernels_vit_h(device) -> dict:
    """The kernels of the ViT-H path against their plain versions at its
    B=8 shapes, then times: the packed attention (bf16, the path, and
    fp32), the attention backward at head_dim 80, the LN→MLP and its dx at
    C=1280."""
    from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp
    from beach_seg_tpu_torch.ops.attention import attention_packed_plain

    res = {}
    gh, gw = GRID
    s, bh = gh * gw, B * HEADS
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        args = (*packed_inputs(device, dtype, bh, HD_H), HD_H**-0.5, HEADS)
        res[f"packed_err_{name}"] = fwd_check(f"attn_packed {name} (ViT-H)", cuda_attn.attn_packed, attention_packed_plain,
                                              args, (B, s, C_H))
        res[f"packed_ms_{name}"] = time_ms(lambda: cuda_attn.attn_packed(*args), iters=20 if name == "bf16" else 10, warmup=2)
        res[f"packed_plain_ms_{name}"] = time_ms(lambda: attention_packed_plain(*args), iters=2)
        if name == "fp32":
            res["packed_library_ms_fp32"] = time_ms(sdpa_packed_yardstick(*args[:5]), iters=10, warmup=1)
        res[f"packed_bound_{name}"] = packed_bound(bh, s, gh, gw, HD_H, dtype.itemsize, PEAK_BF16 if name == "bf16" else PEAK_FP32_TC)
        torch.cuda.empty_cache()
    # SDPA yardstick on the bf16 inputs (args still hold them)
    res["packed_library_ms"] = time_ms(sdpa_packed_yardstick(*args[:5]), iters=20, warmup=2)
    del args
    torch.cuda.empty_cache()

    res.update(attn_bwd_check(device, HD_H, " (head_dim 80)"))
    n = B * s
    *head, b2, gy = mlp_inputs(device, 5, n, C_H, MLP_H)
    where = f" (C={C_H})"
    res.update(mlp_check("mlp", cuda_mlp.ln_mlp, cuda_mlp.ln_mlp_plain, (*head, b2, 1e-6, True), MLP_BF16_REL_TOL, where))
    res.update(mlp_check("mlp_dx", cuda_mlp.ln_mlp_dx, cuda_mlp.ln_mlp_dx_plain, (*head, gy, 1e-6, True), MLP_DX_REL_TOL, where))
    res["mlp_bound"] = mlp_bound(n, C_H, MLP_H)
    res["mlp_dx_bound"] = mlp_dx_bound(n, C_H, MLP_H)
    log(
        f"times (ms, ViT-H, B={B}): attn_packed bf16 {res['packed_ms_bf16']:.4f} plain {res['packed_plain_ms_bf16']:.4f} "
        f"sdpa {res['packed_library_ms']:.4f} bound {res['packed_bound_bf16'][0]:.4f} ({res['packed_bound_bf16'][1]}); "
        f"attn_packed fp32 {res['packed_ms_fp32']:.4f} plain {res['packed_plain_ms_fp32']:.4f} "
        f"sdpa {res['packed_library_ms_fp32']:.4f} bound {res['packed_bound_fp32'][0]:.4f} ({res['packed_bound_fp32'][1]}); "
        f"attn_bwd {res['attn_bwd_ms']:.4f} plain {res['attn_bwd_plain_ms']:.4f} sdpa bwd {res['attn_bwd_library_ms']:.4f} "
        f"bound {res['attn_bwd_bound'][0]:.4f}; ln_mlp {res['mlp_ms']:.4f} plain {res['mlp_plain_ms']:.4f} "
        f"bound {res['mlp_bound'][0]:.4f} chain {res['mlp_chain_ms']:.4f}; ln_mlp_dx {res['mlp_dx_ms']:.4f} "
        f"plain {res['mlp_dx_plain_ms']:.4f} bound {res['mlp_dx_bound'][0]:.4f} chain {res['mlp_dx_chain_ms']:.4f}"
    )
    torch.cuda.empty_cache()
    return res


def qkv_slot_inputs(device, dtype, seed: int = 6, grid=GRID):
    """qkv (B, S, 3C) and its rel terms in the 64-slot layout, made by the
    port's ``rel_pos_terms_split`` from qkv's q columns and seeded rel-pos
    tables, as ``scripts/bench_torch_attn_parts.py`` makes them."""
    from beach_seg_tpu_torch.ops.attention import rel_pos_terms_split

    g = torch.Generator(device=device).manual_seed(seed)
    gh, gw = grid
    qkv = torch.randn((B, gh * gw, 3 * C), generator=g, device=device).to(dtype)
    rph = (0.1 * torch.randn((2 * gh - 1, HD), generator=g, device=device)).to(dtype)
    rpw = (0.1 * torch.randn((2 * gw - 1, HD), generator=g, device=device)).to(dtype)
    return qkv, rph, rpw, rel_pos_terms_split(qkv[..., :C].reshape(B, gh, gw, HEADS, HD), rph, rpw, grid, grid)


def sdpa_qkv_yardstick(qkv, rel_h64, rel_w64):
    """SDPA with the materialized bias over the heads of the qkv tensor and
    the slot terms (the head split is made before the timed call)."""
    from beach_seg_tpu_torch.ops.attention import split_qkv, unpack_rel_slots

    q, k, v = split_qkv(qkv, HEADS)
    return sdpa_packed_yardstick(q, k, v, unpack_rel_slots(rel_h64, HEADS, GRID[0]), unpack_rel_slots(rel_w64, HEADS, GRID[1]))


def fwd_check(name: str, fn, plain, args, shape) -> float:
    """A forward attention kernel against its plain version on the same
    inputs (``attn_out_check``); returns the largest error."""
    got = fn(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    check(tuple(got.shape) == tuple(want.shape) == shape, f"{name} shape {tuple(got.shape)}, want {shape}")
    err = attn_out_check(name, got, want)
    del got, want
    torch.cuda.empty_cache()
    return err


def phase_library_kernels(device) -> dict:
    """The kernels behind the library's attention entries against their
    plain versions at B=8 ViT-L shapes, bf16 and fp32, then times: the fused
    attention (#7, head-split in and out) and the qkv-layout attention (#6),
    beside SDPA with the materialized bias; then the attention backward
    (#4) in fp32 at head dims 64 and 80, beside SDPA's fp32 backward."""
    from beach_seg_tpu_torch.ops import cuda_attn
    from beach_seg_tpu_torch.ops.attention import attention_fused_plain, attention_qkv_plain

    res = {}
    gh, gw = GRID
    s, bh = gh * gw, B * HEADS
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        fp32 = name == "fp32"
        peak = PEAK_FP32_TC if fp32 else PEAK_BF16
        iters = 10 if fp32 else 20
        q, k, v, rel_h, rel_w = packed_inputs(device, dtype, bh, HD, seed=8)
        args = (q, k, v, rel_h, rel_w, HD**-0.5)
        res[f"fused_err_{name}"] = fwd_check(f"attn_fused {name}", cuda_attn.attn_fused, attention_fused_plain, args, (bh, s, HD))
        res[f"fused_ms_{name}"] = time_ms(lambda: cuda_attn.attn_fused(*args), iters=iters, warmup=2)
        res[f"fused_plain_ms_{name}"] = time_ms(lambda: attention_fused_plain(*args), iters=2)
        res[f"fused_library_ms_{name}"] = time_ms(sdpa_packed_yardstick(q, k, v, rel_h, rel_w), iters=iters, warmup=2)
        res[f"fused_bound_{name}"] = packed_bound(bh, s, gh, gw, HD, dtype.itemsize, peak)
        del q, k, v, rel_h, rel_w, args
        torch.cuda.empty_cache()

        qkv, _, _, (rh64, rw64) = qkv_slot_inputs(device, dtype)
        args = (qkv, rh64, rw64, HD**-0.5, gh, gw, HEADS)
        res[f"qkv_err_{name}"] = fwd_check(f"attn_qkv {name}", cuda_attn.attn_qkv, attention_qkv_plain, args, (B, s, C))
        res[f"qkv_ms_{name}"] = time_ms(lambda: cuda_attn.attn_qkv(*args), iters=iters, warmup=2)
        res[f"qkv_plain_ms_{name}"] = time_ms(lambda: attention_qkv_plain(*args), iters=2)
        res[f"qkv_library_ms_{name}"] = time_ms(sdpa_qkv_yardstick(qkv, rh64, rw64), iters=iters, warmup=2)
        # the kernel reads qkv, the Hk + Wk used slots of each head's 64, and writes out
        flops = 4 * bh * s * s * HD
        nbytes = dtype.itemsize * (B * s * 3 * C + bh * s * (gh + gw) + B * s * C)
        res[f"qkv_bound_{name}"] = bound(flops, nbytes, peak)
        del qkv, rh64, rw64, args
        torch.cuda.empty_cache()
    for hd in (HD, HD_H):
        r = attn_bwd_check(device, hd, f" fp32 (head_dim {hd})", torch.float32)
        res[f"bwd32_{hd}"] = r
    log(
        f"times (ms, B={B}): attn_fused bf16 {res['fused_ms_bf16']:.4f} plain {res['fused_plain_ms_bf16']:.4f} "
        f"sdpa {res['fused_library_ms_bf16']:.4f} bound {res['fused_bound_bf16'][0]:.4f}; fp32 {res['fused_ms_fp32']:.4f} "
        f"plain {res['fused_plain_ms_fp32']:.4f} sdpa {res['fused_library_ms_fp32']:.4f} bound {res['fused_bound_fp32'][0]:.4f}; "
        f"attn_qkv bf16 {res['qkv_ms_bf16']:.4f} plain {res['qkv_plain_ms_bf16']:.4f} sdpa {res['qkv_library_ms_bf16']:.4f} "
        f"bound {res['qkv_bound_bf16'][0]:.4f}; fp32 {res['qkv_ms_fp32']:.4f} plain {res['qkv_plain_ms_fp32']:.4f} "
        f"sdpa {res['qkv_library_ms_fp32']:.4f} bound {res['qkv_bound_fp32'][0]:.4f}; "
        + "; ".join(
            f"attn_bwd fp32 head_dim {hd} {r['attn_bwd_ms']:.4f} plain {r['attn_bwd_plain_ms']:.4f} "
            f"sdpa bwd {r['attn_bwd_library_ms']:.4f} bound {r['attn_bwd_bound'][0]:.4f}"
            for hd, r in ((hd, res[f"bwd32_{hd}"]) for hd in (HD, HD_H))
        )
    )
    return res


def phase_entries(device) -> dict:
    """The library's attention entries forward and backward at B=8, bf16 and
    fp32: ``fused_attention`` at head dims 64 and 80 with rel terms from
    ``rel_pos_terms``, and ``fused_attention_qkv`` with rel terms from
    ``rel_pos_terms_split`` inside the graph. Each call must launch its
    forward kernel once and the attention backward once, nothing else; the
    output and the input gradients of a seeded cotangent are held against
    the same call through the plain versions (the phases' kernel
    tolerances: the output by ``attn_out_check``, the gradients within
    ATTN_BWD_REL_TOL of their scale, fp32 ATTN_BWD_FP32_REL_TOL)."""
    from beach_seg_tpu_torch.ops import cuda_attn
    from beach_seg_tpu_torch.ops.attention import rel_pos_terms, rel_pos_terms_split

    gh, gw = GRID
    s, bh = gh * gw, B * HEADS
    res = {}
    cases = [("fused_attention", hd, dt) for hd in (HD, HD_H) for dt in (torch.bfloat16, torch.float32)]
    cases += [("fused_attention_qkv", HD, dt) for dt in (torch.bfloat16, torch.float32)]
    for entry, hd, dtype in cases:
        fp32 = dtype == torch.float32
        key = f"{entry} {'fp32' if fp32 else 'bf16'} head_dim {hd}"
        gen = torch.Generator(device=device).manual_seed(9)
        if entry == "fused_attention":
            q, k, v = (torch.randn((bh, s, hd), generator=gen, device=device).to(dtype) for _ in range(3))
            rph = (0.1 * torch.randn((2 * gh - 1, hd), generator=gen, device=device)).to(dtype)
            rpw = (0.1 * torch.randn((2 * gw - 1, hd), generator=gen, device=device)).to(dtype)
            leaves = [t.requires_grad_(True) for t in (q, k, v)]

            def call(q, k, v):
                rel_h, rel_w = rel_pos_terms(q, rph, rpw, GRID, GRID)
                return cuda_attn.fused_attention(q, k, v, rel_h.reshape(bh, s, gh), rel_w.reshape(bh, s, gw), hd**-0.5, gh, gw)

            fwd_name, out_shape = "attn_fused", (bh, s, hd)
        else:
            qkv, rph, rpw, _ = qkv_slot_inputs(device, dtype)
            leaves = [qkv.requires_grad_(True)]

            def call(qkv):
                rh64, rw64 = rel_pos_terms_split(qkv[..., :C].reshape(B, gh, gw, HEADS, HD), rph, rpw, GRID, GRID)
                return cuda_attn.fused_attention_qkv(qkv, rh64, rw64, HD**-0.5, gh, gw, HEADS)

            fwd_name, out_shape = "attn_qkv", (B, s, C)
        cot = torch.randn(out_shape, generator=gen, device=device).to(dtype)
        reset_counts()
        out = call(*leaves)
        grads = torch.autograd.grad(out, leaves, cot)
        torch.cuda.synchronize()
        launches = read_counts()
        want_launches = {n: int(n in (fwd_name, "attn_bwd")) for n in launches}
        check(launches == want_launches, f"{key}: launches {launches}, want {want_launches}")
        with plain_kernels():
            out_p = call(*leaves)
            grads_p = torch.autograd.grad(out_p, leaves, cot)
        torch.cuda.synchronize()
        check(tuple(out.shape) == out_shape, f"{key}: output {tuple(out.shape)}")
        errs = {"out": attn_out_check(f"entry {key} output", out, out_p)}
        rel = ATTN_BWD_FP32_REL_TOL if fp32 else ATTN_BWD_REL_TOL
        for name, a, w in zip(("dq", "dk", "dv") if len(leaves) == 3 else ("dqkv",), grads, grads_p):
            scale = w.float().abs().max().item()
            errs[name] = (a.float() - w.float()).abs().max().item()
            check(bool(torch.isfinite(a).all()), f"{key}: {name} not finite")
            check(errs[name] <= rel * scale, f"{key}: {name} disagrees with plain: {errs[name]} > {rel} x {scale}")
        log(f"entry {key}: launches {launches}; max_abs_err vs plain {errs}")
        res[key] = {"launches": launches, "errs": errs}
        del out, grads, out_p, grads_p, leaves
        torch.cuda.empty_cache()
    return res


def phase_small_head_dims(device) -> dict:
    """#3, #7 and #4 at head dims 16 and 8 (zero-padded to 16 by the
    wrappers), bf16 and fp32, at B=8 tiles of the debug backbone's 4 heads
    on the ViT grid, against their plain versions with the tolerances of
    head dims 64 and 80; the head_dim-16 bf16 instances timed."""
    from beach_seg_tpu_torch.ops import cuda_attn
    from beach_seg_tpu_torch.ops.attention import attention_bwd_plain, attention_fused_plain, attention_packed_plain

    gh, gw = GRID
    heads = 4
    bh, s = B * heads, gh * gw
    res = {}
    for hd in (16, 8):
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            fp32 = dtype == torch.float32
            q, k, v, rel_h, rel_w = packed_inputs(device, dtype, bh, hd, seed=10)
            args = (q, k, v, rel_h, rel_w, hd**-0.5, heads)
            res[f"packed_err_{name}_hd{hd}"] = fwd_check(f"attn_packed {name} head_dim {hd}", cuda_attn.attn_packed,
                                                         attention_packed_plain, args, (B, s, heads * hd))
            args = (q, k, v, rel_h, rel_w, hd**-0.5)
            res[f"fused_err_{name}_hd{hd}"] = fwd_check(f"attn_fused {name} head_dim {hd}", cuda_attn.attn_fused,
                                                        attention_fused_plain, args, (bh, s, hd))
            g = packed_inputs(device, dtype, bh, hd, seed=11)[0]
            args = (q, k, v, rel_h, rel_w, g, hd**-0.5)
            got = cuda_attn.attn_bwd(*args)
            torch.cuda.synchronize()
            res[f"bwd_errs_{name}_hd{hd}"] = bwd_out_check(f"attn_bwd {name} head_dim {hd}", got, attention_bwd_plain(*args), fp32)
            if hd == 16 and not fp32:
                res["packed_ms_hd16"] = time_ms(lambda: cuda_attn.attn_packed(q, k, v, rel_h, rel_w, hd**-0.5, heads), iters=20, warmup=2)
                res["bwd_ms_hd16"] = time_ms(lambda: cuda_attn.attn_bwd(*args), iters=10, warmup=2)
            del q, k, v, rel_h, rel_w, g, args, got
            torch.cuda.empty_cache()
    log(f"times (ms, B={B}, 4 heads of 16, bf16): attn_packed {res['packed_ms_hd16']:.4f}; attn_bwd {res['bwd_ms_hd16']:.4f}")
    return res


def phase_chunk_crossing(device) -> dict:
    """#3, #7 and #4 at head dims 64 and 80, and #6, in bf16 and fp32, and
    #1 bf16 in its three softmax modes, at B=8 tiles of 16 heads on
    GRID_CROSS, where key tiles cross rel_h slot chunks and the last tile is
    ragged, against their plain versions with the phases' tolerances.
    Returns the largest errors by kernel and dtype."""
    from beach_seg_tpu_torch.ops import cuda_attn
    from beach_seg_tpu_torch.ops.attention import (attention_bwd_plain, attention_fused_plain, attention_packed_plain,
                                                   attention_qkv_plain)

    gh, gw = GRID_CROSS
    bh, s = B * HEADS, gh * gw
    res = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for hd in (HD, HD_H):
            where = f"{name} head_dim {hd} grid {GRID_CROSS}"
            q, k, v, rel_h, rel_w = packed_inputs(device, dtype, bh, hd, seed=12, grid=GRID_CROSS)
            res[f"packed_{name}_hd{hd}"] = fwd_check(f"attn_packed {where}", cuda_attn.attn_packed, attention_packed_plain,
                                                     (q, k, v, rel_h, rel_w, hd**-0.5, HEADS), (B, s, HEADS * hd))
            res[f"fused_{name}_hd{hd}"] = fwd_check(f"attn_fused {where}", cuda_attn.attn_fused, attention_fused_plain,
                                                    (q, k, v, rel_h, rel_w, hd**-0.5), (bh, s, hd))
            args = (q, k, v, rel_h, rel_w, packed_inputs(device, dtype, bh, hd, seed=13, grid=GRID_CROSS)[0], hd**-0.5)
            got = cuda_attn.attn_bwd(*args)
            torch.cuda.synchronize()
            res[f"bwd_{name}_hd{hd}"] = bwd_out_check(f"attn_bwd {where}", got, attention_bwd_plain(*args), dtype == torch.float32)
            del q, k, v, rel_h, rel_w, args, got
        qkv, _, _, (rh64, rw64) = qkv_slot_inputs(device, dtype, seed=14, grid=GRID_CROSS)
        res[f"qkv_{name}"] = fwd_check(f"attn_qkv {name} grid {GRID_CROSS}", cuda_attn.attn_qkv, attention_qkv_plain,
                                       (qkv, rh64, rw64, HD**-0.5, gh, gw, HEADS), (B, s, C))
        del qkv, rh64, rw64
        torch.cuda.empty_cache()
    inputs = attn_inputs(torch.bfloat16, device, seed=15, grid=GRID_CROSS)
    for softmax in SOFTMAX_MODES:
        res[f"qkv_rel_bf16_{softmax}"] = fwd_check(f"attn_qkv_rel bf16 {softmax} grid {GRID_CROSS}", cuda_attn.attn_qkv_rel,
                                                   cuda_attn.attn_qkv_rel_plain, (*inputs, HD**-0.5, gw, HEADS, softmax),
                                                   (B, s, C))
    del inputs
    torch.cuda.empty_cache()
    return res


def phase_debug_backbone(device, dtype) -> dict:
    """The debug backbone through predict_step and train_step in ``dtype``:
    #3 (and #2 under bf16) once per layer per call, #3 and #4 (and #2, #5)
    once per layer per step; pred_masks and the prompt gradient against the
    plain versions (phases 5–6's limits; fp32 phase 12's gradient limits)."""
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.train.loop import model_for_config

    fp32 = dtype == torch.float32
    conf = BeachSegConfig(debug=True, batch_size=B, compute_dtype="float32" if fp32 else "bfloat16")
    model, cfg = model_for_config(conf, device=device, seed=0)
    check(cfg.head_dim == 16 and cfg.hidden_size == 64, f"debug config {cfg}")
    n = cfg.num_hidden_layers
    fwd = {"attn_packed": n} if fp32 else {"attn_packed": n, "ln_mlp": n}
    bwd = {"attn_bwd": n} if fp32 else {"attn_bwd": n, "ln_mlp_dx": n}
    m = phase_main_path(device, model, conf, fwd, n_batches=2 if fp32 else 3)
    tr = phase_train_path(device, model, conf, dict(fwd, **bwd), n_steps=2 if fp32 else 3,
                          grad_limits=(GRAD32_1MCOS_MAX, GRAD32_REL_TOL) if fp32 else (GRAD_1MCOS_MAX, GRAD_REL_TOL))
    check(m["launches"]["attn_packed"] > 0 and tr["launches"]["attn_bwd"] > 0, "debug backbone did not run #3 and #4")
    del model
    torch.cuda.empty_cache()
    return {"predict": m, "train": tr}


@contextlib.contextmanager
def plain_kernels():
    """Route the model through the plain versions on the card, forward and
    backward, for the reference runs only (the library itself never does
    this)."""
    from beach_seg_tpu_torch.ops import attention, cuda_attn, cuda_mlp

    names = ((cuda_attn, "attn_qkv_rel", cuda_attn.attn_qkv_rel_plain), (cuda_attn, "attn_bwd", attention.attention_bwd_plain),
             (cuda_mlp, "ln_mlp", cuda_mlp.ln_mlp_plain), (cuda_mlp, "ln_mlp_dx", cuda_mlp.ln_mlp_dx_plain),
             (cuda_attn, "attn_packed", attention.attention_packed_plain),
             (cuda_attn, "attn_fused", attention.attention_fused_plain),
             (cuda_attn, "attn_qkv", attention.attention_qkv_plain))
    saved = [getattr(mod, name) for mod, name, _ in names]
    for mod, name, plain in names:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(names, saved):
            setattr(mod, name, fn)


def main_path_inputs(conf, n_prompts: int, n_batches: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    size = conf.inpt_size
    # blocky class maps (16-pixel cells) make the prompts look like masks
    cells = rng.integers(0, len(conf.classes), (n_prompts, size // 16, size // 16))
    prompts = (
        rng.random((n_prompts, size, size, 3), dtype=np.float32),
        np.repeat(np.repeat(cells, 16, axis=1), 16, axis=2).astype(np.int32),
        np.zeros((n_prompts, size, size), bool),
    )
    batches = [
        {
            "image_u8": rng.integers(0, 256, (conf.batch_size, conf.crop_size, conf.crop_size, 3), dtype=np.uint8),
            "crop_idx": rng.integers(0, n_prompts, (conf.batch_size,)).astype(np.int32),
        }
        for _ in range(n_batches)
    ]
    return prompts, batches


def phase_main_path(device, model, conf, expect: dict, n_batches: int = 3) -> dict:
    """PromptTuner.predict_step on ``n_batches`` batches of B crops; each
    call must launch the kernels ``expect`` names that many times and the
    others not at all; one batch's pred_masks held against the plain
    versions."""
    from beach_seg_tpu_torch.train import PromptTuner
    from beach_seg_tpu_torch.transforms import decode_by_palette

    n_prompts = 4
    tuner = PromptTuner(model, conf, device=device)
    prompts, batches = main_path_inputs(conf, n_prompts, n_batches)
    want_calls = {name: expect.get(name, 0) for name in counters()}

    reset_counts()
    seconds, per_call = [], []
    for batch in batches:
        before = read_counts()
        t = time.perf_counter()
        ids = tuner.predict_step(*prompts, batch, out_size=conf.crop_size)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        now = read_counts()
        per_call.append({k: now[k] - before[k] for k in now})
        check(tuple(ids.shape) == (B, conf.crop_size, conf.crop_size), f"ids shape {tuple(ids.shape)}")
        check(ids.dtype == torch.uint8 and ids.device.type == "cuda", f"ids {ids.dtype} on {ids.device}")
        check(int(ids.max()) < len(conf.classes), f"id {int(ids.max())} out of range")
    launches = read_counts()
    log(f"main path: predict_step seconds per call {seconds}; launches per call {per_call}")
    check(all(pc == want_calls for pc in per_call), f"launches per call {per_call}, want {want_calls}")

    pred, pal = tuner.predict_masks(*prompts, batches[0])
    with plain_kernels():
        want, _ = tuner.predict_masks(*prompts, batches[0])
    torch.cuda.synchronize()
    check(bool(torch.isfinite(pred).all()), "pred_masks not finite")
    err = (pred - want).abs().max().item()
    scale = want.abs().max().item()
    h = pred.shape[1] // 2
    differ = decode_by_palette(pred[:, h:], pal) != decode_by_palette(want[:, h:], pal)
    agree = 1.0 - differ.float().mean().item()
    # an id may flip only where the plain path's top-two palette scores
    # (2x·p − |p|²) are closer than a per-channel change of `err` can move
    # them: 2·err·max‖p_n − p_m‖₁
    x = want[:, h:].reshape(B, -1, 3)
    p = pal[0]
    scores = torch.einsum("bqc,nc->bqn", x, p) * 2.0 - (p * p).sum(-1)
    top2 = scores.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).reshape(differ.shape)
    reach = 2 * err * (p[:, None] - p[None]).abs().sum(-1).max().item()
    worst = margin[differ].max().item() if differ.any() else 0.0
    log(
        f"main path: pred_masks kernels vs plain on the card: max_abs_err {err:.4e} "
        f"(tol {PRED_REL_TOL}·max|plain| {scale:.4f}), id agreement {agree:.6f} (min {ID_AGREEMENT_MIN}); "
        f"largest score margin at a differing id {worst:.4e} (reach of the error {reach:.4e})"
    )
    check(err <= PRED_REL_TOL * scale, f"pred_masks disagree: {err} > {PRED_REL_TOL * scale}")
    check(agree >= ID_AGREEMENT_MIN, f"id agreement {agree}")
    check(worst <= reach, f"an id differs {worst} from a decision boundary, beyond the error's reach {reach}")
    return {"launches": launches, "seconds": seconds, "pred_err": err, "id_agreement": agree}


def train_path_inputs(conf, n_prompts: int, n_steps: int, seed: int = 1):
    """Seeded prompts (blocky class maps, some nodata) and train batches of
    conf.batch_size inpt_size tiles shaped like scripts/bench_train.py's."""
    rng = np.random.default_rng(seed)
    s = conf.inpt_size
    cells = rng.integers(0, len(conf.classes), (n_prompts, s // 16, s // 16))
    prompts = (
        rng.random((n_prompts, s, s, 3), dtype=np.float32),
        np.repeat(np.repeat(cells, 16, axis=1), 16, axis=2).astype(np.int32),
        rng.random((n_prompts, s, s)) < 0.05,
    )
    b = conf.batch_size
    batches = [
        {
            "image": rng.random((b, s, s, 3), dtype=np.float32),
            "mask": rng.integers(0, len(conf.classes), (b, s, s)).astype(np.int32),
            "nodata": np.zeros((b, s, s), bool),
            "crop_idx": rng.integers(0, n_prompts, (b,)).astype(np.int32),
            "valid": np.ones((b,), bool),
        }
        for _ in range(n_steps)
    ]
    return prompts, batches


def phase_train_path(device, model, conf, expect: dict, n_steps: int = 3,
                     grad_limits: tuple[float, float] = (GRAD_1MCOS_MAX, GRAD_REL_TOL)) -> dict:
    """PromptTuner.train_step at full width (the predict phase's model, now
    with gradients through it), each step launching the kernels ``expect``
    names that many times and the others not at all; then one step's prompt
    gradient through the kernels and through the plain versions on the same
    draws, within ``grad_limits`` (1 − cosine, max error / max|plain|)."""
    from beach_seg_tpu_torch.train import PromptTuner

    want_steps = {name: expect.get(name, 0) for name in counters()}
    tuner = PromptTuner(model, conf, device=device)
    prompts, batches = train_path_inputs(conf, 4, n_steps)
    state = tuner.init_state(prompts[0])
    start = state.prompt_pixels.clone()
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds, losses, per_step = [], [], []
    for batch in batches:
        before = read_counts()
        t = time.perf_counter()
        state, metrics = tuner.train_step(state, prompts[1], prompts[2], batch, generator=gen)
        loss = metrics["loss"].item()  # syncs
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        losses.append(loss)
        now = read_counts()
        per_step.append({k: now[k] - before[k] for k in now})
        check(math.isfinite(loss), f"train loss {loss}")
        check(int(metrics["confusion"].sum()) > 0, "empty confusion matrix")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"train path: train_step seconds per step {seconds}; losses {losses}; launches per step {per_step}; "
        f"peak memory {peak / 2**30:.3f} GiB")
    check(all(ps == want_steps for ps in per_step), f"launches per step {per_step}, want {want_steps}")
    moved = (state.prompt_pixels - start).abs().max().item()
    check(moved > 0, "prompt pixels did not move")
    check(bool(torch.isfinite(state.prompt_pixels).all() and torch.isfinite(state.ema_pixels).all()), "state not finite")

    batch = batches[0]
    draws = tuner.step_draws(batch, 4, torch.Generator(device=device).manual_seed(7))
    _, grad, _, _, _ = tuner.loss_and_grad(state.prompt_pixels, prompts[1], prompts[2], batch, draws)
    with plain_kernels():
        _, want, _, _, _ = tuner.loss_and_grad(state.prompt_pixels, prompts[1], prompts[2], batch, draws)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(grad).all()), "prompt gradient not finite")
    scale = want.abs().max().item()
    median = want.abs().median().item()
    err = (grad - want).abs().max().item()
    cos = (torch.nn.functional.cosine_similarity(grad.flatten(), want.flatten(), dim=0)).item()
    cos_max, rel_tol = grad_limits
    log(f"train path: prompt gradient kernels vs plain on the card: 1 - cosine {1 - cos:.4e} (max {cos_max}), "
        f"max_abs_err {err:.4e} (tol {rel_tol}·max|plain| {scale:.4e} = {rel_tol * scale:.4e}; "
        f"median |plain| {median:.4e})")
    check(scale > 0, "plain prompt gradient is zero")
    check(1 - cos <= cos_max, f"prompt gradient direction disagrees: cosine {cos}")
    check(err <= rel_tol * scale, f"prompt gradient disagrees: {err} > {rel_tol * scale}")
    return {"launches": launches, "seconds": seconds, "losses": losses, "peak_bytes": peak, "grad_cos": cos, "grad_err": err}


# the scene engine's synthetic scene: a 6 km stretch of coast at 3 m pixels,
# 4-band uint16, one reference date and SCENE_DATES predict dates, each date
# two overlapping GeoTIFF tiles
SCENE_W, SCENE_H, SCENE_PIX = 2048, 1024, 3.0
SCENE_DATES = 8
SCENE_EPSG = 32611
SCENE_ORIGIN = (500000.0, 4100000.0)


def shoreline_row(x: np.ndarray, shift: float = 0.0) -> np.ndarray:
    """The wavy water line's row at column ``x`` (two waves, ±85 rows)."""
    return 0.55 * SCENE_H + 60 * np.sin(2 * np.pi * x / 700) + 25 * np.sin(2 * np.pi * x / 230 + 1) + shift


def write_scene(root: Path, n_dates: int = SCENE_DATES, seed: int = 0) -> list[str]:
    """The reference's data layout under ``root``, written with the port's
    geo writers (Masks/Mask_<DATE>.shp, Masks/WaterMask_<DATE>.shp,
    SatelliteImagery/files/<DATE>_{a,b}.tif): water below a wavy shoreline
    across the full width, vegetation above a second wavy line, sand between;
    each date shifts the shoreline a little. → the dates, reference first."""
    from beach_seg_tpu_torch.geo.affine import Affine
    from beach_seg_tpu_torch.geo.geometry import Polygon
    from beach_seg_tpu_torch.geo.shapefile import save_shapefile
    from beach_seg_tpu_torch.geo.tiff import write

    rng = np.random.default_rng(seed)
    x0, y0 = SCENE_ORIGIN
    dates = [f"2024{1 + i // 2:02d}{1 + 14 * (i % 2):02d}" for i in range(n_dates + 1)]
    mask_dir, img_dir = root / "Masks", root / "SatelliteImagery" / "files"
    mask_dir.mkdir(parents=True)
    img_dir.mkdir(parents=True)

    def world(col, row):
        return np.stack([x0 + np.asarray(col) * SCENE_PIX, y0 - np.asarray(row) * SCENE_PIX], axis=1)

    xs = np.linspace(2, SCENE_W - 2, 257)
    water = np.concatenate([world(xs, shoreline_row(xs)), world([SCENE_W - 2, 2], [SCENE_H, SCENE_H])])
    veg = np.concatenate([world(xs, shoreline_row(xs) - 220 + 30 * np.cos(2 * np.pi * xs / 500)), world([SCENE_W - 2, 2], [0, 0])])
    save_shapefile([Polygon(water)], mask_dir / f"WaterMask_{dates[0]}.shp", crs=SCENE_EPSG)
    save_shapefile([Polygon(veg)], mask_dir / f"Mask_{dates[0]}.shp", crs=SCENE_EPSG)

    cols = np.arange(SCENE_W)[None, :]
    rows = np.arange(SCENE_H)[:, None]
    half, lap = SCENE_W // 2, 64
    # the native encoder releases the GIL: the tiles are written on a pool,
    # LZW (the writer's default) and deflate in turns
    with ThreadPoolExecutor(max_workers=8) as pool:
        writes = []
        for i, date in enumerate(dates):
            wet = rows >= shoreline_row(cols, shift=6 * i)
            green = rows < shoreline_row(cols) - 220 + 30 * np.cos(2 * np.pi * cols / 500)
            dry = ~wet & ~green
            bands = np.empty((4, SCENE_H, SCENE_W), np.uint16)
            for b, (wv, sv, vv) in enumerate([(900, 2200, 1200), (1000, 2400, 1300), (1100, 2600, 1500), (400, 2800, 2300)]):
                base = np.where(wet, wv, 0) + np.where(dry, sv, 0) + np.where(green, vv, 0)
                bands[b] = np.clip(base + rng.integers(0, 120, (SCENE_H, SCENE_W)), 1, 65535)
            for tag, c0, c1, compress in (("a", 0, half + lap, "lzw"), ("b", half - lap, SCENE_W, "deflate")):
                t = Affine.from_origin(x0 + c0 * SCENE_PIX, y0, SCENE_PIX, SCENE_PIX)
                writes.append(pool.submit(write, img_dir / f"{date}_{tag}.tif", bands[:, :, c0:c1], t, crs=SCENE_EPSG,
                                          nodata=0, compress=compress))
        for w in writes:
            w.result()
    return dates


def scene_run(data: Path, out: Path, dtype: str, merge: str, overlap: int, expect: dict, crops_by_overlap: dict,
              dates: list[str], plain: bool = False) -> dict:
    """run_predict once on the card (``plain``: through the plain versions);
    its outputs checked for every predict date (a GeoTIFF of the scene's
    shape and CRS with ids in 0..3, the mask PNG, the overlay), timings.json's
    tile count, and the launch counters: ``expect`` (launches per batch) times
    the batches, every other kernel idle."""
    from beach_seg_tpu_torch.config import PredictionConfig
    from beach_seg_tpu_torch.geo.tiff import read
    from beach_seg_tpu_torch.infer import run_predict

    conf = PredictionConfig(data=data, model_training_root=out, checkpoint="random", batch_size=B,
                            compute_dtype=dtype, merge=merge, overlap=overlap)
    crops = crops_by_overlap[overlap]
    n_batches = (len(dates) - 1) * math.ceil(len(crops) / B)
    reset_counts()
    t = time.perf_counter()
    with plain_kernels() if plain else contextlib.nullcontext():
        run_dir = run_predict(conf)
    seconds = time.perf_counter() - t
    launches = read_counts()
    timings = json.loads((run_dir / "timings.json").read_text())
    ids = {}
    for date in dates[1:]:
        r = read(run_dir / "tif" / f"{date}.tif")
        check(r.data.shape == (1, SCENE_H, SCENE_W) and r.crs == f"EPSG:{SCENE_EPSG}", f"{date}: {r.data.shape} {r.crs}")
        check(set(np.unique(r.data).tolist()) <= {0, 1, 2, 3}, f"{date}: ids {np.unique(r.data)}")
        check((run_dir / "masks" / f"{date}.png").stat().st_size > 0 and (run_dir / "images" / f"{date}.png").stat().st_size > 0,
              f"{date}: mask or overlay PNG missing")
        ids[date] = r.data[0]
    # every date covers the whole scene, so each (crop, date) pair whose crop
    # meets the scene has data: the tiles that are not all nodata
    meets = sum(1 for x0, y0, x1, y1 in crops if x1 > 0 and y1 > 0 and x0 < SCENE_W and y0 < SCENE_H)
    check(timings["tiles"] == meets * (len(dates) - 1), f"timings tiles {timings['tiles']}, want {meets * (len(dates) - 1)}")
    want = {name: expect.get(name, 0) * n_batches for name in counters()}
    log(f"scene engine {dtype} {merge} overlap {overlap}{' plain' if plain else ''}: {len(crops)} crops x {len(dates) - 1} dates, {n_batches} batches "
        f"of {B}, {seconds:.3f} s; timings.json {json.dumps(timings)}; launches {launches}")
    check(launches == want, f"scene engine {dtype} {merge}: launches {launches}, want {want}")
    return {"ids": ids, "timings": timings, "seconds": seconds, "launches": launches, "batches": n_batches}


def vote_agreement(got: dict, want: dict, crops: list) -> float:
    """Share of the voted pixels (inside some crop) whose ids are equal."""
    voted = np.zeros((SCENE_H, SCENE_W), bool)
    for x0, y0, x1, y1 in crops:
        voted[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = True
    same = sum(int((got[d] == want[d])[voted].sum()) for d in want)
    return same / (int(voted.sum()) * len(want))


def phase_scene_engine(large: dict, card: str) -> dict:
    """infer.predict.run_predict end to end at full width (ViT-L, random
    weights from the seed): a SCENE_W × SCENE_H, 1 + SCENE_DATES date scene on
    disk → per-date GeoTIFFs, mask PNGs and overlays, in bf16 vote mode, bf16
    blend mode (overlap 56), bf16 vote mode through the plain versions (the
    ids held to ID_AGREEMENT_MIN of the voted pixels) and the default fp32
    vote mode (#1 on its split-TF32 body)."""
    import tempfile

    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.data.dataset import create_scene

    with tempfile.TemporaryDirectory(prefix="chip_smoke_scene_") as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        dates = write_scene(root / "scene")
        crops = {ov: create_scene(BeachSegConfig(data=root / "scene"), train=True, crop_overlap=ov).crops for ov in (0, 56)}
        log(f"scene engine: wrote {SCENE_W}x{SCENE_H} 4-band uint16 at {SCENE_PIX} m, {len(dates)} dates x 2 tiles in "
            f"{time.perf_counter() - t:.3f} s; {len(crops[0])} crops at overlap 0, {len(crops[56])} at 56")
        args = (crops, dates)
        vote = scene_run(root / "scene", root / "out", "bfloat16", "vote", 0, large, *args)
        blend = scene_run(root / "scene", root / "out", "bfloat16", "blend", 56, large, *args)
        plain = scene_run(root / "scene", root / "out", "bfloat16", "vote", 0, {}, *args, plain=True)
        agree = vote_agreement(vote["ids"], plain["ids"], crops[0])
        log(f"scene engine: bf16 vote mosaics kernels vs plain: {agree:.6f} of voted pixels equal (min {ID_AGREEMENT_MIN})")
        check(agree >= ID_AGREEMENT_MIN, f"bf16 vote mosaics agree on {agree} of voted pixels")
        fp32 = scene_run(root / "scene", root / "out", "float32", "vote", 0, {"attn_qkv_rel": 24}, *args)
    runs = {"bf16_vote": vote, "bf16_blend_overlap56": blend, "bf16_vote_plain": plain, "fp32_vote": fp32}
    for name, r in runs.items():
        log(f"scene engine {name}: stream_tiles_per_sec {r['timings']['stream_tiles_per_sec']}, run {r['seconds']:.3f} s, "
            f"timings {json.dumps(r['timings'])} ({card})")
    return {"runs": runs, "agreement_bf16": agree}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.models.seggpt import SegGPTConfig, build_model
    from beach_seg_tpu_torch.ops import build
    from beach_seg_tpu_torch.train.loop import model_for_config
    from beach_seg_tpu_torch.utils import resolve_device

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    device = resolve_device("cuda")

    t = time.perf_counter()
    info = build.build(*build.KERNELS)
    log(f"build: {time.perf_counter() - t:.3f} s wall")
    for name in build.KERNELS:
        log(f"  {name}: {info[name]['seconds']:.3f} s")
        for line in info[name]["log"].splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"    {line.strip()}")

    t = time.perf_counter()
    k = phase_kernels(device)
    log(f"kernel phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    kb = phase_bwd_kernels(device)
    log(f"backward kernel phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    kh = phase_kernels_vit_h(device)
    log(f"ViT-H kernel phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    kst = phase_mlp_stages(device)
    log(f"MLP stage kernel phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    kl = phase_library_kernels(device)
    log(f"library kernel phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    ke = phase_entries(device)
    log(f"entry path phase: {time.perf_counter() - t:.3f} s")

    large = {"attn_qkv_rel": 24, "ln_mlp": 24}
    huge = {"attn_packed": 32, "ln_mlp": 32}
    backward = ("attn_bwd", "ln_mlp_dx")
    t = time.perf_counter()
    conf = BeachSegConfig(batch_size=B)
    model = build_model(SegGPTConfig(), torch.bfloat16, device=device, seed=0)
    log(f"main path: ViT-L {model.config.num_hidden_layers} layers bf16 built in {time.perf_counter() - t:.3f} s")
    m = phase_main_path(device, model, conf, with_stages(large))
    log(f"main path phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    tr = phase_train_path(device, model, conf, with_stages(dict(large, **{k: 24 for k in backward})))
    log(f"train path phase: {time.perf_counter() - t:.3f} s")
    del model
    torch.cuda.empty_cache()

    t = time.perf_counter()
    conf_h = BeachSegConfig(batch_size=B, backbone="huge", compute_dtype="bfloat16")
    model, cfg_h = model_for_config(conf_h, device=device, seed=0)
    check(cfg_h.head_dim == HD_H and cfg_h.hidden_size == C_H and cfg_h.num_hidden_layers == 32, f"ViT-H config {cfg_h}")
    log(f"ViT-H predict path: {cfg_h.num_hidden_layers} layers, C={cfg_h.hidden_size}, head_dim {cfg_h.head_dim}, "
        f"bf16, built in {time.perf_counter() - t:.3f} s")
    mh = phase_main_path(device, model, conf_h, with_stages(huge))
    log(f"ViT-H predict path phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    trh = phase_train_path(device, model, conf_h, with_stages(dict(huge, **{k: 32 for k in backward})))
    log(f"ViT-H train path phase: {time.perf_counter() - t:.3f} s")
    del model
    torch.cuda.empty_cache()

    t = time.perf_counter()
    ks = phase_small_head_dims(device)
    log(f"small head-dim kernel phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    kc = phase_chunk_crossing(device)
    log(f"chunk-crossing grid phase: {time.perf_counter() - t:.3f} s")
    dbg = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        t = time.perf_counter()
        dbg[name] = phase_debug_backbone(device, dtype)
        log(f"debug backbone {name} phase: {time.perf_counter() - t:.3f} s")

    # the default BeachSegConfig: fp32 ViT-L (the MLP stays plain torch under fp32)
    t = time.perf_counter()
    conf32 = BeachSegConfig(batch_size=B)
    check(conf32.compute_dtype == "float32" and conf32.backbone == "large", f"default config {conf32}")
    model, cfg32 = model_for_config(conf32, device=device, seed=0)
    check(cfg32.head_dim == HD and cfg32.num_hidden_layers == 24, f"fp32 ViT-L config {cfg32}")
    log(f"fp32 predict path: ViT-L from the default BeachSegConfig, built in {time.perf_counter() - t:.3f} s")
    m32 = phase_main_path(device, model, conf32, {"attn_qkv_rel": 24}, n_batches=2)
    log(f"fp32 predict path phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    tr32 = phase_train_path(device, model, conf32, {"attn_qkv_rel": 24, "attn_bwd": 24}, n_steps=2,
                            grad_limits=(GRAD32_1MCOS_MAX, GRAD32_REL_TOL))
    log(f"fp32 train path phase: {time.perf_counter() - t:.3f} s")
    del model
    torch.cuda.empty_cache()

    # the full-size ViT-H at its default fp32: #3 on its split-TF32 body
    t = time.perf_counter()
    conf_h32 = BeachSegConfig(batch_size=B, backbone="huge")
    check(conf_h32.compute_dtype == "float32", f"ViT-H default config {conf_h32}")
    model, cfg_h32 = model_for_config(conf_h32, device=device, seed=0)
    check(cfg_h32.head_dim == HD_H and cfg_h32.num_hidden_layers == 32, f"fp32 ViT-H config {cfg_h32}")
    log(f"fp32 ViT-H predict path: {cfg_h32.num_hidden_layers} layers, built in {time.perf_counter() - t:.3f} s")
    mh32 = phase_main_path(device, model, conf_h32, {"attn_packed": 32}, n_batches=2)
    log(f"fp32 ViT-H predict path phase: {time.perf_counter() - t:.3f} s")
    del model
    torch.cuda.empty_cache()

    # the tuned-predict scene engine end to end (infer.predict.run_predict)
    t = time.perf_counter()
    sc = phase_scene_engine(with_stages(large), card)
    log(f"scene engine phase: {time.perf_counter() - t:.3f} s")

    kernels = [
        {
            "name": "attn_qkv_rel", "geometry": "vit_l", "route": "cuda",
            "source": "beach_seg_tpu_torch/ops/csrc/attn_qkv_rel.cu",
            "replaces": "beach_seg_tpu/ops/pallas_attn.py:389",
            "launches": m["launches"]["attn_qkv_rel"], "launches_train": tr["launches"]["attn_qkv_rel"],
            "max_abs_err": k["attn_err_clamp"], "max_abs_diff": k["attn_err_clamp"],
            "max_abs_err_by_softmax": {mode: k[f"attn_err_{mode}"] for mode in SOFTMAX_MODES},
            f"max_abs_err_grid_{GRID_CROSS[0]}x{GRID_CROSS[1]}": {mode: kc[f"qkv_rel_bf16_{mode}"] for mode in SOFTMAX_MODES},
            "max_abs_err_fp32_stable": k["attn32_err"], "design": WGMMA_QKV_REL,
            "launches_fp32_predict": m32["launches"]["attn_qkv_rel"], "launches_fp32_train": tr32["launches"]["attn_qkv_rel"],
            "ms": k["attn_ms"], "plain_ms": k["attn_plain_ms"],
            "bound_ms": k["attn_bound"][0], "bound_by": k["attn_bound"][1],
            "library_ms": k["attn_library_ms"],
            "shape": f"bf16 clamp, qkv ({B}, {GRID[0] * GRID[1]}, 3, {C}), {HEADS} heads",
        },
        {
            "name": "attn_qkv_rel", "geometry": "vit_l", "dtype": "fp32", "route": "cuda",
            "source": "beach_seg_tpu_torch/ops/csrc/attn_qkv_rel.cu",
            "replaces": "beach_seg_tpu/ops/pallas_attn.py:389",
            "launches": m32["launches"]["attn_qkv_rel"], "launches_train": tr32["launches"]["attn_qkv_rel"],
            "max_abs_err": k["attn32_err"],
            "ms": k["attn32_ms"], "plain_ms": k["attn32_plain_ms"],
            "bound_ms": k["attn32_bound"][0], "bound_by": k["attn32_bound"][1], "bound_route": FP32_ROUTE,
            "library_ms": k["attn32_library_ms"], "design": TF32X3,
            "shape": f"fp32 stable, qkv ({B}, {GRID[0] * GRID[1]}, 3, {C}), {HEADS} heads",
        },
        {
            "name": "attn_packed", "geometry": "vit_h", "route": "cuda",
            "source": "beach_seg_tpu_torch/ops/csrc/attn_packed.cu",
            "replaces": "beach_seg_tpu/ops/pallas_attn.py:126",
            "launches": mh["launches"]["attn_packed"], "launches_train": trh["launches"]["attn_packed"],
            "max_abs_err": kh["packed_err_bf16"], "max_abs_err_fp32": kh["packed_err_fp32"],
            "ms": kh["packed_ms_bf16"], "plain_ms": kh["packed_plain_ms_bf16"],
            "bound_ms": kh["packed_bound_bf16"][0], "bound_by": kh["packed_bound_bf16"][1],
            "library_ms": kh["packed_library_ms"],
            "fp32_ms": kh["packed_ms_fp32"], "fp32_plain_ms": kh["packed_plain_ms_fp32"],
            "fp32_bound_ms": kh["packed_bound_fp32"][0], "fp32_bound_route": FP32_ROUTE,
            "fp32_library_ms": kh["packed_library_ms_fp32"], "fp32_design": TF32X3,
            "launches_fp32_predict": mh32["launches"]["attn_packed"],
            "shape": f"bf16, q/k/v ({B * HEADS}, {GRID[0] * GRID[1]}, {HD_H}), rel ({GRID[0]}, {GRID[1]})",
        },
    ]
    for name, src, tpu, geo, res, pred, train, c in (
        ("ln_mlp", "ln_mlp.cu", "pallas_mlp.py:37", "vit_l", k, m, tr, C),
        ("ln_mlp", "ln_mlp.cu", "pallas_mlp.py:37", "vit_h", kh, mh, trh, C_H),
        ("attn_bwd", "attn_bwd.cu", "pallas_attn.py:722", "vit_l", kb, m, tr, C),
        ("attn_bwd", "attn_bwd.cu", "pallas_attn.py:722", "vit_h", kh, mh, trh, C_H),
        ("ln_mlp_dx", "ln_mlp_dx.cu", "pallas_mlp.py:167", "vit_l", kb, m, tr, C),
        ("ln_mlp_dx", "ln_mlp_dx.cu", "pallas_mlp.py:167", "vit_h", kh, mh, trh, C_H),
    ):
        key = {"ln_mlp": "mlp", "attn_bwd": "attn_bwd", "ln_mlp_dx": "mlp_dx"}[name]
        fwd = name == "ln_mlp"
        entry = {
            "name": name, "geometry": geo, "route": "cuda",
            "source": f"beach_seg_tpu_torch/ops/csrc/{src}", "replaces": f"beach_seg_tpu/ops/{tpu}",
            "launches": (pred if fwd else train)["launches"][name],
            ("launches_train" if fwd else "launches_predict"): (train if fwd else pred)["launches"][name],
            "max_abs_err": res[f"{key}_err"],
            "ms": res[f"{key}_ms"], "plain_ms": res[f"{key}_plain_ms"],
            "bound_ms": res[f"{key}_bound"][0], "bound_by": res[f"{key}_bound"][1],
            "library_ms": res.get(f"{key}_library_ms"),
        }
        if name in ("ln_mlp", "ln_mlp_dx"):
            stages = MLP_STAGES[:3] if fwd else ("ln_rows",) + MLP_STAGES[3:]
            path = pred if fwd else train
            entry.update({
                "design": MLP_DESIGN, "device_launches_per_call": mlp_device_launches(pred, train)[name],
                "chain_ms": res[f"{key}_chain_ms"],
                "chain": "bf16 F.layer_norm -> addmm -> GELU -> addmm" + (", autograd dx" if not fwd else ""),
                "error_norm": res[f"{key}_norm"],
                "stage_launches": {st: path["launches"][st] for st in stages},
                "stage_ms": {st: kst[geo][f"{st}_ms"] for st in stages},
                "max_abs_err_by_stage": {st: kst[geo][f"{st}_err"] for st in stages},
                "max_abs_err_by_stage_ragged": {st: kst[f"{geo}_ragged"][f"{st}_err"] for st in stages},
            })
        if name == "attn_bwd":
            hd = c // HEADS
            entry["max_abs_err_by_output"] = res["attn_bwd_errs"]
            entry["shape"] = f"bf16, q/k/v/g ({B * HEADS}, {GRID[0] * GRID[1]}, {hd}), rel ({GRID[0]}, {GRID[1]})"
        else:
            entry["shape"] = f"bf16, x ({B * GRID[0] * GRID[1]}, {c}), M={4 * c}"
        kernels.append(entry)
    n = GRID[0] * GRID[1]
    for name, src, tpu, key, shape in (
        ("attn_fused", "attn_fused.cu", "pallas_attn.py:53", "fused", f"q/k/v ({B * HEADS}, {n}, {HD}), rel ({GRID[0]}, {GRID[1]})"),
        ("attn_qkv", "attn_qkv.cu", "pallas_attn.py:224", "qkv", f"qkv ({B}, {n}, {3 * C}), rel slots ({B}, {n}, {HEADS * 64})"),
    ):
        entry_name = "fused_attention" if name == "attn_fused" else "fused_attention_qkv"
        for dt in ("bf16", "fp32"):
            kernels.append({
                "name": name, "geometry": "vit_l", "dtype": dt, "route": "cuda",
                "source": f"beach_seg_tpu_torch/ops/csrc/{src}", "replaces": f"beach_seg_tpu/ops/{tpu}",
                "launches": ke[f"{entry_name} {dt} head_dim {HD}"]["launches"][name],
                "max_abs_err": kl[f"{key}_err_{dt}"], "ms": kl[f"{key}_ms_{dt}"], "plain_ms": kl[f"{key}_plain_ms_{dt}"],
                "bound_ms": kl[f"{key}_bound_{dt}"][0], "bound_by": kl[f"{key}_bound_{dt}"][1],
                "library_ms": kl[f"{key}_library_ms_{dt}"], "shape": f"{dt}, {shape}",
                **({"bound_route": FP32_ROUTE, "design": TF32X3} if dt == "fp32" else {}),
            })
    for hd, launches in ((HD, tr32["launches"]["attn_bwd"]), (HD_H, ke[f"fused_attention fp32 head_dim {HD_H}"]["launches"]["attn_bwd"])):
        r = kl[f"bwd32_{hd}"]
        kernels.append({
            "name": "attn_bwd", "geometry": "vit_l" if hd == HD else "vit_h", "dtype": "fp32", "route": "cuda",
            "source": "beach_seg_tpu_torch/ops/csrc/attn_bwd.cu", "replaces": "beach_seg_tpu/ops/pallas_attn.py:722",
            "launches": launches, "launches_entries": ke[f"fused_attention fp32 head_dim {hd}"]["launches"]["attn_bwd"],
            "max_abs_err": r["attn_bwd_err"], "max_abs_err_by_output": r["attn_bwd_errs"],
            "ms": r["attn_bwd_ms"], "plain_ms": r["attn_bwd_plain_ms"],
            "bound_ms": r["attn_bwd_bound"][0], "bound_by": r["attn_bwd_bound"][1], "bound_route": FP32_ROUTE,
            "library_ms": r["attn_bwd_library_ms"], "design": TF32X3,
            "shape": f"fp32, q/k/v/g ({B * HEADS}, {n}, {hd}), rel ({GRID[0]}, {GRID[1]})",
        })
    # the small head dims and the debug backbone's launches, beside each kernel's first entry
    first = {}
    for e in kernels:
        first.setdefault(e["name"], e)
    for key, name in (("packed", "attn_packed"), ("fused", "attn_fused")):
        first[name]["max_abs_err_small_head_dims"] = {f"{dt}_hd{hd}": ks[f"{key}_err_{dt}_hd{hd}"] for dt in ("bf16", "fp32") for hd in (16, 8)}
    first["attn_bwd"]["max_abs_err_small_head_dims"] = {f"{dt}_hd{hd}": ks[f"bwd_errs_{dt}_hd{hd}"] for dt in ("bf16", "fp32") for hd in (16, 8)}
    for e in kernels:
        if e["name"] in ("attn_packed", "attn_bwd", "attn_fused", "attn_qkv") and e.get("dtype", "bf16") == "bf16":
            e["design"] = WGMMA
    grid = f"{GRID_CROSS[0]}x{GRID_CROSS[1]}"
    for key, name in (("packed", "attn_packed"), ("fused", "attn_fused"), ("bwd", "attn_bwd")):
        first[name][f"max_abs_err_grid_{grid}"] = {f"{dt}_hd{hd}": kc[f"{key}_{dt}_hd{hd}"] for dt in ("bf16", "fp32") for hd in (HD, HD_H)}
    first["attn_qkv"][f"max_abs_err_grid_{grid}"] = {dt: kc[f"qkv_{dt}"] for dt in ("bf16", "fp32")}
    # the scene engine's launches: bf16 vote + blend for #1 and #2, fp32 vote for #1 fp32
    scene_bf16 = [sc["runs"]["bf16_vote"]["launches"], sc["runs"]["bf16_blend_overlap56"]["launches"]]
    for e in kernels:
        if e["name"] in ("attn_qkv_rel", "ln_mlp") and e["geometry"] == "vit_l":
            runs = [sc["runs"]["fp32_vote"]["launches"]] if e.get("dtype") == "fp32" else scene_bf16
            e["launches_scene_engine"] = sum(r[e["name"]] for r in runs)
    first["attn_packed"]["ms_hd16_bf16"] = ks["packed_ms_hd16"]
    first["attn_bwd"]["ms_hd16_bf16"] = ks["bwd_ms_hd16"]
    for name in ("attn_packed", "attn_bwd", "ln_mlp", "ln_mlp_dx"):
        first[name]["launches_debug_backbone"] = {f"{dt}_{path}": dbg[dt][path]["launches"][name] for dt in ("bf16", "fp32")
                                                  for path in ("predict", "train")}
    log(f"debug backbone: " + "; ".join(
        f"{dt} predict_step seconds per call {dbg[dt]['predict']['seconds']}, train_step seconds per step "
        f"{dbg[dt]['train']['seconds']}, prompt gradient cosine kernels vs plain {dbg[dt]['train']['grad_cos']:.6f}"
        for dt in ("bf16", "fp32")))
    log(f"ViT-H: predict_step seconds per call {mh['seconds']}; train_step seconds per step {trh['seconds']}, "
        f"peak memory {trh['peak_bytes']} bytes, prompt gradient cosine kernels vs plain {trh['grad_cos']:.6f}")
    log(f"train_step: seconds per step {tr['seconds']}, peak memory {tr['peak_bytes']} bytes, "
        f"prompt gradient cosine kernels vs plain {tr['grad_cos']:.6f}")
    log(f"fp32 ViT-L: predict_step seconds per call {m32['seconds']} (warm {m32['seconds'][-1]:.4f}); train_step seconds per step {tr32['seconds']}, "
        f"peak memory {tr32['peak_bytes']} bytes, prompt gradient 1 - cosine kernels vs plain {1 - tr32['grad_cos']:.4e}, "
        f"max_abs_err {tr32['grad_err']:.4e}")
    log(f"fp32 ViT-H: predict_step seconds per call {mh32['seconds']} (warm {mh32['seconds'][-1]:.4f}), "
        f"attn_packed launches {mh32['launches']['attn_packed']} in {len(mh32['seconds'])} calls")
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
