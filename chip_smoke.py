"""Chip smoke test of the PyTorch/CUDA port (beach_seg_tpu_torch) on one
NVIDIA Hopper card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the eight CUDA sources of ops/csrc with nvcc, in parallel; print
     the build time and ptxas' register / shared-memory / spill lines;
  3. at ViT-L shapes for a batch of 8 tiles (S=1568, C=1024, 16 heads,
     M=4096): each forward kernel against its plain PyTorch version on the
     card, then CUDA-event times of the kernel, the plain version and, for
     attention, scaled_dot_product_attention with the materialized bias (a
     yardstick the port never calls); the qkv-rel attention in bf16 in all
     three softmax modes (stable, clamp: the default, timed; fast; its ws
     body, attn_ws.cuh) and in fp32 (the instance phase 12 runs); the LN→MLP is held to a largest
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
     the MLP's stage kernels ln_rows, lin1_gelu, lin2), all 24 attention
     launches in #1's ws body, and the backward
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
     against the plain versions; then the fp32 linear products' kernel
     (linear_f32, split TF32, csrc/gemm_f32x3.cu) at each ViT-H and ViT-L
     product's shape (LINEAR_SHAPES: qkv at B and 2·B tiles, proj, lin1,
     lin2, the patch and decoder embeds), forward and input gradient,
     against an fp64 product and cuBLAS's fp32 one (LINEAR_REL_TOL,
     LINEAR_LIB_RATIO), one launch a call and the weight's parts made once
     an orientation, then timed beside the plain version, cuBLAS's product
     (library_ms) and the bound; the shapes and dtypes it refuses;
 12. the default BeachSegConfig (fp32 ViT-L, model_for_config): 2
     predict_step calls (24 qkv-rel attention launches each; the second is
     the warm time) and 2 train_steps (24 qkv-rel and 24 fp32
     attention-backward launches each, the MLP plain torch), each linear
     product through linear_f32 (99 launches a call, 197 a step, no weight
     parts made after the first), the prompt gradient held against the plain
     versions with fp32 limits;
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
     packed-attention launches each (#3 on its split-TF32 body) and 131 of
     linear_f32, pred_masks held against the plain versions with phase 5's
     limits;
 17. the tuned-predict scene engine (infer.predict.run_predict) end to end
     at full width: a 2048×1024-pixel, 4-band uint16 scene at 3 m (a wavy
     shoreline across the full width; one reference date and 8 predict
     dates, each two overlapping GeoTIFF tiles) written to disk with the
     port's geo writers, of which this phase runs the first 4 dates, then
     ViT-L (seeded random weights, batch 8) in bf16
     vote mode, bf16 blend mode (overlap 56), bf16 vote mode through the
     plain versions and fp32 vote mode: per-date GeoTIFFs of the scene's
     shape and CRS with ids in 0..3, mask PNGs and overlays; 24 #1 and 24 #2
     launches (and 24 of each MLP stage kernel) per batch under bf16, 24 #1
     under fp32, the others idle; timings.json's tile count; the bf16 vote
     mosaics equal to the plain run's on ID_AGREEMENT_MIN of the voted
     pixels; stream_tiles_per_sec and the phase seconds of each run;
 18. the zero-shot and legacy scene engines (infer.zero_shot.run_zero_shot,
     infer.legacy.run_legacy) end to end at full width on the first 4
     dates of phase 17's scene: ViT-L (seeded random weights, batch 8) zero-shot in
     bf16 (crops of 336, 2 prompts a query: 32 rows before the stream merge,
     the feature ensemble grouped by query), in fp32 and in bf16 through the
     plain versions; legacy in bf16 (crops of 224 at overlap 112, the reference
     date's first 2 crops as prompts): per-date GeoTIFFs of the scene's shape
     and CRS (zero-shot ids in 0..3, legacy 1-bit masks per exported class),
     timings.json's tile count, 24 #1 and 24 #2 launches (and 24 of each MLP
     stage kernel) per batch under bf16, 24 #1 under fp32, the others idle;
     the zero-shot bf16 mosaics equal to the plain run's on ID_AGREEMENT_MIN
     of the voted pixels; #1 at the engines' batches (8 queries by 2
     prompts: 32 rows, then 16) and at the odd batches of 3 queries by 3
     prompts (18 rows, then 9) against its plain version in bf16 and fp32,
     and the three stage kernels of #2 at 32·S and 16·S rows against
     theirs (phase 7's stage limits); the
     device votes (infer.device_votes.scatter_votes) on the card equal to
     the CPU's; stream_tiles_per_sec and the phase seconds of each run;
 19. the training runtime (train.loop.run_training) end to end at full width
     on phase 17's scene: ViT-L (seeded random weights) in bf16, the
     reference date's 19 crops of 112 tiled to 448, batch 8, 2 epochs of 3
     steps and 3 eval batches, the profiler on: the JAX run dir's artifacts,
     one metrics.csv row a step with a finite train/loss, the tuned pixels
     moved and the EMA pixels nearer the initial ones, the trace, 24 launches
     of #1, #2, #4 and #5 (and of their stage kernels) a train step and of #1
     and #2 an eval batch, nothing else; a resume to 3 epochs (starts at step
     6, writes step_9); one train step with remat and one without from the
     same state and draws (gradients bit-equal or within phase 6's limits,
     #1 and #2 48 times under remat, the peak memory of each, lower under
     remat); run_predict from the run's EMA export on one date, bf16 vote;
     the phase's seconds, StepTimer's steps/sec, the peak memories and the
     loggers that ran, beside the card's name and power limit;
 20. two ranks sharing the card (torch.multiprocessing, gloo, started
     through parallel.distributed.maybe_initialize) with ViT-L bf16 (seeded
     random weights) at B=8: under (data=1, model=2) a predict_step and a
     train_step, under (data=2, model=1) a train_step, each held against
     the same step in one process on the same weights and draws (ids equal,
     or ID_AGREEMENT_MIN with pred_masks within phase 5's limit; the prompt
     gradient within phase 6's limits; the ranks' gradients equal), 24
     launches of #1, #2, #4 and #5 a train step on each rank, the
     collectives' time a step (replayed); on rank 0 #1, #2, #4 and #5 at the
     widths of mesh_model=2 (8 heads at 512 channels, M = 2048 whole and by
     stage, B·8 rows) against their plain versions, timed; then the CLIs at
     full width on phase 17's scene (python -m beach_seg_tpu_torch.cli.*):
     train for 1 epoch, predict from its run dir on one date, compare
     against an in-process run_predict (pixel_agreement 1.0 where the
     forward is deterministic from run to run), each command's seconds;
 21. BASELINE.json config #5 (multi-class segmentation of 8-band SuperDove
     imagery with the larger backbone): a 2048×1024 8-band uint16 scene (1
     reference and 2 predict dates, two overlapping tiles each) written
     with the port's geo writers; BeachSegConfig(backbone="huge") at its
     default fp32 (ViT-H, seeded random weights): 3 train_steps at B=8, 32
     launches each of #3 and #4 a step and nothing else, the prompt
     gradient within phase 12's fp32 limits, #3's and #4's in-model ms a
     call (CUDA events around the wrappers), the peak memory of a step
     without and with remat; #3 at head_dim 80 in bf16 and fp32 at
     run_predict's 8 batch rows and at the scene's odd tail, and the
     C=1280 stages of #2 at 8·S rows, against their plain versions;
     run_training on the scene (crops of 112 tiled to 448, batch 8, 2
     epochs, every step logged: the JAX run dir's artifacts, finite
     losses, the tuned pixels moved, 32 launches of #3 and #4 a train step
     and of #3 an eval batch, nothing else); run_predict from the run's
     EMA export on the 2 predict dates in fp32 vote, bf16 vote (32
     launches of #3 and #2, and of each stage of #2, a batch) and bf16 vote
     through the plain versions: GeoTIFFs of the scene's shape and CRS with
     ids in 0..3, the bf16 ids ≥ ID_AGREEMENT_MIN equal to the plain run's;
     stream_tiles_per_sec, the timings.json phase seconds, the phase's
     seconds;
 22. golden parity at full width (scripts/golden_parity_torch.py and
     scripts/golden_parity_tuned_torch.py on phase 17's scene cut to 1
     reference and 2 predict dates): HF's own random ViT-L
     (transformers' SegGptConfig(), BAAI/seggpt-vit-large's topology, the
     decoder head scaled where the weights would paint one class) saved
     once as a local HF directory and loaded by the port
     (load_model_params; config_from_hf equal to SegGPTConfig()); an fp32
     run_training of 1 epoch from it (24 launches of #1 and #4 a train
     step, of #1 an eval batch); the reference's zero-shot and tuned
     chains re-run over transformers' SegGptForImageSegmentation on the
     card (fp32, eager, TF32 off); the port's run_zero_shot (crops of 336,
     2 prompts, rank_compat) and run_predict from the run's tuned export in
     fp32 (24 #1 a batch) and bf16 (24 #1 and #2, and #2's stages, a
     batch): every fp32 run's worst per-class IoU against the oracle
     >= 0.999 on every predict date, the bf16 runs' IoU printed, the
     reference masks' class shares (no class over 95% of the valid
     pixels, each labelled class on at least 1%), the port's model against
     the oracle's on the tuned inputs (the largest output difference, which
     bounds the decode margins the arithmetic can flip), no plain version called in the phase, and the seconds of
     each part;
 23. Painter ViT-L's windowed blocks: #1 (bf16, clamp) and #4 (bf16) on
     64 and 128 rows of 14×14 windows (PAINTER_ROWS: B·8 windows after the
     stream merge, 2·B·8 before it), 16 heads of 64, rel tables of 27 rows,
     each against its plain version with phases 3–4's limits, then timed
     beside its plain version and its bound;
 24. Painter ViT-L (BeachSegConfig(backbone="painter"), bf16, seeded random
     weights) through predict_step (3 calls) and train_step (3 steps) as
     phases 5–6 run ViT-L: 24 launches of #1 and #2 (and #2's stages) a
     call and of #1, #2, #4 and #5 a step, pred_masks and the prompt
     gradient against the plain versions with phases 5–6's limits; then
     one call and one step with each #1 and #4 launch counted by shape: 8 on
     the 56×28 grid and 16 on windows (2 on 128 rows, 14 on 64), and all 24
     of #1's launches a call in its ws body;
 25. one JSON line of per-kernel numbers (one entry per kernel, geometry
     and dtype; Painter's windows under geometry "painter_window", one entry
     per row count), then the card's name and power limit, then
     {"ok": true, "device": {...}} as the last line.

It exits non-zero without a CUDA device, and needs nothing but this
repository, torch, numpy, transformers, safetensors and the CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
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
# #1 bf16: attn_ws.cuh's warp-specialized kernel
WS_QKV_REL = ("warp-specialized: a pre-pass (fill_slots_rel) writes each query row's slot rows and k + bk, v + bv; "
              "one producer thread issues TMA into a 5-stage ring of 64-key K, V and E tiles; two consumer "
              "warpgroups of 64 rows take turns issuing, Q and the slot rows as register operands, rel terms as "
              "wgmma k steps against E; S(j) is issued beside PV(j-1), and tile j's exponentials run while PV(j-1) does")
SOFTMAX_MODES = ("stable", "clamp", "fast")
HBM = 3.35e12  # bytes/s
B = 8  # tiles per batch (the predict step's batch)
# rows of #1 and #2 in the zero-shot and legacy engines: 8 queries by 2 prompts
# before the stream merge and after it, then the odd batch of 3 queries by 3
ENGINE_ROWS = (2 * B * 2, B * 2, 2 * 3 * 3, 3 * 3)
GRID = (56, 28)  # ViT-L and ViT-H canvas 896×448 at 16-pixel patches
# a grid whose 64-key tiles cross rel_h slot chunks (16 rows of 27 keys) and
# whose last tile is ragged (999 = 15·64 + 39); ViT's 16·28 keys are 7 tiles
GRID_CROSS = (37, 27)
# Painter ViT-L's windowed blocks (painter_config): windows of 14×14 tokens,
# 8 a tile (the 56×28 grid in 4×2), so #1 and #4 run on B·8 rows of windows
# after the stream merge and on 2·B·8 before it (blocks 0 and 1)
PAINTER_WIN = (14, 14)
PAINTER_ROWS = (B * 8, 2 * B * 8)
# EVA-02-L (backbone "eva02"): the 896×448 canvas at 14-pixel patches, its
# SwiGLU width int(1024 · 2.6667), its RoPE step (16 over the query's 32
# columns); the RoPE attention at B and 2B rows (after and before the stream
# merge), the SwiGLU MLP on their tokens and on a row count no tile divides
EVA_GRID = (64, 32)
EVA_MLP = 2730
EVA_ROPE_STEP = 0.5
EVA_ROWS = (B, 2 * B)
EVA_MLP_ROWS = (B * 64 * 32, 2 * B * 64 * 32, 1000)
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
        "attn_qkv_rope": cuda_attn.attn_qkv_rope, "swiglu_mlp": cuda_mlp.swiglu_mlp,
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


def attn_bound(b: int, itemsize: int, peak: float, heads: int = HEADS, grid=GRID) -> tuple[float, str]:
    gh, gw = grid
    s = gh * gw
    c = heads * HD
    flops = 4 * b * heads * s * s * HD + 2 * b * heads * s * (gh + gw) * HD  # QKᵀ, PV, rel terms
    nbytes = itemsize * (b * s * 3 * c + b * s * c + 3 * c + (gh + gw) * 64 * HD)
    return bound(flops, nbytes, peak)


def mlp_bound(n: int, c: int = C, m: int = MLP) -> tuple[float, str]:
    flops = 4 * n * c * m
    nbytes = 2 * (2 * n * c + 2 * c * m + m + c) + 4 * 2 * c
    return bound(flops, nbytes, PEAK_BF16)


def attn_inputs(dtype, device, b=B, seed=0, grid=GRID, c=C):
    from beach_seg_tpu_torch.ops.attention import rel_tables_padded

    g = torch.Generator(device=device).manual_seed(seed)
    gh, gw = grid
    qkv = torch.randn((b, gh * gw, 3, c), generator=g, device=device)
    bias = 0.1 * torch.randn((3, c), generator=g, device=device)
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
    heads = c // HD
    gh, gw = GRID
    x = qkv + bias
    q, k, v = (x[:, :, i].reshape(b, s, heads, HD).transpose(1, 2) for i in range(3))
    q5 = q.reshape(b, heads, gh, gw, HD)
    rel_h = torch.einsum("bnyxc,ykc->bnyxk", q5, rh).reshape(b, heads, s, 64)
    rel_w = torch.einsum("bnyxc,xkc->bnyxk", q5, rw).reshape(b, heads, s, 64)
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


def mlp_stage_check(device, n: int, c: int, m: int, seed: int, timed: bool, forward_only: bool = False) -> dict:
    """Each stage kernel of #2 and #5 against its stage plain version on the
    plain chain's own intermediates, with ``mlp_within``'s limits: the bf16
    outputs' (MLP_BF16_REL_TOL, MLP_NORM_TOL), the fp32 LN statistics'
    (MLP_STATS_TOL) and dln's (MLP_DLN_TOL); then, if ``timed``, each
    kernel's ms. ``forward_only``: the three stages of #2 alone."""
    from beach_seg_tpu_torch.ops import cuda_mlp as M

    x, ls, lb, w1, b1, w2, b2, gy = mlp_inputs(device, seed, n, c, m)
    ln, mean, rstd = M.ln_rows_plain(x, ls, lb, 1e-6)
    h = M.lin1_gelu_plain(ln, w1, b1, True)
    calls = {
        "ln_rows": (lambda: M.ln_rows(x, ls, lb, 1e-6), (ln, mean, rstd)),
        "lin1_gelu": (lambda: M.lin1_gelu(ln, w1, b1, True), h),
        "lin2": (lambda: M.lin2(h, w2, b2), M.lin2_plain(h, w2, b2)),
    }
    if not forward_only:
        dh = M.dual_dh_plain(ln, gy, w1, b1, w2, True)
        dln = M.dln_plain(dh, w1)
        calls.update({
            "dual_dh": (lambda: M.dual_dh(ln, gy, w1, b1, w2, True), dh),
            "dln": (lambda: M.dln(dh, w1), dln),
            "ln_vjp": (lambda: M.ln_vjp(dln, x, ls, mean, rstd), M.ln_vjp_plain(dln, x, ls, mean, rstd)),
        })
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
    if forward_only:
        return res
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
        f"times (ms, B={B}): attn kernel (ws) {res['attn_ms']:.4f} plain {res['attn_plain_ms']:.4f} "
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


def sdpa_bwd_yardstick(q, k, v, rel_h, rel_w, g, heads: int = HEADS):
    """One PyTorch call computing the same gradients: the backward of SDPA
    over (B, H, S, D) q, k, v with the rel bias materialized as a (B, H, S, S)
    mask that takes a gradient (its gradient is dS, from which drh/drw are
    sums). Returns a closure that times the backward alone."""
    from torch.nn import functional as F

    bh, s, d = q.shape
    gw = GRID[1]
    kidx = torch.arange(s, device=q.device)
    mask = (rel_h[..., kidx // gw] + rel_w[..., kidx % gw]).reshape(bh // heads, heads, s, s).detach().requires_grad_(True)
    qq, kk, vv = (t.reshape(bh // heads, heads, s, d).detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, scale=d**-0.5)
    gg = g.reshape(bh // heads, heads, s, d)
    return lambda: torch.autograd.grad(out, (qq, kk, vv, mask), gg, retain_graph=True)


def attn_bwd_check(device, hd: int, where: str, dtype=torch.bfloat16, heads: int = HEADS) -> dict:
    """The attention backward at B·H = B·``heads`` and head_dim ``hd`` against
    its plain version (bf16: 1% of each output's scale for dq/dk/dv, two
    bf16 steps for drh/drw; fp32: ATTN_BWD_FP32_REL_TOL of each), then it,
    its plain version and SDPA's backward timed."""
    from beach_seg_tpu_torch.ops import cuda_attn
    from beach_seg_tpu_torch.ops.attention import attention_bwd_plain

    gh, gw = GRID
    bh = B * heads
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
    res["attn_bwd_library_ms"] = time_ms(sdpa_bwd_yardstick(*args[:6], heads), iters=3 if fp32 else 10, warmup=2)
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


# the fp32 linear products (ops/cuda_gemm.py, csrc/gemm_f32x3.cu) at the
# model's shapes, (rows, K, N): B tiles of S tokens after the stream merge and
# 2·B before it (qkv_2b), the patch embed (16·16·3 pixels a patch), and the
# decoder embed on the query half and its halo row (decode_query_only: 29 of
# the 56 grid rows) from the 4 collected layers; a bias where the module adds
# it to the product (qkv on the packed path, lin1, the two embeds)
LINEAR_SHAPES = {
    geom: {
        "qkv": (B * GRID[0] * GRID[1], c, 3 * c), "qkv_2b": (2 * B * GRID[0] * GRID[1], c, 3 * c),
        "proj": (B * GRID[0] * GRID[1], c, c), "lin1": (B * GRID[0] * GRID[1], c, m),
        "lin2": (B * GRID[0] * GRID[1], m, c), "patch": (B * GRID[0] * GRID[1], 16 * 16 * 3, c),
        "embed": (B * (GRID[0] // 2 + 1) * GRID[1], 4 * c, 16 * 16 * 64),
    }
    for geom, c, m in (("vit_h", C_H, MLP_H), ("vit_l", C, MLP))
}
LINEAR_BIAS = ("qkv", "qkv_2b", "lin1", "patch", "embed")
# the kernel's largest error over max|fp64 product|, forward and input
# gradient: split TF32 leaves ~2^-21 a product and a stage's 12 truncations
# in the tensor cores, fp32 sums on the FP32 units; read on an H100 at these
# shapes 3.3e-7 to 1.2e-6, where cuBLAS's fp32 SGEMM read 1.0e-6 to 5.8e-6.
# One TF32 product alone (a product with its small parts left out) is ~2^-11.
LINEAR_REL_TOL = 4e-6
# and no more than twice cuBLAS fp32's error on the same operands
LINEAR_LIB_RATIO = 2.0
LINEAR_DESIGN = ("warp-specialized: one producer thread issues TMA (128-byte swizzle) into a 4-stage ring of a "
                 "128 x 32 fp32 activation tile and the weight's two 128 x 32 TF32 parts; two consumer warpgroups "
                 "of 64 rows split their A fragments in registers and issue m64n128k8 tf32 wgmma (A from "
                 "registers), small terms first, each stage's 12 products in their own accumulator added to an "
                 "fp32 sum; the weights' parts made once and kept")


def linear_products(cfg, train: bool) -> int:
    """linear_f32 launches of an fp32 predict call (``train`` False) or train
    step: the patch embed of both canvases, four products a block, the
    decoder embed; the prompt gradient adds the input gradient of each but
    the mask canvas's patch embed."""
    fwd = 2 + 4 * cfg.num_hidden_layers + 1
    return fwd + (fwd - 1 if train else 0)


def phase_linear_f32(device) -> dict:
    """Each product of LINEAR_SHAPES, forward (x·W + b) and input gradient
    (dy·Wᵀ), through the kernel against an fp64 product and cuBLAS's fp32
    one (TF32 off): within LINEAR_REL_TOL of max|fp64| and LINEAR_LIB_RATIO
    of cuBLAS's error; one launch a call, the weight's parts made on its
    first use in each orientation and kept; then timed beside the plain
    version (x @ W + b), cuBLAS's product alone (library_ms) and the bound
    (FLOPs at 165 TF/s); the wrapper raises on what it does not take."""
    from beach_seg_tpu_torch.ops import cuda_gemm

    check(not torch.backends.cuda.matmul.allow_tf32, "the fp32 yardstick needs TF32 off")
    res = {}
    for geom, shapes in LINEAR_SHAPES.items():
        for name, (m, k, n) in shapes.items():
            g = torch.Generator(device="cpu").manual_seed(m + k + n)
            x = torch.randn((m, k), generator=g).to(device)
            w = (torch.randn((k, n), generator=g) / k**0.5).to(device)
            b = (0.1 * torch.randn(n, generator=g)).to(device) if name in LINEAR_BIAS else None
            dy = torch.randn((m, n), generator=g).to(device)
            l0, c0 = cuda_gemm.linear_f32.launches, cuda_gemm.linear_f32.cache_builds
            y = cuda_gemm.linear_f32(x, w, b)
            dx = cuda_gemm.linear_f32(dy, w, transposed=True)
            cuda_gemm.linear_f32(x, w, b)
            torch.cuda.synchronize()
            check((cuda_gemm.linear_f32.launches - l0, cuda_gemm.linear_f32.cache_builds - c0) == (3, 2),
                  f"linear_f32 {geom} {name}: launches, parts made "
                  f"{cuda_gemm.linear_f32.launches - l0}, {cuda_gemm.linear_f32.cache_builds - c0}, want 3, 2")
            r = {"shape": (m, k, n)}
            for tag, got, want64, lib in (
                ("", y, x.double() @ w.double() + (0 if b is None else b.double()), x @ w + (0 if b is None else b)),
                ("_dx", dx, dy.double() @ w.double().t(), dy @ w.t()),
            ):
                scale = want64.abs().max().item()
                err = (got.double() - want64).abs().max().item() / scale
                lib_err = (lib.double() - want64).abs().max().item() / scale
                r[f"err{tag}"], r[f"library_err{tag}"] = err, lib_err
                check(err <= LINEAR_REL_TOL and err <= LINEAR_LIB_RATIO * lib_err,
                      f"linear_f32 {geom} {name}{tag}: error {err:.3e} of max|fp64| (cuBLAS fp32 {lib_err:.3e})")
                del want64, lib
            r["ms"] = time_ms(lambda: cuda_gemm.linear_f32(x, w, b), 10)
            r["ms_dx"] = time_ms(lambda: cuda_gemm.linear_f32(dy, w, transposed=True), 10)
            r["plain_ms"] = time_ms(lambda: cuda_gemm.linear_f32_plain(x, w, b), 10)
            r["library_ms"] = time_ms(lambda: torch.matmul(x, w), 10)
            r["library_ms_dx"] = time_ms(lambda: torch.matmul(dy, w.t()), 10)
            r["bound"] = bound(2 * m * k * n, 4 * (m * k + k * n + m * n + n), PEAK_FP32_TC)
            log(f"linear_f32 {geom} {name} (M, K, N) = {(m, k, n)}: err {r['err']:.3e} (cuBLAS fp32 "
                f"{r['library_err']:.3e}), dx err {r['err_dx']:.3e} ({r['library_err_dx']:.3e}); ms {r['ms']:.4f}, "
                f"dx {r['ms_dx']:.4f}, plain {r['plain_ms']:.4f}, cuBLAS {r['library_ms']:.4f} / dx "
                f"{r['library_ms_dx']:.4f}, bound {r['bound'][0]:.4f} ({r['bound'][1]}); "
                f"{2 * m * k * n / r['ms'] / 1e9:.1f} TF/s")
            res[(geom, name)] = r
            del x, w, b, dy, y, dx
            torch.cuda.empty_cache()
    x = torch.zeros((4, 64), device=device)
    for args, what in (((x, torch.zeros((64, 3), device=device)), "N = 3"),
                       ((x.bfloat16(), torch.zeros((64, 128), device=device, dtype=torch.bfloat16)), "bf16"),
                       ((x, torch.zeros((64, 128), device=device, requires_grad=True)), "a weight that requires grad"),
                       ((x[:, 1:61], torch.zeros((60, 128), device=device)), "a strided x")):
        try:
            cuda_gemm.linear_f32(*args)
        except (TypeError, ValueError):
            continue
        check(False, f"linear_f32 took {what}")
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


def phase_painter_windows(device) -> dict:
    """#1 (bf16, clamp: the model's mode) and #4 (bf16) at Painter ViT-L's
    windowed blocks: PAINTER_ROWS rows of 14×14 windows, 16 heads of 64,
    rel tables of 27 rows, each against its plain version with phases 3–4's
    limits, then timed beside the plain version and its bound."""
    from beach_seg_tpu_torch.ops import cuda_attn
    from beach_seg_tpu_torch.ops.attention import attention_bwd_plain

    gh, gw = PAINTER_WIN
    s = gh * gw
    res = {}
    for rows in PAINTER_ROWS:
        where = f"{rows} windows of {gh}x{gw}"
        args = (*attn_inputs(torch.bfloat16, device, b=rows, seed=16, grid=PAINTER_WIN), HD**-0.5, gw, HEADS, "clamp")
        res[f"attn_err_{rows}"] = fwd_check(f"attn_qkv_rel bf16 clamp {where}", cuda_attn.attn_qkv_rel,
                                            cuda_attn.attn_qkv_rel_plain, args, (rows, s, C))
        res[f"attn_ms_{rows}"] = time_ms(lambda: cuda_attn.attn_qkv_rel(*args), iters=20, warmup=2)
        res[f"attn_plain_ms_{rows}"] = time_ms(lambda: cuda_attn.attn_qkv_rel_plain(*args), iters=3)
        res[f"attn_bound_{rows}"] = attn_bound(rows, 2, PEAK_BF16, grid=PAINTER_WIN)
        bh = rows * HEADS
        bwd = (*attn_bwd_inputs(device, bh, seed=17, grid=PAINTER_WIN), HD**-0.5)
        got = cuda_attn.attn_bwd(*bwd)
        torch.cuda.synchronize()
        res[f"bwd_errs_{rows}"] = bwd_out_check(f"attn_bwd bf16 {where}", got, attention_bwd_plain(*bwd), False)
        del got
        res[f"bwd_ms_{rows}"] = time_ms(lambda: cuda_attn.attn_bwd(*bwd), iters=10, warmup=2)
        res[f"bwd_plain_ms_{rows}"] = time_ms(lambda: attention_bwd_plain(*bwd), iters=2)
        res[f"bwd_bound_{rows}"] = attn_bwd_bound(bh, s, gh, gw)
        log(f"times (ms, {where}): attn kernel (ws) {res[f'attn_ms_{rows}']:.4f} plain {res[f'attn_plain_ms_{rows}']:.4f} "
            f"bound {res[f'attn_bound_{rows}'][0]:.4f} ({res[f'attn_bound_{rows}'][1]}); attn_bwd kernel "
            f"{res[f'bwd_ms_{rows}']:.4f} plain {res[f'bwd_plain_ms_{rows}']:.4f} "
            f"bound {res[f'bwd_bound_{rows}'][0]:.4f} ({res[f'bwd_bound_{rows}'][1]})")
        del args, bwd
        torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def launch_shapes():
    """Count each launch of #1 and #4 by (kernel, rows, tokens) while open:
    #1's qkv is (rows, S, 3, C), #4's q (rows·heads, S, hd). The wrappers
    count their launches on the module's name, so the stand-ins carry the
    count while open and hand it back on exit."""
    from collections import Counter

    from beach_seg_tpu_torch.ops import cuda_attn

    seen = Counter()
    saved = {name: getattr(cuda_attn, name) for name in ("attn_qkv_rel", "attn_bwd")}

    def tally(name):
        def call(x, *args):
            seen[(name, x.shape[0], x.shape[1])] += 1
            return saved[name](x, *args)
        call.launches = saved[name].launches
        return call

    for name in saved:
        setattr(cuda_attn, name, tally(name))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            fn.launches = getattr(cuda_attn, name).launches
            setattr(cuda_attn, name, fn)


def phase_painter_path(device) -> dict:
    """Painter ViT-L (BeachSegConfig(backbone="painter"), bf16, seeded random
    weights) through predict_step and train_step as phases 5–6 run ViT-L:
    24 launches of #1 and #2 a call and of #1, #2, #4 and #5 a step, the
    counts zeroed just before each path; pred_masks and the prompt gradient
    against the plain versions with phases 5–6's limits. Then one more call
    and step with each launch of #1 and #4 counted by shape: 8 on the whole
    56×28 grid and 16 on 14×14 windows (2 launches on 2·B·8 windows before
    the stream merge, 14 on B·8 after it)."""
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.train import PromptTuner
    from beach_seg_tpu_torch.train.loop import model_for_config

    conf = BeachSegConfig(batch_size=B, backbone="painter", compute_dtype="bfloat16")
    model, cfg = model_for_config(conf, device=device, seed=0)
    check(cfg.window_size == PAINTER_WIN[0] and tuple(cfg.global_attn_indexes) == tuple(range(2, 24, 3))
          and cfg.num_hidden_layers == 24 and cfg.hidden_size == C and cfg.head_dim == HD, f"Painter config {cfg}")
    fwd = {"attn_qkv_rel": 24, "ln_mlp": 24}
    m = phase_main_path(device, model, conf, with_stages(fwd))
    tr = phase_train_path(device, model, conf, with_stages(dict(fwd, attn_bwd=24, ln_mlp_dx=24)))

    s, sw = GRID[0] * GRID[1], PAINTER_WIN[0] * PAINTER_WIN[1]
    # (rows, tokens) of #1's launches a call: global block 2 before the merge,
    # 7 global after it; windowed blocks 0 and 1 before it, 14 after it
    shapes = {(2 * B, s): 1, (B, s): 7, (PAINTER_ROWS[1], sw): 2, (PAINTER_ROWS[0], sw): 14}
    want_pred = {("attn_qkv_rel", r, n): k for (r, n), k in shapes.items()}
    want_train = {**want_pred, **{("attn_bwd", r * HEADS, n): k for (r, n), k in shapes.items()}}
    tuner = PromptTuner(model, conf, device=device)
    prompts, batches = main_path_inputs(conf, 4, 1)
    with launch_shapes() as seen:
        tuner.predict_step(*prompts, batches[0], out_size=conf.crop_size)
        torch.cuda.synchronize()
    pred_shapes = dict(seen)
    prompts, batches = train_path_inputs(conf, 4, 1)
    state = tuner.init_state(prompts[0])
    with launch_shapes() as seen:
        tuner.train_step(state, prompts[1], prompts[2], batches[0], generator=torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
    train_shapes = dict(seen)
    log(f"Painter launches by (kernel, rows, tokens): predict call {pred_shapes}; train step {train_shapes}")
    check(pred_shapes == want_pred, f"Painter predict launches by shape {pred_shapes}, want {want_pred}")
    check(train_shapes == want_train, f"Painter train launches by shape {train_shapes}, want {want_train}")
    del model, tuner, state
    torch.cuda.empty_cache()
    return {"predict": m, "train": tr, "predict_shapes": pred_shapes, "train_shapes": train_shapes}


def eva02_attn_bound(rows: int) -> tuple[float, str]:
    """The RoPE attention's least time: QKᵀ and PV at the bf16 peak, or its
    two launches' bytes (qkv in; rotated q, k and biased v out and in; the
    output; the biases and the fp32 cos / sin tables)."""
    s = EVA_GRID[0] * EVA_GRID[1]
    nbytes = 2 * rows * s * C * 10 + 2 * 2 * C + 4 * 2 * s * HD // 2
    return bound(4 * rows * s * s * C, nbytes, PEAK_BF16)


def eva02_mlp_bound(n: int) -> tuple[float, str]:
    """The SwiGLU MLP's least time: its three products at the bf16 peak, or
    its four launches' bytes (x, ln, h, hl out and in at the padded width,
    the output, W1, W2, W3, their biases and the LayerNorms' fp32 params)."""
    mp = -(-EVA_MLP // 64) * 64
    nbytes = 2 * n * (5 * C + 4 * mp) + 2 * (3 * C * mp + 2 * mp + C) + 4 * (2 * C + 2 * mp)
    return bound(6 * n * C * EVA_MLP, nbytes, PEAK_BF16)


def eva02_mlp_inputs(device, seed: int, n: int):
    """x (n, C), the LN(C) params, W1, b1, W2, b2 (C, M), the LN(M) params,
    W3 (M, C), b3, eps: seeded, bf16 activations and weights."""
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *sh, s=1.0: s * torch.randn(sh, generator=g, device=device)  # noqa: E731
    bf, m = torch.bfloat16, EVA_MLP
    return (r(n, C).to(bf), 1 + r(C, s=0.1), r(C, s=0.1), (r(C, m) / C**0.5).to(bf), r(m, s=0.1).to(bf),
            (r(C, m) / C**0.5).to(bf), r(m, s=0.1).to(bf), 1 + r(m, s=0.1), r(m, s=0.1), (r(m, C) / m**0.5).to(bf),
            r(C, s=0.1).to(bf), 1e-6)


def phase_eva02_kernels(device) -> dict:
    """EVA-02-L's two kernels at full width against their plain versions:
    the RoPE attention (bf16, clamp: the model's mode) at EVA_ROWS rows of
    the 64×32 grid, 16 heads of 64, with phase 3's attention limits; the
    SwiGLU MLP at C 1024, M 2730 on EVA_MLP_ROWS rows with #2's limits
    (MLP_BF16_REL_TOL, MLP_NORM_TOL). Each then timed beside its plain
    version and its bound."""
    from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp
    from beach_seg_tpu_torch.ops.attention import rope_tables

    s = EVA_GRID[0] * EVA_GRID[1]
    tables = torch.from_numpy(rope_tables(EVA_GRID, EVA_ROPE_STEP, HD)).to(device)
    res = {}
    for rows in EVA_ROWS:
        g = torch.Generator(device=device).manual_seed(40 + rows)
        qkv = torch.randn((rows, s, 3, C), generator=g, device=device).to(torch.bfloat16)
        qv = (0.1 * torch.randn((2, C), generator=g, device=device)).to(torch.bfloat16)
        args = (qkv, qv, tables, HD**-0.5, HEADS, "clamp")
        res[f"attn_err_{rows}"] = fwd_check(f"attn_qkv_rope bf16 clamp {rows} rows of {EVA_GRID}", cuda_attn.attn_qkv_rope,
                                            cuda_attn.attn_qkv_rope_plain, args, (rows, s, C))
        res[f"attn_ms_{rows}"] = time_ms(lambda: cuda_attn.attn_qkv_rope(*args), iters=20, warmup=2)
        res[f"attn_plain_ms_{rows}"] = time_ms(lambda: cuda_attn.attn_qkv_rope_plain(*args), iters=2)
        res[f"attn_bound_{rows}"] = eva02_attn_bound(rows)
        log(f"times (ms, {rows} rows): attn_qkv_rope kernel {res[f'attn_ms_{rows}']:.4f} plain "
            f"{res[f'attn_plain_ms_{rows}']:.4f} bound {res[f'attn_bound_{rows}'][0]:.4f} ({res[f'attn_bound_{rows}'][1]})")
        del args, qkv
        torch.cuda.empty_cache()
    for n in EVA_MLP_ROWS:
        args = eva02_mlp_inputs(device, 50 + n % 97, n)
        got = cuda_mlp.swiglu_mlp(*args)
        torch.cuda.synchronize()
        res[f"mlp_err_{n}"] = mlp_out_check(f"swiglu_mlp bf16 {n} rows, C {C}, M {EVA_MLP}", got,
                                            cuda_mlp.swiglu_mlp_plain(*args), MLP_BF16_REL_TOL)
        del got
        res[f"mlp_ms_{n}"] = time_ms(lambda: cuda_mlp.swiglu_mlp(*args), iters=10, warmup=2)
        res[f"mlp_plain_ms_{n}"] = time_ms(lambda: cuda_mlp.swiglu_mlp_plain(*args), iters=2)
        res[f"mlp_bound_{n}"] = eva02_mlp_bound(n)
        log(f"times (ms, {n} rows): swiglu_mlp kernel {res[f'mlp_ms_{n}']:.4f} plain {res[f'mlp_plain_ms_{n}']:.4f} "
            f"bound {res[f'mlp_bound_{n}'][0]:.4f} ({res[f'mlp_bound_{n}'][1]})")
        del args
        torch.cuda.empty_cache()
    return res


def phase_eva02_path(device, root: Path) -> dict:
    """EVA-02-L (BeachSegConfig(backbone="eva02"), bf16, seeded random
    weights) through predict_step and train_step as phases 5–6 run ViT-L:
    the RoPE attention and the SwiGLU MLP (and its ``ln_rows`` stage) 24
    times a call, and with #4 24 times a step, no other kernel of the
    counters; pred_masks and the prompt
    gradient against the plain versions with phases 5–6's limits; the
    SwiGLU kernels' 8 rounded, padded operands a block made once over every
    call and step (``swiglu_mlp.operand_builds``). Then
    ``run_training`` (1 epoch, crops of 112 at 448, batch 8) on the
    reference date of a scene with 2 predict dates and ``run_predict`` from
    its EMA export on both, each through both kernels."""
    from beach_seg_tpu_torch.config import BeachSegConfig, PredictionConfig
    from beach_seg_tpu_torch.geo.tiff import read
    from beach_seg_tpu_torch.infer import run_predict
    from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp
    from beach_seg_tpu_torch.train import run_training
    from beach_seg_tpu_torch.train.loop import model_for_config

    conf = BeachSegConfig(batch_size=B, backbone="eva02", compute_dtype="bfloat16")
    model, cfg = model_for_config(conf, device=device, seed=0)
    check(cfg.grid_size == EVA_GRID and cfg.mlp_dim == EVA_MLP and cfg.block == "eva02" and cfg.head_dim == HD
          and cfg.num_hidden_layers == 24, f"EVA-02 config {cfg}")
    fwd = {"attn_qkv_rope": 24, "swiglu_mlp": 24, "ln_rows": 24}  # the SwiGLU chain's first stage is #2's ln_rows
    b0 = cuda_mlp.swiglu_mlp.operand_builds
    m = phase_main_path(device, model, conf, fwd)
    tr = phase_train_path(device, model, conf, dict(fwd, attn_bwd=24), n_steps=2)
    builds = cuda_mlp.swiglu_mlp.operand_builds - b0
    log(f"EVA-02 SwiGLU operands made over the predict and train phases: {builds}")
    check(builds == 8 * 24, f"SwiGLU operands made {builds} times, want 8 a block once")
    del model
    torch.cuda.empty_cache()

    dates = write_scene(root / "eva02_scene", n_dates=2)
    t = time.perf_counter()
    a0, s0 = cuda_attn.attn_qkv_rope.launches, cuda_mlp.swiglu_mlp.launches
    run_dir = run_training(BeachSegConfig(data=root / "eva02_scene", model_training_root=root / "eva02_train",
                                          checkpoint="random", backbone="eva02", compute_dtype="bfloat16", crop_size=112,
                                          inpt_size=448, batch_size=B, epochs=1, num_viz_images=0))
    trained = (cuda_attn.attn_qkv_rope.launches - a0, cuda_mlp.swiglu_mlp.launches - s0)
    train_s = time.perf_counter() - t
    t = time.perf_counter()
    pred = run_predict(PredictionConfig(data=root / "eva02_scene", model_training_root=root / "eva02_pred",
                                        train_run_dir=run_dir, use_ema=True, batch_size=B, compute_dtype="bfloat16"))
    predicted = (cuda_attn.attn_qkv_rope.launches - a0 - trained[0], cuda_mlp.swiglu_mlp.launches - s0 - trained[1])
    predict_s = time.perf_counter() - t
    for date in dates[1:]:
        ids = read(pred / "tif" / f"{date}.tif").data
        check(ids.size > 0 and set(np.unique(ids).tolist()) <= set(range(len(conf.classes))), f"EVA-02 ids of {date}")
    log(f"EVA-02 run_training: {train_s:.3f} s, (attn_qkv_rope, swiglu_mlp) launches {trained}; run_predict on "
        f"{len(dates) - 1} dates: {predict_s:.3f} s, launches {predicted}")
    check(min(trained) > 0 and trained[0] % 24 == 0 and trained[0] == trained[1], f"run_training launches {trained}")
    check(min(predicted) > 0 and predicted[0] % 24 == 0 and predicted[0] == predicted[1], f"run_predict launches {predicted}")
    return {"predict": m, "train": tr, "operand_builds": builds, "run_training_s": train_s, "run_predict_s": predict_s,
            "launches_run_training": trained, "launches_run_predict": predicted}


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
    from beach_seg_tpu_torch.ops import attention, cuda_attn, cuda_gemm, cuda_mlp

    names = ((cuda_gemm, "linear_f32", cuda_gemm.linear_f32_plain),
             (cuda_attn, "attn_qkv_rel", cuda_attn.attn_qkv_rel_plain), (cuda_attn, "attn_bwd", attention.attention_bwd_plain),
             (cuda_mlp, "ln_mlp", cuda_mlp.ln_mlp_plain), (cuda_mlp, "ln_mlp_dx", cuda_mlp.ln_mlp_dx_plain),
             (cuda_attn, "attn_packed", attention.attention_packed_plain),
             (cuda_attn, "attn_fused", attention.attention_fused_plain),
             (cuda_attn, "attn_qkv", attention.attention_qkv_plain),
             (cuda_attn, "attn_qkv_rope", cuda_attn.attn_qkv_rope_plain), (cuda_mlp, "swiglu_mlp", cuda_mlp.swiglu_mlp_plain))
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


def phase_main_path(device, model, conf, expect: dict, n_batches: int = 3, linear: int | None = None) -> dict:
    """PromptTuner.predict_step on ``n_batches`` batches of B crops; each
    call must launch the kernels ``expect`` names that many times and the
    others not at all (and, given ``linear``, the fp32 linear products'
    kernel that many times, making no weight parts after the first call);
    one batch's pred_masks held against the plain versions."""
    from beach_seg_tpu_torch.ops import cuda_gemm
    from beach_seg_tpu_torch.train import PromptTuner
    from beach_seg_tpu_torch.transforms import decode_by_palette

    n_prompts = 4
    tuner = PromptTuner(model, conf, device=device)
    prompts, batches = main_path_inputs(conf, n_prompts, n_batches)
    want_calls = {name: expect.get(name, 0) for name in counters()}

    reset_counts()
    seconds, per_call, lin = [], [], []
    for batch in batches:
        before = read_counts()
        l0 = (cuda_gemm.linear_f32.launches, cuda_gemm.linear_f32.cache_builds)
        t = time.perf_counter()
        ids = tuner.predict_step(*prompts, batch, out_size=conf.crop_size)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        now = read_counts()
        per_call.append({k: now[k] - before[k] for k in now})
        lin.append((cuda_gemm.linear_f32.launches - l0[0], cuda_gemm.linear_f32.cache_builds - l0[1]))
        check(tuple(ids.shape) == (B, conf.crop_size, conf.crop_size), f"ids shape {tuple(ids.shape)}")
        check(ids.dtype == torch.uint8 and ids.device.type == "cuda", f"ids {ids.dtype} on {ids.device}")
        check(int(ids.max()) < len(conf.classes), f"id {int(ids.max())} out of range")
    launches = read_counts()
    log(f"main path: predict_step seconds per call {seconds}; launches per call {per_call}; "
        f"linear_f32 launches and weight parts made per call {lin}")
    check(all(pc == want_calls for pc in per_call), f"launches per call {per_call}, want {want_calls}")
    if linear is not None:
        check(all(n == linear for n, _ in lin) and all(c == 0 for _, c in lin[1:]),
              f"linear_f32 launches and parts made per call {lin}, want {linear} and none after the first")

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
    return {"launches": launches, "seconds": seconds, "pred_err": err, "id_agreement": agree, "linear": lin}


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
                     grad_limits: tuple[float, float] = (GRAD_1MCOS_MAX, GRAD_REL_TOL), linear: int | None = None) -> dict:
    """PromptTuner.train_step at full width (the predict phase's model, now
    with gradients through it), each step launching the kernels ``expect``
    names that many times and the others not at all (and, given ``linear``,
    the fp32 linear products' kernel that many times, making no weight parts
    after the first step); then one step's prompt gradient through the
    kernels and through the plain versions on the same draws, within
    ``grad_limits`` (1 − cosine, max error / max|plain|)."""
    from beach_seg_tpu_torch.ops import cuda_gemm
    from beach_seg_tpu_torch.train import PromptTuner

    want_steps = {name: expect.get(name, 0) for name in counters()}
    tuner = PromptTuner(model, conf, device=device)
    prompts, batches = train_path_inputs(conf, 4, n_steps)
    state = tuner.init_state(prompts[0])
    start = state.prompt_pixels.clone()
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds, losses, per_step, lin = [], [], [], []
    for batch in batches:
        before = read_counts()
        l0 = (cuda_gemm.linear_f32.launches, cuda_gemm.linear_f32.cache_builds)
        t = time.perf_counter()
        state, metrics = tuner.train_step(state, prompts[1], prompts[2], batch, generator=gen)
        loss = metrics["loss"].item()  # syncs
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        losses.append(loss)
        now = read_counts()
        per_step.append({k: now[k] - before[k] for k in now})
        lin.append((cuda_gemm.linear_f32.launches - l0[0], cuda_gemm.linear_f32.cache_builds - l0[1]))
        check(math.isfinite(loss), f"train loss {loss}")
        check(int(metrics["confusion"].sum()) > 0, "empty confusion matrix")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"train path: train_step seconds per step {seconds}; losses {losses}; launches per step {per_step}; "
        f"linear_f32 launches and weight parts made per step {lin}; peak memory {peak / 2**30:.3f} GiB")
    check(all(ps == want_steps for ps in per_step), f"launches per step {per_step}, want {want_steps}")
    if linear is not None:
        check(all(n == linear for n, _ in lin) and all(c == 0 for _, c in lin[1:]),
              f"linear_f32 launches and parts made per step {lin}, want {linear} and none after the first")
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
    return {"launches": launches, "seconds": seconds, "losses": losses, "peak_bytes": peak, "grad_cos": cos, "grad_err": err,
            "linear": lin}


# the scene engines' synthetic scene: a 6 km stretch of coast at 3 m pixels,
# 4-band uint16, one reference date and SCENE_DATES predict dates, each date
# two overlapping GeoTIFF tiles; the tuned-predict phase runs on the first
# TUNED_DATES of them (a view of the same files)
SCENE_W, SCENE_H, SCENE_PIX = 2048, 1024, 3.0
SCENE_DATES = 8
TUNED_DATES = 4
# the zero-shot and legacy phase's dates: 4 of the 8, which keeps the whole
# script, the two-rank and CLI phase included, near its time budget
ENGINE_DATES = 4
SCENE_EPSG = 32611
SCENE_ORIGIN = (500000.0, 4100000.0)


def shoreline_row(x: np.ndarray, shift: float = 0.0) -> np.ndarray:
    """The wavy water line's row at column ``x`` (two waves, ±85 rows)."""
    return 0.55 * SCENE_H + 60 * np.sin(2 * np.pi * x / 700) + 25 * np.sin(2 * np.pi * x / 230 + 1) + shift


def write_scene(root: Path, n_dates: int = SCENE_DATES, seed: int = 0, bands: int = 4) -> list[str]:
    """The reference's data layout under ``root``, written with the port's
    geo writers (Masks/Mask_<DATE>.shp, Masks/WaterMask_<DATE>.shp,
    SatelliteImagery/files/<DATE>_{a,b}.tif): water below a wavy shoreline
    across the full width, vegetation above a second wavy line, sand between;
    each date shifts the shoreline a little. ``bands``: 4 (Dove) or 8
    (SuperDove, the spectra of tests/synthetic_scene.build_scene_8band, which
    the display path takes through broad_band). → the dates, reference first."""
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
    # (water, sand, vegetation) levels of each band
    spectra = {4: [(900, 2200, 1200), (1000, 2400, 1300), (1100, 2600, 1500), (400, 2800, 2300)],
               8: [(400 + 60 * b, 2000 + 150 * b, 1000 + 90 * b) for b in range(8)]}[bands]
    # the native encoder releases the GIL: the tiles are written on a pool,
    # LZW (the writer's default) and deflate in turns
    with ThreadPoolExecutor(max_workers=8) as pool:
        writes = []
        for i, date in enumerate(dates):
            wet = rows >= shoreline_row(cols, shift=6 * i)
            green = rows < shoreline_row(cols) - 220 + 30 * np.cos(2 * np.pi * cols / 500)
            dry = ~wet & ~green
            img = np.empty((bands, SCENE_H, SCENE_W), np.uint16)
            for b, (wv, sv, vv) in enumerate(spectra):
                base = np.where(wet, wv, 0) + np.where(dry, sv, 0) + np.where(green, vv, 0)
                img[b] = np.clip(base + rng.integers(0, 120, (SCENE_H, SCENE_W)), 1, 65535)
            for tag, c0, c1, compress in (("a", 0, half + lap, "lzw"), ("b", half - lap, SCENE_W, "deflate")):
                t = Affine.from_origin(x0 + c0 * SCENE_PIX, y0, SCENE_PIX, SCENE_PIX)
                writes.append(pool.submit(write, img_dir / f"{date}_{tag}.tif", img[:, :, c0:c1], t, crs=SCENE_EPSG,
                                          nodata=0, compress=compress))
        for w in writes:
            w.result()
    return dates


def scene_run(data: Path, out: Path, dtype: str, merge: str, overlap: int, expect: dict, crops_by_overlap: dict,
              dates: list[str], plain: bool = False, train_run_dir: Path | None = None, **fields) -> dict:
    """run_predict once on the card (``plain``: through the plain versions;
    ``train_run_dir``: from that run's conf.yaml and EMA prompt export;
    ``fields``: PredictionConfig fields over these);
    its outputs checked for every predict date (a GeoTIFF of the scene's
    shape and CRS with ids in 0..3, the mask PNG, the overlay), timings.json's
    tile count, and the launch counters: ``expect`` (launches per batch) times
    the batches, every other kernel idle."""
    from beach_seg_tpu_torch.config import PredictionConfig
    from beach_seg_tpu_torch.geo.tiff import read
    from beach_seg_tpu_torch.infer import run_predict

    conf = PredictionConfig(**{**dict(data=data, model_training_root=out, checkpoint="random", batch_size=B,
                                      compute_dtype=dtype, merge=merge, overlap=overlap, train_run_dir=train_run_dir,
                                      use_ema=train_run_dir is not None), **fields})
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


def scene_view(src: Path, dst: Path, dates: list[str]) -> Path:
    """``dst``: the scene under ``src`` cut to ``dates`` (the reference date
    first), as symbolic links to its files."""
    (dst / "SatelliteImagery" / "files").mkdir(parents=True)
    (dst / "Masks").symlink_to(src / "Masks", target_is_directory=True)
    for date in dates:
        for tif in (src / "SatelliteImagery" / "files").glob(f"{date}_*.tif"):
            (dst / "SatelliteImagery" / "files" / tif.name).symlink_to(tif)
    return dst


def phase_scene_engine(root: Path, dates: list[str], large: dict, card: str) -> dict:
    """infer.predict.run_predict end to end at full width (ViT-L, random
    weights from the seed): the SCENE_W × SCENE_H scene of the reference date
    and the predict dates ``dates[1:]`` under ``root / "scene"`` → per-date
    GeoTIFFs, mask PNGs and overlays, in
    bf16 vote mode, bf16 blend mode (overlap 56), bf16 vote mode through the
    plain versions (the ids held to ID_AGREEMENT_MIN of the voted pixels) and
    the default fp32 vote mode (#1 on its split-TF32 body)."""
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.data.dataset import create_scene

    crops = {ov: create_scene(BeachSegConfig(data=root / "scene"), train=True, crop_overlap=ov).crops for ov in (0, 56)}
    log(f"scene engine: {len(crops[0])} crops at overlap 0, {len(crops[56])} at 56")
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


def meeting(crops: list) -> int:
    """The crops that meet the scene: every date covers the whole scene, so
    these are the tiles of a date that are not all nodata."""
    return sum(1 for x0, y0, x1, y1 in crops if x1 > 0 and y1 > 0 and x0 < SCENE_W and y0 < SCENE_H)


def engine_run(engine: str, data: Path, out: Path, dtype: str, expect: dict, crops: list, dates: list[str],
               plain: bool = False, **fields) -> dict:
    """run_zero_shot or run_legacy once on the card (``plain``: through the
    plain versions; ``fields``: config fields over these); its outputs checked for every predict date (zero-shot: a
    GeoTIFF of the scene's shape and CRS with ids in 0..3 and the mask PNG;
    legacy: a 1-bit GeoTIFF per exported class), timings.json's tile count,
    and the launch counters: ``expect`` (launches per batch) times the
    batches, every other kernel idle."""
    from beach_seg_tpu_torch.config import LegacyConfig, PredConfig
    from beach_seg_tpu_torch.geo.tiff import read
    from beach_seg_tpu_torch.infer import run_legacy, run_zero_shot

    common = {**dict(data=data, model_training_root=out, checkpoint="random", batch_size=B, compute_dtype=dtype), **fields}
    tiles = meeting(crops) * (len(dates) - 1)
    n_batches = (len(dates) - 1) * math.ceil(meeting(crops) / B)
    reset_counts()
    t = time.perf_counter()
    with plain_kernels() if plain else contextlib.nullcontext():
        run_dir = run_zero_shot(PredConfig(**common)) if engine == "zero_shot" else run_legacy(LegacyConfig(**common))
    seconds = time.perf_counter() - t
    launches = read_counts()
    timings = json.loads((run_dir / "timings.json").read_text())
    ids = {}
    for date in dates[1:]:
        if engine == "zero_shot":
            files = {"ids": run_dir / "tif" / f"{date}.tif"}
            check((run_dir / "masks" / f"{date}.png").stat().st_size > 0, f"{date}: mask PNG missing")
        else:
            files = {name: run_dir / f"{name}_{date}.tif" for name in ("WetDryLine", "VegLine")}
        for name, path in files.items():
            r = read(path)
            check(r.data.shape == (1, SCENE_H, SCENE_W) and r.crs == f"EPSG:{SCENE_EPSG}", f"{path.name}: {r.data.shape} {r.crs}")
            allowed = {0, 1, 2, 3} if engine == "zero_shot" else {0, 1}
            check(set(np.unique(r.data).tolist()) <= allowed, f"{path.name}: ids {np.unique(r.data)}")
            ids[(date, name)] = r.data[0]
    check(timings["tiles"] == tiles, f"{engine} timings tiles {timings['tiles']}, want {tiles}")
    want = {name: expect.get(name, 0) * n_batches for name in counters()}
    tag = f"{engine} {dtype}{' plain' if plain else ''}"
    log(f"{tag}: {len(crops)} crops x {len(dates) - 1} dates, {n_batches} batches of {B} queries, {seconds:.3f} s; "
        f"timings.json {json.dumps(timings)}; launches {launches}")
    check(launches == want, f"{tag}: launches {launches}, want {want}")
    return {"ids": ids, "timings": timings, "seconds": seconds, "launches": launches, "batches": n_batches}


def engine_batch_check(device) -> dict:
    """#1 and #2 at the batches the zero-shot and legacy engines give them,
    each against its plain version: 8 queries by 2 prompts, 2·Q·P = 32 rows
    before the stream merge and Q·P = 16 after, and the odd batches of Q=3
    by P=3, 18 rows then 9. #1 in bf16 (clamp) and fp32 (stable) with
    ``fwd_check``'s limits; the three stage kernels of #2 at N = 32·S and
    16·S rows with ``mlp_stage_check``'s. Returns the largest errors, keyed
    "<kernel> <dtype> B=<rows>"."""
    from beach_seg_tpu_torch.ops import cuda_attn

    s = GRID[0] * GRID[1]
    errs = {}
    for dtype, softmax in ((torch.bfloat16, "clamp"), (torch.float32, "stable")):
        for b in ENGINE_ROWS:
            args = (*attn_inputs(dtype, device, b=b, seed=b), HD**-0.5, GRID[1], HEADS, softmax)
            name = f"attn_qkv_rel {'bf16' if dtype == torch.bfloat16 else 'fp32'} B={b}"
            errs[name] = fwd_check(name, cuda_attn.attn_qkv_rel, cuda_attn.attn_qkv_rel_plain, args, (b, s, C))
    for b in ENGINE_ROWS[:2]:
        for stage, err in mlp_stage_check(device, b * s, C, MLP, seed=b, timed=False, forward_only=True).items():
            errs[f"{stage.removesuffix('_err')} bf16 B={b}"] = err
        torch.cuda.empty_cache()
    return errs


def votes_check(device, crops: list) -> None:
    """scatter_votes on the card against the same call on the CPU, bit for
    bit: a batch of B zero-shot crops (some reaching past the scene's edge)
    of seeded ids, one row not valid, added twice into a scene-sized counter."""
    from beach_seg_tpu_torch.infer.device_votes import scatter_votes, zero_counter

    rng = np.random.default_rng(5)
    cs = crops[0][2] - crops[0][0]
    picked = [crops[i % len(crops)] for i in range(B)]
    one_hot = torch.from_numpy(np.eye(4, dtype=np.int32)[rng.integers(0, 4, (B, cs, cs))])
    xmins = torch.tensor([c[0] for c in picked], dtype=torch.int32)
    ymins = torch.tensor([c[1] for c in picked], dtype=torch.int32)
    valid = torch.ones(B, dtype=torch.bool)
    valid[-1] = False
    want, got = zero_counter((SCENE_H, SCENE_W), 4), zero_counter((SCENE_H, SCENE_W), 4, device=device)
    for _ in range(2):
        scatter_votes(want, one_hot, xmins, ymins, valid)
        scatter_votes(got, one_hot.to(device), xmins.to(device), ymins.to(device), valid.to(device))
    same = torch.equal(got.cpu(), want)
    log(f"scatter_votes: ({SCENE_H}, {SCENE_W}, 4) counter, {B} crops of {cs}, card equals CPU: {same}; "
        f"{int(want.sum())} votes")
    check(same and int(want.sum()) > 0, "scatter_votes on the card differs from the CPU's")


def phase_other_engines(device, root: Path, dates: list[str], large: dict, card: str) -> dict:
    """infer.zero_shot.run_zero_shot and infer.legacy.run_legacy end to end at
    full width (ViT-L, random weights from the seed, batch 8) on the whole
    scene of phase 17 (the first ENGINE_DATES dates): zero-shot in bf16 (crops of 336, 2 prompts: 8 queries a batch,
    32 rows before the stream merge), in fp32, and in bf16 through the plain
    versions (the bf16 mosaics held to ID_AGREEMENT_MIN of the voted pixels);
    legacy in bf16 (crops of 224 at overlap 112, the reference date's first 2
    crops as prompts); then #1 and #2 at the engines' batch shapes
    (``engine_batch_check``) and scatter_votes on the card against the CPU."""
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.data.dataset import create_scene

    data = root / "scene"
    zs_crops = create_scene(BeachSegConfig(data=data, crop_size=336), train=True).crops
    lg_crops = create_scene(BeachSegConfig(data=data, crop_size=224), train=True, crop_overlap=112).crops
    log(f"zero-shot and legacy engines: {len(zs_crops)} crops of 336, {len(lg_crops)} of 224 at overlap 112")
    runs = {
        "zero_shot_bf16": engine_run("zero_shot", data, root / "out", "bfloat16", large, zs_crops, dates),
        "zero_shot_fp32": engine_run("zero_shot", data, root / "out", "float32", {"attn_qkv_rel": 24}, zs_crops, dates),
        "legacy_bf16": engine_run("legacy", data, root / "out", "bfloat16", large, lg_crops, dates),
        "zero_shot_bf16_plain": engine_run("zero_shot", data, root / "out", "bfloat16", {}, zs_crops, dates, plain=True),
    }
    got = {d: runs["zero_shot_bf16"]["ids"][(d, "ids")] for d in dates[1:]}
    want = {d: runs["zero_shot_bf16_plain"]["ids"][(d, "ids")] for d in dates[1:]}
    agree = vote_agreement(got, want, zs_crops)
    log(f"zero-shot bf16 mosaics kernels vs plain: {agree:.6f} of voted pixels equal (min {ID_AGREEMENT_MIN})")
    check(agree >= ID_AGREEMENT_MIN, f"zero-shot bf16 mosaics agree on {agree} of voted pixels")
    batches = engine_batch_check(device)
    votes_check(device, zs_crops)
    for name, r in runs.items():
        log(f"{name}: stream_tiles_per_sec {r['timings']['stream_tiles_per_sec']}, run {r['seconds']:.3f} s, "
            f"timings {json.dumps(r['timings'])} ({card})")
    return {"runs": runs, "agreement_bf16": agree, "engine_batches": batches}


# the training runtime's run: the reference date's crops at full width
TRAIN_EPOCHS, RESUME_EPOCHS = 2, 3
# the artifacts of the JAX package's train run dir (its loop.py), here with
# the port's own state checkpoints under checkpoints/step_N
RUN_DIR_FILES = ("conf.yaml", "classes.txt", "log.log", "metrics.csv", "prompt_batch.npz", "prompt_batch_tuned.npz",
                 "prompt_batch_ema.npz", "prompt_batch_best.npz", "best.json")


def count_calls(fn, log_to: list):
    """``fn`` wrapped to append the launch counters' rise over each call to
    ``log_to`` (a chip-smoke probe around the tuner's steps)."""
    def wrapped(*args, **kwargs):
        before = read_counts()
        out = fn(*args, **kwargs)
        now = read_counts()
        log_to.append({k: now[k] - before[k] for k in now if now[k] != before[k]})
        return out
    return wrapped


def remat_check(device, conf, card: str, fwd: dict, bwd: dict,
                grad_limits: tuple[float, float] = (GRAD_1MCOS_MAX, GRAD_REL_TOL)) -> dict:
    """One train_step of ``conf``'s model with remat and one without (the same
    model, ``encoder.remat`` switched), from the same fresh state and draws:
    the prompt gradients (Adam's first moment after one step, 0.1·g)
    bit-equal or within ``grad_limits``, the launches (``fwd``'s and
    ``bwd``'s a step; remat runs the forward kernels ``fwd`` a second time in
    the backward), and the peak device memory of each, which remat must
    lower."""
    from beach_seg_tpu_torch.train import PromptTuner
    from beach_seg_tpu_torch.train.loop import model_for_config

    model, _ = model_for_config(conf, device)
    tuner = PromptTuner(model, conf, device=device)
    prompts, batches = train_path_inputs(conf, 4, 1)
    draws = tuner.step_draws(batches[0], 4, torch.Generator(device=device).manual_seed(11))
    out = {}
    for remat in (False, True):
        model.encoder.remat = remat
        state = tuner.init_state(prompts[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state, metrics = tuner.train_step(state, prompts[1], prompts[2], batches[0], draws=draws)
        torch.cuda.synchronize()
        out[remat] = {"mu": state.opt_state["mu"], "loss": metrics["loss"].item(), "peak": torch.cuda.max_memory_allocated(),
                      "launches": {k: v for k, v in read_counts().items() if v}}
    got, want = out[True]["mu"], out[False]["mu"]
    equal = torch.equal(got, want)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    a, b = got.double().flatten(), want.double().flatten()  # in fp64: cosine_similarity clamps norms below 1e-8
    cos = (torch.dot(a, b) / (a.norm() * b.norm())).item()
    log(f"remat: train_step peak memory {out[False]['peak']} bytes without remat, {out[True]['peak']} with "
        f"({out[True]['peak'] / out[False]['peak']:.4f}); prompt gradient bit-equal {equal}, max_abs_err {err:.4e} "
        f"(max|g| {scale / 0.1:.4e}), 1 - cosine {1 - cos:.4e}; losses {out[False]['loss']} / {out[True]['loss']}; "
        f"launches without {out[False]['launches']}, with {out[True]['launches']} ({card})")
    cos_max, rel_tol = grad_limits
    check(scale > 0 and (equal or (1 - cos <= cos_max and err <= rel_tol * scale)),
          "the remat step's prompt gradient disagrees with the plain step's")
    want_launches = with_stages({**fwd, **bwd})
    remat_launches = with_stages({**{k: 2 * v for k, v in fwd.items()}, **bwd})
    check(out[False]["launches"] == want_launches and out[True]["launches"] == remat_launches,
          f"remat launches {out[True]['launches']}, want {remat_launches}; without {out[False]['launches']}")
    check(out[True]["peak"] < out[False]["peak"], "remat did not lower the train step's peak memory")
    res = {"peak_bytes": out[False]["peak"], "peak_bytes_remat": out[True]["peak"], "grad_bit_equal": equal,
           "grad_err": err, "launches": out[False]["launches"], "launches_remat": out[True]["launches"]}
    del model, tuner, out, got, want
    torch.cuda.empty_cache()
    return res


def counted_training(conf) -> tuple[Path, dict, list, list, float]:
    """run_training(conf) on the card with the launch counters' rise over each
    train step and eval batch recorded → the run dir, the run's launches, the
    rise of each step and of each eval batch, and the run's seconds."""
    from beach_seg_tpu_torch.train import PromptTuner, run_training

    steps, evals = [], []
    train_step, eval_step = PromptTuner.train_step, PromptTuner.eval_step
    PromptTuner.train_step, PromptTuner.eval_step = count_calls(train_step, steps), count_calls(eval_step, evals)
    try:
        reset_counts()
        t = time.perf_counter()
        run_dir = run_training(conf)
        seconds = time.perf_counter() - t
    finally:
        PromptTuner.train_step, PromptTuner.eval_step = train_step, eval_step
    return run_dir, read_counts(), steps, evals, seconds


def check_training_run(run_dir: Path, launches: dict, steps: list, evals: list, train_want: dict, eval_want: dict,
                       epochs: int) -> dict:
    """A run_training run of ``epochs`` from step 0: ``train_want`` launches a
    train step and ``eval_want`` an eval batch, nothing else; the JAX run
    dir's artifacts and a checkpoint an epoch; one metrics.csv row a step
    with a finite train/loss; the tuned pixels moved and the EMA pixels
    nearer the initial ones. → the steps an epoch, the losses, StepTimer's
    rates and the mean pixel moves."""
    from beach_seg_tpu_torch.train.checkpoint import load_prompt_batch

    pre, tuned, ema = (load_prompt_batch(run_dir / f"prompt_batch{s}.npz")["image"] for s in ("", "_tuned", "_ema"))
    per_epoch = math.ceil(len(pre) / B)
    n_train = per_epoch * epochs
    check(len(steps) == n_train and len(evals) == n_train, f"{len(steps)} train steps, {len(evals)} eval batches, want {n_train}")
    check(all(st == train_want for st in steps), f"launches per train step {steps}, want {train_want}")
    check(all(ev == eval_want for ev in evals), f"launches per eval batch {evals}, want {eval_want}")
    run_want = {k: n_train * (train_want.get(k, 0) + eval_want.get(k, 0)) for k in counters()}
    check(launches == run_want, f"run_training launches {launches}, want {run_want}")
    missing = [f for f in RUN_DIR_FILES if not (run_dir / f).is_file()]
    ckpts = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
    check(not missing, f"run dir lacks {missing}")
    check(ckpts == [f"step_{per_epoch * (e + 1)}" for e in range(epochs)], f"checkpoints {ckpts}")
    with open(run_dir / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["train/loss"]) for r in rows if r.get("train/loss")]
    rates = [float(r["perf/steps_per_sec"]) for r in rows if r.get("perf/steps_per_sec")]
    check(len(losses) == n_train and all(math.isfinite(x) for x in losses), f"train/loss rows {losses}")
    d_tuned, d_ema = np.abs(tuned - pre).mean(), np.abs(ema - pre).mean()
    check(np.isfinite(tuned).all() and np.isfinite(ema).all() and d_tuned > 0, "tuned pixels did not move or are not finite")
    check(0 < d_ema < d_tuned and not np.array_equal(ema, tuned), f"EMA not between the initial and tuned pixels: {d_ema} vs {d_tuned}")
    return {"per_epoch": per_epoch, "losses": losses, "rates": rates, "d_tuned": d_tuned, "d_ema": d_ema}


def phase_training(device, root: Path, dates: list[str], card: str) -> dict:
    """train.loop.run_training end to end at full width on phase 17's scene
    (ViT-L, random weights from the seed, bf16, crops of 112 tiled to 448,
    batch 8, 2 epochs, the profiler on, every step logged): the run's
    launches and artifacts (``check_training_run``) and the profiler's
    trace; then a resume to 3 epochs (starts at step 6, writes step_9 only,
    the same launches a step), the remat step (``remat_check``), and
    run_predict from the run's EMA export on one date in bf16 vote mode."""
    from beach_seg_tpu_torch.config import BeachSegConfig, PredictionConfig
    from beach_seg_tpu_torch.geo.tiff import read
    from beach_seg_tpu_torch.infer import run_predict
    from beach_seg_tpu_torch.train.loggers import MetricsLogger
    from beach_seg_tpu_torch.utils.profiling import TRACE_NAME

    conf = BeachSegConfig(data=root / "all" / "scene", model_training_root=root / "train_out", checkpoint="random",
                          compute_dtype="bfloat16", crop_size=112, inpt_size=448, batch_size=B, epochs=TRAIN_EPOCHS,
                          profile=True, log_every_n_steps=1, num_viz_images=2)
    train_want = with_stages({"attn_qkv_rel": 24, "ln_mlp": 24, "attn_bwd": 24, "ln_mlp_dx": 24})
    eval_want = with_stages({"attn_qkv_rel": 24, "ln_mlp": 24})
    run_dir, launches, steps, evals, train_s = counted_training(conf)
    resumed, _, resume_steps, resume_evals, resume_s = counted_training(dataclasses.replace(
        conf, epochs=RESUME_EPOCHS, resume_from=run_dir, profile=False, model_training_root=root / "resume_out"))
    run = check_training_run(run_dir, launches, steps, evals, train_want, eval_want, TRAIN_EPOCHS)
    per_epoch = run["per_epoch"]
    log(f"training runtime: {TRAIN_EPOCHS} epochs of {per_epoch} steps in {train_s:.3f} s, the resume to "
        f"{RESUME_EPOCHS} in {resume_s:.3f} s; launches per train step {steps + resume_steps}; per eval batch "
        f"{evals + resume_evals} ({card})")
    n_resumed = per_epoch * (RESUME_EPOCHS - TRAIN_EPOCHS)
    check(len(resume_steps) == n_resumed and len(resume_evals) == n_resumed,
          f"the resume ran {len(resume_steps)} train steps and {len(resume_evals)} eval batches, want {n_resumed}")
    check(all(st == train_want for st in resume_steps) and all(ev == eval_want for ev in resume_evals),
          f"the resume's launches {resume_steps} {resume_evals}")

    trace = run_dir / "profile" / TRACE_NAME
    check(trace.is_file() and trace.stat().st_size > 0, "no profiler trace")
    events = json.loads(trace.read_text()).get("traceEvents", [])
    kernel_events = sum(1 for ev in events if ev.get("cat") == "kernel")
    logger_kind = "tensorboardX+csv" if (run_dir / "tb").is_dir() and any((run_dir / "tb").iterdir()) else "csv"
    probe = MetricsLogger(root / "probe_logger")
    probe.close()
    check(logger_kind == probe.kind, f"the run wrote {logger_kind}, but MetricsLogger here is {probe.kind}")
    with open(resumed / "metrics.csv") as f:
        first_step = int(next(csv.DictReader(f))["step"])
    resumed_ckpts = sorted(p.name for p in (resumed / "checkpoints").iterdir())
    check(first_step == per_epoch * TRAIN_EPOCHS and resumed_ckpts == [f"step_{per_epoch * RESUME_EPOCHS}"],
          f"the resume started at step {first_step} and wrote {resumed_ckpts}")
    log(f"training runtime: loggers {logger_kind}; StepTimer steps/sec {run['rates']}; train/loss {run['losses']}; "
        f"mean |tuned - initial| {run['d_tuned']:.4e}, |EMA - initial| {run['d_ema']:.4e}; trace {trace.stat().st_size} "
        f"bytes, {kernel_events} kernel events; resume from step {first_step} to {resumed_ckpts} ({card})")

    remat = remat_check(device, conf, card, {"attn_qkv_rel": 24, "ln_mlp": 24}, {"attn_bwd": 24, "ln_mlp_dx": 24})

    scene_view(root / "all" / "scene", root / "train_pred" / "scene", dates[:2])
    pred_conf = PredictionConfig(data=root / "train_pred" / "scene", model_training_root=root / "train_pred" / "out",
                                 train_run_dir=run_dir, use_ema=True, checkpoint="random", batch_size=B,
                                 compute_dtype="bfloat16")
    reset_counts()
    t = time.perf_counter()
    pred_dir = run_predict(pred_conf)
    pred_s = time.perf_counter() - t
    pred_launches = read_counts()
    r = read(pred_dir / "tif" / f"{dates[1]}.tif")
    check(r.data.shape == (1, SCENE_H, SCENE_W) and r.crs == f"EPSG:{SCENE_EPSG}", f"EMA predict: {r.data.shape} {r.crs}")
    check(set(np.unique(r.data).tolist()) <= {0, 1, 2, 3}, f"EMA predict ids {np.unique(r.data)}")
    pred_batches = per_epoch  # the reference date's crops, in batches of B
    check(pred_launches == {k: eval_want.get(k, 0) * pred_batches for k in counters()}, f"EMA predict launches {pred_launches}")
    log(f"training runtime: run_predict from the EMA export, 1 date, {pred_batches} batches, {pred_s:.3f} s, "
        f"timings {(pred_dir / 'timings.json').read_text()} ({card})")
    return {"launches": launches, "train_steps": steps + resume_steps, "eval_batches": evals + resume_evals,
            "train_s": train_s, "resume_s": resume_s, "steps_per_sec": run["rates"], "logger": logger_kind,
            "kernel_events": kernel_events, "remat": remat, "predict_s": pred_s, "per_epoch": per_epoch}


# phase 21: BASELINE.json config #5, multi-class segmentation of an 8-band
# SuperDove scene with ViT-H at its default fp32: the scene's 1 reference and 2
# predict dates (SCENE_W × SCENE_H, two overlapping tiles a date)
SUPERDOVE_DATES = 2


@contextlib.contextmanager
def launch_events(names=("attn_packed", "attn_bwd")):
    """The cuda_attn wrappers ``names`` with a CUDA event recorded before and
    after each call (their launch counts carried through) → {name: [(start,
    end), ...]}; ``event_ms`` reads the device time between them."""
    from beach_seg_tpu_torch.ops import cuda_attn

    saved = {n: getattr(cuda_attn, n) for n in names}
    events = {n: [] for n in names}

    def timed(name, fn):
        def call(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events[name].append((start, end))
            return out
        call.launches = fn.launches  # the wrapper's body counts through its module's name
        return call

    for n, fn in saved.items():
        setattr(cuda_attn, n, timed(n, fn))
    try:
        yield events
    finally:
        for n, fn in saved.items():
            fn.launches = getattr(cuda_attn, n).launches
            setattr(cuda_attn, n, fn)


def event_ms(pairs: list) -> float:
    """The median device ms of ``launch_events``' calls (after a sync)."""
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def vit_h_batch_check(device, rows: tuple[int, ...]) -> dict:
    """#3 at ViT-H's widths (16 heads of 80) at ``rows`` batch rows, bf16 and
    fp32, against its plain version with ``fwd_check``'s limits, and the
    three stage kernels of #2 at C=1280, N = B·S with ``mlp_stage_check``'s.
    → the largest errors, keyed "<kernel> <dtype> B=<rows>"."""
    from beach_seg_tpu_torch.ops import cuda_attn
    from beach_seg_tpu_torch.ops.attention import attention_packed_plain

    s = GRID[0] * GRID[1]
    errs = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for b in rows:
            key = f"attn_packed {name} B={b}"
            args = (*packed_inputs(device, dtype, b * HEADS, HD_H, seed=20 + b), HD_H**-0.5, HEADS)
            errs[key] = fwd_check(f"{key} (ViT-H)", cuda_attn.attn_packed, attention_packed_plain, args, (b, s, C_H))
            del args
    for stage, err in mlp_stage_check(device, B * s, C_H, MLP_H, seed=21, timed=False, forward_only=True).items():
        errs[f"{stage.removesuffix('_err')} bf16 B={B}"] = err
    torch.cuda.empty_cache()
    return errs


def phase_superdove(device, root: Path, card: str) -> dict:
    """BASELINE.json config #5 end to end at full width: an 8-band uint16
    scene (``write_scene(bands=8)``, 1 reference and SUPERDOVE_DATES predict
    dates); BeachSegConfig(backbone="huge") at its default fp32 (ViT-H,
    seeded random weights): 3 train_steps at B=8 (``phase_train_path``, 32
    launches each of #3 and #4 a step and nothing else, the prompt gradient
    within phase 12's fp32 limits), #3's and #4's in-model ms a call, the
    peak memory without and with remat (``remat_check``); #3 at head_dim 80
    at run_predict's batch rows and the scene's odd tail, and the C=1280 MLP
    stages (``vit_h_batch_check``); run_training on the scene (crops of 112
    tiled to 448, batch 8, 2 epochs, every step logged;
    ``check_training_run``: 32 launches of #3 and #4 a train step and of #3
    an eval batch); run_predict from the run's EMA export on the predict
    dates in fp32 vote, bf16 vote (32 launches of #3 and #2 a batch) and
    bf16 vote through the plain versions (``scene_run``: GeoTIFFs of the
    scene's shape and CRS, ids in 0..3), the bf16 ids ≥ ID_AGREEMENT_MIN
    equal to the plain run's."""
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.data.dataset import create_scene
    from beach_seg_tpu_torch.train.loop import model_for_config

    t = time.perf_counter()
    scene = root / "superdove" / "scene"
    dates = write_scene(scene, n_dates=SUPERDOVE_DATES, bands=8)
    crops = create_scene(BeachSegConfig(data=scene), train=True).crops
    log(f"SuperDove: wrote {SCENE_W}x{SCENE_H} 8-band uint16 at {SCENE_PIX} m, {len(dates)} dates x 2 tiles, "
        f"{len(crops)} crops of 112, in {time.perf_counter() - t:.3f} s")

    conf = BeachSegConfig(batch_size=B, backbone="huge")
    check(conf.compute_dtype == "float32", f"config #5's default compute dtype {conf.compute_dtype}")
    fwd, bwd = {"attn_packed": 32}, {"attn_bwd": 32}
    model, cfg = model_for_config(conf, device=device, seed=0)
    check(cfg.head_dim == HD_H and cfg.hidden_size == C_H and cfg.num_hidden_layers == 32, f"ViT-H config {cfg}")
    with launch_events() as events:
        tr = phase_train_path(device, model, conf, dict(fwd, **bwd), grad_limits=(GRAD32_1MCOS_MAX, GRAD32_REL_TOL))
    in_model = {"attn_packed_fp32": event_ms(events["attn_packed"]), "attn_bwd_fp32": event_ms(events["attn_bwd"])}
    del model, events
    torch.cuda.empty_cache()
    remat = remat_check(device, conf, card, fwd, bwd, (GRAD32_1MCOS_MAX, GRAD32_REL_TOL))
    log(f"SuperDove fp32 ViT-H train_step B={B}: seconds per step {tr['seconds']}, peak memory {tr['peak_bytes']} bytes "
        f"over the 3 steps, {remat['peak_bytes']} without remat and {remat['peak_bytes_remat']} with (one step); "
        f"in-model ms a call: attn_packed fp32 {in_model['attn_packed_fp32']:.4f}, attn_bwd fp32 "
        f"{in_model['attn_bwd_fp32']:.4f}; prompt gradient 1 - cosine {1 - tr['grad_cos']:.4e} ({card})")

    odd = len(crops) % B
    batches = vit_h_batch_check(device, (B, odd) if odd else (B,))

    train_conf = BeachSegConfig(data=scene, model_training_root=root / "superdove_train", checkpoint="random",
                                backbone="huge", crop_size=112, inpt_size=448, batch_size=B, epochs=TRAIN_EPOCHS,
                                log_every_n_steps=1, num_viz_images=2)
    check(train_conf.compute_dtype == "float32", "config #5 trains in fp32")
    run_dir, launches, steps, evals, run_s = counted_training(train_conf)
    run = check_training_run(run_dir, launches, steps, evals, dict(fwd, **bwd), fwd, TRAIN_EPOCHS)
    log(f"SuperDove run_training: {TRAIN_EPOCHS} epochs of {run['per_epoch']} steps in {run_s:.3f} s; StepTimer "
        f"steps/sec {run['rates']}; train/loss {run['losses']}; mean |tuned - initial| {run['d_tuned']:.4e}, "
        f"|EMA - initial| {run['d_ema']:.4e}; launches {launches} ({card})")

    huge_bf16 = with_stages({"attn_packed": 32, "ln_mlp": 32})
    out, by_overlap = root / "superdove_predict", {0: crops}
    fp32 = scene_run(scene, out, "float32", "vote", 0, fwd, by_overlap, dates, train_run_dir=run_dir)
    with launch_events(("attn_packed",)) as events:
        bf16 = scene_run(scene, out, "bfloat16", "vote", 0, huge_bf16, by_overlap, dates, train_run_dir=run_dir)
    in_model["attn_packed_bf16"] = event_ms(events["attn_packed"])
    plain = scene_run(scene, out, "bfloat16", "vote", 0, {}, by_overlap, dates, plain=True, train_run_dir=run_dir)
    agree = vote_agreement(bf16["ids"], plain["ids"], crops)
    log(f"SuperDove run_predict: bf16 vote mosaics kernels vs plain: {agree:.6f} of voted pixels equal "
        f"(min {ID_AGREEMENT_MIN}); in-model ms a call of attn_packed bf16 {in_model['attn_packed_bf16']:.4f}")
    check(agree >= ID_AGREEMENT_MIN, f"SuperDove bf16 vote mosaics agree on {agree} of voted pixels")
    runs = {"fp32_vote": fp32, "bf16_vote": bf16, "bf16_vote_plain": plain}
    for name, r in runs.items():
        log(f"SuperDove run_predict {name}: stream_tiles_per_sec {r['timings']['stream_tiles_per_sec']}, run "
            f"{r['seconds']:.3f} s, timings {json.dumps(r['timings'])} ({card})")
    log(f"SuperDove ViT-H (config #5): fp32 train_step seconds per step {tr['seconds']}, peak memory "
        f"{remat['peak_bytes']} bytes without remat and {remat['peak_bytes_remat']} with; in-model ms a call {in_model}; "
        f"run_training {TRAIN_EPOCHS} epochs in {run_s:.3f} s; run_predict "
        + ", ".join(f"{k} {r['seconds']:.3f} s ({r['timings']['stream_tiles_per_sec']} tiles/s)" for k, r in runs.items())
        + f"; bf16 ids {agree:.6f} equal to the plain run's ({card})")
    return {"train": tr, "remat": remat, "in_model_ms": in_model, "batches": batches,
            "run": run, "run_s": run_s, "run_launches": launches, "runs": runs, "agreement_bf16": agree,
            "train_launches_per_step": steps[0], "eval_launches_per_batch": evals[0]}


# phase 20: the CLIs at full width, and two ranks sharing the one card
TP = 2  # the model axis of the two-rank steps
TP_HEADS, TP_C, TP_MLP = HEADS // TP, C // TP, MLP // TP
STEP_WANT = {"attn_qkv_rel": 24, "ln_mlp": 24, "attn_bwd": 24, "ln_mlp_dx": 24}


def tp_kernel_check(device) -> dict:
    """#1, #2, #4 and #5 at the widths a rank of mesh_model=2 gives them at
    ViT-L, B=8 (#1: 8 heads, qkv (B, S, 3, 512); #2 and #5: M = 2048, whole
    and by stage; #4: B·8 rows), each against its plain version with phases
    5–6's limits (and #1 fp32 with phase 12's), then timed beside its plain
    version and the PyTorch call for the same work."""
    from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp

    gw, s = GRID[1], GRID[0] * GRID[1]
    res = {}
    args32 = (*attn_inputs(torch.float32, device, c=TP_C), HD**-0.5, gw, TP_HEADS, "stable")
    res["attn32_err"] = fwd_check(f"attn_qkv_rel fp32 stable, {TP_HEADS} heads", cuda_attn.attn_qkv_rel,
                                  cuda_attn.attn_qkv_rel_plain, args32, (B, s, TP_C))
    del args32
    args = (*attn_inputs(torch.bfloat16, device, c=TP_C), HD**-0.5, gw, TP_HEADS, "clamp")
    res["attn_err"] = fwd_check(f"attn_qkv_rel bf16 clamp, {TP_HEADS} heads", cuda_attn.attn_qkv_rel,
                                cuda_attn.attn_qkv_rel_plain, args, (B, s, TP_C))
    res["attn_ms"] = time_ms(lambda: cuda_attn.attn_qkv_rel(*args), iters=20, warmup=2)
    res["attn_plain_ms"] = time_ms(lambda: cuda_attn.attn_qkv_rel_plain(*args), iters=3)
    res["attn_library_ms"] = time_ms(sdpa_yardstick(*args[:4]), iters=20, warmup=2)
    res["attn_bound"] = attn_bound(B, 2, PEAK_BF16, TP_HEADS)
    del args
    torch.cuda.empty_cache()
    n = B * s
    *head, b2, gy = mlp_inputs(device, 1, n, C, TP_MLP)
    res.update(mlp_check("mlp", cuda_mlp.ln_mlp, cuda_mlp.ln_mlp_plain, (*head, b2, 1e-6, True), MLP_BF16_REL_TOL,
                         f" at M={TP_MLP}"))
    res["mlp_bound"] = mlp_bound(n, C, TP_MLP)
    res.update(mlp_check("mlp_dx", cuda_mlp.ln_mlp_dx, cuda_mlp.ln_mlp_dx_plain, (*head, gy, 1e-6, True),
                         MLP_DX_REL_TOL, f" at M={TP_MLP}"))
    res["mlp_dx_bound"] = mlp_dx_bound(n, C, TP_MLP)
    del head, b2, gy
    torch.cuda.empty_cache()
    res["stages"] = mlp_stage_check(device, n, C, TP_MLP, seed=13, timed=True)
    res.update(attn_bwd_check(device, HD, f" at {TP_HEADS} heads", heads=TP_HEADS))
    return res


@contextlib.contextmanager
def recording_collectives():
    """Record every all-reduce and all-gather of ``ops.sharding`` made in
    the block (the list it yields)."""
    from beach_seg_tpu_torch.ops import sharding

    calls = []
    reduce_, gather = sharding._all_reduce, sharding._all_gather
    sharding._all_reduce = lambda x, mesh, name: calls.append((reduce_, x, mesh, name)) or reduce_(x, mesh, name)
    sharding._all_gather = lambda x, mesh, name, dim: calls.append((gather, x, mesh, name, dim)) or gather(x, mesh, name, dim)
    try:
        yield calls
    finally:
        sharding._all_reduce, sharding._all_gather = reduce_, gather


def collective_ms(calls: list) -> tuple[float, int]:
    """The recorded collectives alone, on tensors of the same shapes, timed
    (host clock around a synchronized replay, mean of 3 after one) → (ms,
    count): what the collectives add to the step that made them."""
    replay = [(c[0], torch.zeros_like(c[1]), *c[2:]) for c in calls]
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for fn, x, *rest in replay:
            fn(x, *rest)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return 1e3 * sum(times[1:]) / 3, len(calls)


def two_rank_steps(device, draws: dict) -> dict:
    """On this rank of 2 sharing the card, for the meshes (data=1, model=2)
    and (data=2, model=1): ViT-L bf16 (seeded random weights) cut to this
    rank's shards; under model=2 a predict_step (ids and pred_masks of
    phase 5's first batch, launches, warm seconds); a train_step on phase
    6's first batch (this rank's rows under data=2) from a fresh state with
    the parent's global ``draws`` (loss, Adam's first moment, launches,
    warm seconds); the collectives' time in each warm call."""
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.models.seggpt import SegGPTConfig, build_model
    from beach_seg_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_model
    from beach_seg_tpu_torch.train import PromptTuner

    conf = BeachSegConfig(batch_size=B)
    prompts, batches = main_path_inputs(conf, 4, 1)
    tprompts, tbatches = train_path_inputs(conf, 4, 1)
    out = {}
    for shape in ((1, TP), (TP, 1)):
        mesh = make_mesh(*shape)
        model = shard_model(build_model(SegGPTConfig(), torch.bfloat16, device=device, seed=0), mesh)
        tuner = PromptTuner(model, conf, device=device)
        r = {}
        if shape == (1, TP):
            for warm in (False, True):  # the second call is timed and its collectives recorded
                reset_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                with recording_collectives() if warm else contextlib.nullcontext() as calls:
                    ids = tuner.predict_step(*prompts, batches[0], out_size=conf.crop_size)
                    torch.cuda.synchronize()
                r["predict_s"] = time.perf_counter() - t
                r["predict_launches"] = {k: v for k, v in read_counts().items() if v}
            r["ids"] = ids.cpu()
            r["pred"] = tuner.predict_masks(*prompts, batches[0])[0].cpu()
            r["predict_collective_ms"], r["predict_collectives"] = collective_ms(calls)
        rows = shard_batch(mesh, tbatches[0])
        for warm in (False, True):
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with recording_collectives() if warm else contextlib.nullcontext() as calls:
                state, metrics = tuner.train_step(tuner.init_state(tprompts[0]), tprompts[1], tprompts[2], rows, draws=draws)
                loss = metrics["loss"].item()
                torch.cuda.synchronize()
            r["train_s"] = time.perf_counter() - t
            r["train_launches"] = {k: v for k, v in read_counts().items() if v}
        r["loss"], r["mu"] = loss, state.opt_state["mu"].cpu()
        r["train_collective_ms"], r["train_collectives"] = collective_ms(calls)
        out[shape] = r
        del model, tuner, state
        torch.cuda.empty_cache()
    return out


def rank_main(rank: int, world: int, port: int, out_dir: str, draws_path: str) -> None:
    """A rank of the two-rank phase: torch.distributed through the port's
    own start (parallel.distributed.maybe_initialize, the launcher's
    variables set here, gloo: NCCL takes one card a rank), the steps, and on
    rank 0 the kernels at the tensor-parallel widths; results to
    ``out_dir/rank<r>.pt``."""
    import os

    import torch.distributed as dist

    from beach_seg_tpu_torch.parallel.distributed import maybe_initialize
    from beach_seg_tpu_torch.utils import resolve_device

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    maybe_initialize(world, "", backend="gloo")
    device = resolve_device("cuda")
    try:
        res = two_rank_steps(device, torch.load(draws_path, weights_only=False))
        if rank == 0:
            res["kernels"] = tp_kernel_check(device)
    finally:
        dist.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def grad_agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(1 − cosine in fp64, max error, max|want|) of two prompt gradients."""
    a, b = got.double().flatten(), want.double().flatten()
    return 1 - (torch.dot(a, b) / (a.norm() * b.norm())).item(), (got - want).abs().max().item(), want.abs().max().item()


def phase_two_ranks(device, card: str) -> dict:
    """Two ranks on the one card (gloo), ViT-L bf16 at B=8: under
    (data=1, model=2) a predict_step and a train_step, under (data=2,
    model=1) a train_step, each held against the same step in one process
    on the same weights and draws: ids equal (or, where the forward's bf16
    sums over ranks round otherwise, ID_AGREEMENT_MIN of them with the
    pred_masks within phase 5's limit), the prompt gradient within phase
    6's limits, both ranks' gradients equal; 24 launches of #1, #2, #4 and
    #5 (and their stage kernels) a train step on each rank, 24 of #1 and #2
    a predict step; on rank 0 the kernels at the tensor-parallel widths
    (``tp_kernel_check``). First, whether the forward is deterministic from
    run to run (two predict_steps on the same batch): the CLI phase's bar."""
    import torch.multiprocessing as mp

    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.models.seggpt import SegGPTConfig, build_model
    from beach_seg_tpu_torch.train import PromptTuner
    from beach_seg_tpu_torch.transforms import decode_by_palette

    conf = BeachSegConfig(batch_size=B)
    model = build_model(SegGPTConfig(), torch.bfloat16, device=device, seed=0)
    tuner = PromptTuner(model, conf, device=device)
    prompts, batches = main_path_inputs(conf, 4, 1)
    ids = tuner.predict_step(*prompts, batches[0], out_size=conf.crop_size)
    ids_again = tuner.predict_step(*prompts, batches[0], out_size=conf.crop_size)
    pred, pal = tuner.predict_masks(*prompts, batches[0])
    pred_again, _ = tuner.predict_masks(*prompts, batches[0])
    deterministic = torch.equal(ids, ids_again) and torch.equal(pred, pred_again)
    tprompts, tbatches = train_path_inputs(conf, 4, 1)
    draws = tuner.step_draws(tbatches[0], 4, torch.Generator(device=device).manual_seed(7))
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = tuner.train_step(tuner.init_state(tprompts[0]), tprompts[1], tprompts[2], tbatches[0], draws=draws)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t
    mu = state.opt_state["mu"]
    del model, tuner, state
    torch.cuda.empty_cache()
    log(f"two ranks: the one-process predict is deterministic from run to run: {deterministic}; "
        f"one-process train_step {one_s:.4f} s warm, loss {loss}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        torch.save(to_cpu(draws), Path(tmp) / "draws.pt")
        t = time.perf_counter()
        mp.spawn(rank_main, args=(2, free_port(), tmp, str(Path(tmp) / "draws.pt")), nprocs=2, join=True)
        spawn_s = time.perf_counter() - t
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(2)]

    train_want = {k: v for k, v in with_stages(STEP_WANT).items()}
    pred_want = with_stages({"attn_qkv_rel": 24, "ln_mlp": 24})
    res = {"deterministic": deterministic, "one_train_s": one_s, "spawn_s": spawn_s, "kernels": ranks[0]["kernels"]}
    for shape in ((1, TP), (TP, 1)):
        tag = f"data={shape[0]} model={shape[1]}"
        r0, r1 = ranks[0][shape], ranks[1][shape]
        for rank, r in enumerate((r0, r1)):
            check(r["train_launches"] == train_want, f"{tag} rank {rank}: launches per train step {r['train_launches']}")
        check(torch.equal(r0["mu"], r1["mu"]), f"{tag}: the ranks' prompt gradients differ")
        gap, err, scale = grad_agreement(r0["mu"], mu.cpu())
        log(f"two ranks {tag}: train_step {r0['train_s']:.4f} s warm (one process {one_s:.4f} s), loss {r0['loss']} "
            f"(one process {loss}); prompt gradient vs one process: 1 - cosine {gap:.4e} (max {GRAD_1MCOS_MAX}), "
            f"max_abs_err {err:.4e} (tol {GRAD_REL_TOL}·max|g| {GRAD_REL_TOL * scale:.4e}); launches per step "
            f"{r0['train_launches']}; collectives {r0['train_collectives']} a step, replayed {r0['train_collective_ms']:.3f} ms "
            f"(gloo through one card's host, not NCCL) ({card})")
        check(scale > 0 and gap <= GRAD_1MCOS_MAX and err <= GRAD_REL_TOL * scale, f"{tag}: prompt gradient disagrees")
        res[tag] = {k: v for k, v in r0.items() if k not in ("ids", "pred", "mu")}
        res[tag].update(grad_1mcos=gap, grad_err=err)
    r0 = ranks[0][(1, TP)]
    for rank in (0, 1):
        check(ranks[rank][(1, TP)]["predict_launches"] == pred_want,
              f"model=2 rank {rank}: predict launches {ranks[rank][(1, TP)]['predict_launches']}")
        check(torch.equal(ranks[rank][(1, TP)]["ids"], r0["ids"]), "model=2: the ranks' ids differ")
    tp_ids = r0["ids"].to(device)
    agree = (tp_ids == ids).float().mean().item()
    err = (r0["pred"].to(device) - pred).abs().max().item()
    scale = pred.abs().max().item()
    h = pred.shape[1] // 2
    dec_agree = (decode_by_palette(r0["pred"].to(device)[:, h:], pal) == decode_by_palette(pred[:, h:], pal)).float().mean().item()
    log(f"two ranks data=1 model=2: predict_step {r0['predict_s']:.4f} s warm; ids equal to one process's on {agree:.6f} "
        f"(decoded at the canvas {dec_agree:.6f}); pred_masks max_abs_err {err:.4e} (tol {PRED_REL_TOL}·max|plain| "
        f"{PRED_REL_TOL * scale:.4e}); collectives {r0['predict_collectives']} a call, replayed "
        f"{r0['predict_collective_ms']:.3f} ms ({card})")
    check(agree == 1.0 or (agree >= ID_AGREEMENT_MIN and err <= PRED_REL_TOL * scale), f"model=2 ids agree on {agree}")
    res["ids_agreement"], res["pred_err"] = agree, err
    return res


def cli_run(name: str, *args: str) -> tuple[str, float]:
    """``python -m beach_seg_tpu_torch.cli.<name> args`` from the repository
    root → (its standard output, seconds)."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"beach_seg_tpu_torch.cli.{name}", *args], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t
    check(res.returncode == 0, f"cli.{name} exited {res.returncode}: {res.stderr[-3000:]}")
    return res.stdout, seconds


def phase_clis(root: Path, dates: list[str], deterministic: bool, card: str) -> dict:
    """The CLIs at full width on phase 17's scene, ViT-L bf16 (seeded random
    weights), crops of 112 at 448, batch 8: cli.train for 1 epoch, cli.predict
    from its run dir on one date, then cli.compare of that GeoTIFF directory
    against an in-process run_predict of the same export and date: a
    pixel_agreement of 1.0 where the forward is deterministic from run to
    run, else ID_AGREEMENT_MIN. Each command's seconds."""
    from beach_seg_tpu_torch.config import PredictionConfig
    from beach_seg_tpu_torch.infer import run_predict

    common = ["checkpoint=random", "compute_dtype=bfloat16", f"batch_size={B}"]
    out, train_s = cli_run("train", f"data={root / 'all' / 'scene'}", f"model_training_root={root / 'cli_train'}",
                           "crop_size=112", "inpt_size=448", "epochs=1", "num_viz_images=0", *common)
    run_dir = Path(out.strip().splitlines()[-1])
    missing = [f for f in RUN_DIR_FILES if not (run_dir / f).is_file()]
    check(not missing, f"cli.train's run dir lacks {missing}")
    view = scene_view(root / "all" / "scene", root / "cli_pred" / "scene", dates[:2])
    out, predict_s = cli_run("predict", f"data={view}", f"train_run_dir={run_dir}",
                             f"model_training_root={root / 'cli_pred' / 'out'}", *common)
    pred_dir = Path(out.strip().splitlines()[-1])
    t = time.perf_counter()
    ref_dir = run_predict(PredictionConfig(data=view, train_run_dir=run_dir, model_training_root=root / "cli_pred" / "ref",
                                           checkpoint="random", batch_size=B, compute_dtype="bfloat16"))
    inproc_s = time.perf_counter() - t
    out, compare_s = cli_run("compare", str(pred_dir / "tif"), str(ref_dir / "tif"))
    report = json.loads(out)
    agree = report["pixel_agreement"]
    want = 1.0 if deterministic else ID_AGREEMENT_MIN
    log(f"CLIs: cli.train {train_s:.3f} s, cli.predict {predict_s:.3f} s (in process {inproc_s:.3f} s), cli.compare "
        f"{compare_s:.3f} s; pixel_agreement {agree} (min {want}), overall_mean_iou {report['overall_mean_iou']} ({card})")
    check(list(report["dates"]) == [dates[1]] and agree >= want, f"cli.compare: {report}")
    return {"train_s": train_s, "predict_s": predict_s, "inproc_predict_s": inproc_s, "compare_s": compare_s,
            "pixel_agreement": agree}


def superdove_entries(kernels: list, sd: dict) -> None:
    """Phase 21's numbers beside the ViT-H entries of the ``kernels`` line:
    the launches of the fp32 train steps, of run_training and of a
    run_predict batch, #3's and #4's in-model ms a call, the errors at the
    engine's batch rows."""
    runs = sd["runs"]
    for e in kernels:
        if e["geometry"] != "vit_h":
            continue
        if e["name"] == "attn_packed":
            e["launches_superdove_train_steps"] = sd["train"]["launches"]["attn_packed"]
            e["launches_superdove_run_training"] = sd["run_launches"]["attn_packed"]
            e["launches_superdove_run_predict_per_batch"] = {
                name: runs[name]["launches"]["attn_packed"] // runs[name]["batches"] for name in ("fp32_vote", "bf16_vote")}
            e["in_model_ms"] = sd["in_model_ms"]["attn_packed_bf16"]
            e["fp32_in_model_ms"] = sd["in_model_ms"]["attn_packed_fp32"]
            e["max_abs_err_superdove_batches"] = {
                k.split(" ", 1)[1]: v for k, v in sd["batches"].items() if k.startswith("attn_packed")}
        elif e["name"] == "attn_bwd" and e.get("dtype") == "fp32":
            e["launches_superdove_run_training"] = sd["run_launches"]["attn_bwd"]
            e["in_model_ms"] = sd["in_model_ms"]["attn_bwd_fp32"]
        elif e["name"] == "ln_mlp":
            e["launches_superdove_run_predict_per_batch_bf16"] = runs["bf16_vote"]["launches"]["ln_mlp"] // runs["bf16_vote"]["batches"]
            e["max_abs_err_superdove_stages"] = {k: v for k, v in sd["batches"].items() if not k.startswith("attn_packed")}


# phase 22: golden parity at full width, the port's zero-shot and tuned-predict
# engines against the reference's chains re-run over transformers' SegGpt on
# the same local HF ViT-L directory: phase 17's scene cut to 1 reference and
# GOLDEN_DATES predict dates
GOLDEN_DATES = 2  # scripts/golden_parity_torch.PREDICT_DATES, the scripts' default scene
PLAIN_VERSIONS = {"cuda_attn": ("attn_qkv_rel_plain", "attention_packed_plain", "attention_bwd_plain",
                                "attention_fused_plain", "attention_qkv_plain", "attn_qkv_rope_plain"),
                  "cuda_mlp": ("ln_mlp_plain", "ln_mlp_dx_plain", *(f"{st}_plain" for st in MLP_STAGES),
                               "swiglu_mlp_plain"),
                  "cuda_gemm": ("linear_f32_plain",)}


@contextlib.contextmanager
def plain_watch():
    """The plain versions the kernel wrappers would fall back to, each
    wrapped to count its calls → {name: calls}."""
    from beach_seg_tpu_torch.ops import cuda_attn, cuda_gemm, cuda_mlp

    mods = {"cuda_attn": cuda_attn, "cuda_mlp": cuda_mlp, "cuda_gemm": cuda_gemm}
    calls = {name: 0 for names in PLAIN_VERSIONS.values() for name in names}
    saved = {(m, n): getattr(mods[m], n) for m, names in PLAIN_VERSIONS.items() for n in names}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    for (m, n), fn in saved.items():
        setattr(mods[m], n, counted(n, fn))
    try:
        yield calls
    finally:
        for (m, n), fn in saved.items():
            setattr(mods[m], n, fn)


def golden_scripts():
    """scripts/golden_parity_torch.py and scripts/golden_parity_tuned_torch.py
    as modules."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import golden_parity_torch
    import golden_parity_tuned_torch

    return golden_parity_torch, golden_parity_tuned_torch


def phase_golden_parity(device, root: Path, dates: list[str], card: str) -> dict:
    """Golden parity at full width and depth on the card: HF's own random
    ViT-L (``SegGptConfig()``, torch.manual_seed(0); the decoder head scaled
    by the scripts' HEAD_SCALE where the weights' reference masks would
    leave the gate blind) saved once with save_pretrained, the
    port's ``load_model_params`` of that directory (``config_from_hf`` equal
    to ``SegGPTConfig()``); ``run_training`` in fp32 from it (1 epoch: 24
    launches of #1 and #4 a train step, of #1 an eval batch); the oracles
    of the two scripts on the card (fp32, eager, TF32 off): the zero-shot
    chain and the tuned chain on the run's prompt_batch_tuned.npz; then
    the port's run_zero_shot (crops of 336, 2 prompts, rank_compat) and
    run_predict from the run (tuned export, vote) in fp32 (24 #1 a batch)
    and bf16 (24 #1 and #2, and #2's stages, a batch), each against the
    fp32 oracle on every predict date: fp32 worst per-class IoU >=
    IOU_MIN, bf16 reported. No plain version runs in the phase."""
    from transformers.models.seggpt import SegGptConfig

    from beach_seg_tpu_torch.data.dataset import create_scene
    from beach_seg_tpu_torch.models.seggpt import SegGPTConfig
    from beach_seg_tpu_torch.models.seggpt.convert import config_from_hf
    from beach_seg_tpu_torch.models.seggpt.load import load_model_params
    from beach_seg_tpu_torch.train.checkpoint import load_prompt_batch

    gp, gpt = golden_scripts()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    gp.select_device("cuda")
    versions = gp.versions()
    log(f"golden parity: transformers {versions['transformers']} ({versions['processor']}), safetensors "
        f"{versions['safetensors']}, allow_tf32 {versions['allow_tf32']} ({card})")
    work = root / "golden"
    scene = scene_view(root / "all" / "scene", work / "scene", dates[: 1 + GOLDEN_DATES])
    ckpt = work / "hf_seggpt_vit_large"
    zconf = gp.zero_shot_conf(scene, work / "zero_shot", str(ckpt), "float32", tiny=False)
    tconf = dataclasses.replace(gpt.train_conf(scene, work / "train", str(ckpt), tiny=False), log_every_n_steps=1)
    zscene = gp.zero_shot_scene(zconf)
    classes = zconf.classes
    seconds, launches = {}, {}
    with plain_watch() as plain_calls:
        t = time.perf_counter()
        head_scale = gp.random_checkpoint(ckpt, False, gp.zero_shot_probe(zconf, device))
        seconds["hf_build_probe_save"] = time.perf_counter() - t
        size = sum(f.stat().st_size for f in ckpt.iterdir())
        cfg = config_from_hf(SegGptConfig.from_pretrained(str(ckpt)))
        check(cfg == SegGPTConfig(), f"config_from_hf of the HF directory {cfg} is not SegGPTConfig()")
        t = time.perf_counter()
        state = load_model_params(ckpt, cfg, device)
        torch.cuda.synchronize()
        seconds["port_load"] = time.perf_counter() - t
        n_params = sum(v.numel() for v in state.values())
        check(all(torch.isfinite(v).all() for v in state.values()), "the port's load of the HF directory is not finite")
        del state
        log(f"golden parity: HF ViT-L saved ({size} bytes, decoder head x{head_scale:g}) and loaded by the port "
            f"({n_params} parameters) in {seconds['hf_build_probe_save']:.3f} / {seconds['port_load']:.3f} s")

        run_dir, run_launches, steps, evals, seconds["run_training_fp32"] = counted_training(tconf)
        check_training_run(run_dir, run_launches, steps, evals, {"attn_qkv_rel": 24, "attn_bwd": 24}, {"attn_qkv_rel": 24},
                           gpt.EPOCHS)
        launches["run_training_fp32"] = {"train_step": steps[0], "eval_batch": evals[0], "run": run_launches}

        t = time.perf_counter()
        tmodel = gp.load_oracle(ckpt, device)
        zs_ref, zs_valid = gp.reference_zero_shot(tmodel, gp.hf_api()[2](), zconf, zscene, device)
        torch.cuda.synchronize()
        seconds["oracle_zero_shot"] = time.perf_counter() - t
        t = time.perf_counter()
        pb = load_prompt_batch(run_dir / "prompt_batch_tuned.npz")
        tscene = create_scene(tconf, train=True)
        mosaics, palette = gpt.predict_mosaics(scene, tscene), gpt.ref_build_palette(len(classes) - 1)
        tuned_ref, tuned_valid, tuned_margins = gpt.reference_tuned_predict(
            tmodel, tconf, tscene, mosaics, pb["image"], pb["mask"], palette, device)
        seconds["oracle_tuned"] = time.perf_counter() - t
        # the port's model against the oracle's on the tuned inputs: the
        # largest output difference bounds the decode margins it can flip
        t = time.perf_counter()
        port = {"device": device, "port_checkpoint": str(ckpt), "config": cfg}
        model_err = {dtype: gpt.port_model_error(tmodel, port, tconf, tscene, mosaics, pb, palette, dtype)
                     for dtype in gp.DTYPES}
        seconds["model_error"] = time.perf_counter() - t
        del tmodel
        torch.cuda.empty_cache()
        shares = {"zero_shot": gp.class_shares(zs_ref, zs_valid, len(classes)),
                  "tuned": gp.class_shares(tuned_ref, tuned_valid, len(classes))}

        expect = {"float32": {"attn_qkv_rel": 24}, "bfloat16": with_stages({"attn_qkv_rel": 24, "ln_mlp": 24})}
        rows, ties = {}, {}
        for dtype in gp.DTYPES:
            z = engine_run("zero_shot", scene, work / "zero_shot", dtype, expect[dtype], zscene.crops,
                           dates[: 1 + GOLDEN_DATES], checkpoint=str(ckpt), rank_compat=True,
                           n_prompts=zconf.n_prompts, zero_shot_crop_size=zconf.zero_shot_crop_size)
            p = scene_run(scene, work / "predict", dtype, "vote", 0, expect[dtype], {0: tscene.crops},
                          dates[: 1 + GOLDEN_DATES], train_run_dir=run_dir, checkpoint=str(ckpt), use_ema=False)
            seconds[f"zero_shot_{dtype}"], seconds[f"run_predict_{dtype}"] = z["seconds"], p["seconds"]
            launches[f"zero_shot_{dtype}"] = {k: v // z["batches"] for k, v in z["launches"].items() if v}
            launches[f"run_predict_{dtype}"] = {k: v // p["batches"] for k, v in p["launches"].items() if v}
            rows[f"zero_shot_{dtype}"] = gp.compare(zs_ref, {d: z["ids"][(d, "ids")] for d in zs_ref}, len(classes))
            rows[f"tuned_{dtype}"] = gp.compare(tuned_ref, p["ids"], len(classes))
            ties[dtype] = {**gpt.near_ties(tuned_ref, p["ids"], tuned_valid, tuned_margins,
                                           2 * model_err[dtype]["max_abs_err"]), "model_error": model_err[dtype]}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    worst = {name: gp.worst_iou(r) for name, r in rows.items()}
    for name, r in rows.items():
        for row in r:
            log(f"golden parity {name} {row['date']}: pixel agreement {row['pixel_agreement']:.6f}, IoU "
                + ", ".join(f"{c} {i:.6f}" for c, i in zip(classes, row["iou"])))
    log(f"golden parity tuned chain, the pixels that differ from the oracle and their decode margins: {json.dumps(ties)}")
    log(f"golden parity launches a train step / eval batch / engine batch: {json.dumps(launches)}")
    log("golden parity: " + json.dumps({"seconds": seconds, "class_shares": shares, "worst_iou": worst,
                                        "head_scale": head_scale, "plain_calls": sum(plain_calls.values())})
        + f" ({card})")
    check(not any(plain_calls.values()), f"plain versions ran in the golden-parity phase: {plain_calls}")
    for chain, sh in shares.items():
        check(gp.blind(sh) is None, f"{chain} reference masks leave the gate blind: {gp.blind(sh)}")
    for name in ("zero_shot_float32", "tuned_float32"):
        check(worst[name] >= gp.IOU_MIN, f"golden parity {name}: worst per-class IoU {worst[name]} < {gp.IOU_MIN}")
    return {"seconds": seconds, "launches": launches, "rows": rows, "worst_iou": worst, "class_shares": shares,
            "head_scale": head_scale, "versions": versions, "near_ties": ties}


def eva02_entries(kernels: list, ek: dict, ep: dict) -> None:
    """EVA-02-L's two kernels at each row count, with their launches a
    predict call and a train step."""
    s = EVA_GRID[0] * EVA_GRID[1]
    for rows in EVA_ROWS:
        kernels.append({
            "name": "attn_qkv_rope", "geometry": "eva02", "route": "cuda",
            "source": "beach_seg_tpu_torch/ops/csrc/attn_qkv_rope.cu", "replaces": "none (EVA-02's attention)",
            "launches": ep["predict"]["launches"]["attn_qkv_rope"], "launches_train": ep["train"]["launches"]["attn_qkv_rope"],
            "max_abs_err": ek[f"attn_err_{rows}"], "ms": ek[f"attn_ms_{rows}"], "plain_ms": ek[f"attn_plain_ms_{rows}"],
            "bound_ms": ek[f"attn_bound_{rows}"][0], "bound_by": ek[f"attn_bound_{rows}"][1], "design_name": "ws",
            "shape": f"bf16 clamp, qkv ({rows}, {s}, 3, {C}), {HEADS} heads, RoPE, grid {EVA_GRID[0]}x{EVA_GRID[1]}",
        })
    for n in EVA_MLP_ROWS:
        kernels.append({
            "name": "swiglu_mlp", "geometry": "eva02", "route": "cuda",
            "source": "beach_seg_tpu_torch/ops/csrc/swiglu_mlp.cu", "replaces": "none (EVA-02's SwiGLU MLP)",
            "launches": ep["predict"]["launches"]["swiglu_mlp"], "launches_train": ep["train"]["launches"]["swiglu_mlp"],
            "max_abs_err": ek[f"mlp_err_{n}"]["err"], "error_norm": ek[f"mlp_err_{n}"]["norm"],
            "ms": ek[f"mlp_ms_{n}"], "plain_ms": ek[f"mlp_plain_ms_{n}"],
            "bound_ms": ek[f"mlp_bound_{n}"][0], "bound_by": ek[f"mlp_bound_{n}"][1], "design": MLP_DESIGN,
            "shape": f"bf16, x ({n}, {C}), M={EVA_MLP} (padded to a multiple of 64)",
        })


def golden_entries(kernels: list, gold: dict) -> None:
    """Phase 22's launches beside the ViT-L entries of the ``kernels`` line:
    a batch of each engine (fp32 and bf16) and an fp32 train step."""
    la = gold["launches"]
    for e in kernels:
        if e["geometry"] != "vit_l" or e["name"] not in ("attn_qkv_rel", "ln_mlp", "attn_bwd"):
            continue
        dt = "float32" if e.get("dtype") == "fp32" else "bfloat16"
        if e["name"] == "attn_bwd":
            if dt == "float32":
                e["launches_golden_parity_train_step"] = la["run_training_fp32"]["train_step"]["attn_bwd"]
            continue
        if e["name"] == "attn_qkv_rel" and dt == "float32":
            e["launches_golden_parity_train_step"] = la["run_training_fp32"]["train_step"]["attn_qkv_rel"]
        e["launches_golden_parity_per_batch"] = {run: la[f"{run}_{dt}"].get(e["name"], 0) for run in ("zero_shot", "run_predict")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    # phase 22's oracle: transformers' SegGpt and its safetensors files; a host
    # without them fails here, before the long phases
    try:
        import safetensors  # noqa: F401
        from transformers.models.seggpt import SegGptForImageSegmentation  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the golden-parity phase needs transformers and safetensors: {e}", file=sys.stderr)
        return 2
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
    t = time.perf_counter()
    kg = phase_linear_f32(device)
    log(f"fp32 linear products phase: {time.perf_counter() - t:.3f} s")

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

    # the default BeachSegConfig: fp32 ViT-L (its linear products, the MLP's included, through linear_f32)
    t = time.perf_counter()
    conf32 = BeachSegConfig(batch_size=B)
    check(conf32.compute_dtype == "float32" and conf32.backbone == "large", f"default config {conf32}")
    model, cfg32 = model_for_config(conf32, device=device, seed=0)
    check(cfg32.head_dim == HD and cfg32.num_hidden_layers == 24, f"fp32 ViT-L config {cfg32}")
    log(f"fp32 predict path: ViT-L from the default BeachSegConfig, built in {time.perf_counter() - t:.3f} s")
    m32 = phase_main_path(device, model, conf32, {"attn_qkv_rel": 24}, n_batches=2, linear=linear_products(cfg32, False))
    log(f"fp32 predict path phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    tr32 = phase_train_path(device, model, conf32, {"attn_qkv_rel": 24, "attn_bwd": 24}, n_steps=2,
                            grad_limits=(GRAD32_1MCOS_MAX, GRAD32_REL_TOL), linear=linear_products(cfg32, True))
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
    mh32 = phase_main_path(device, model, conf_h32, {"attn_packed": 32}, n_batches=2, linear=linear_products(cfg_h32, False))
    log(f"fp32 ViT-H predict path phase: {time.perf_counter() - t:.3f} s")
    del model
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_scene_") as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        dates = write_scene(root / "all" / "scene")
        log(f"scene: wrote {SCENE_W}x{SCENE_H} 4-band uint16 at {SCENE_PIX} m, {len(dates)} dates x 2 tiles in "
            f"{time.perf_counter() - t:.3f} s")
        # the tuned-predict scene engine end to end (infer.predict.run_predict)
        t = time.perf_counter()
        tuned = dates[: 1 + TUNED_DATES]
        scene_view(root / "all" / "scene", root / "tuned" / "scene", tuned)
        sc = phase_scene_engine(root / "tuned", tuned, with_stages(large), card)
        log(f"scene engine phase: {time.perf_counter() - t:.3f} s")
        # the zero-shot and legacy scene engines end to end
        t = time.perf_counter()
        engine_dates = dates[: 1 + ENGINE_DATES]
        scene_view(root / "all" / "scene", root / "other" / "scene", engine_dates)
        oe = phase_other_engines(device, root / "other", engine_dates, with_stages(large), card)
        log(f"zero-shot and legacy engine phase: {time.perf_counter() - t:.3f} s")
        # the training runtime end to end, then predict from its EMA export
        t = time.perf_counter()
        trn = phase_training(device, root, dates, card)
        log(f"training runtime phase: {time.perf_counter() - t:.3f} s ({card})")
        # two ranks on the card (tensor and data parallel), then the CLIs
        t = time.perf_counter()
        two = phase_two_ranks(device, card)
        log(f"two-rank phase: {time.perf_counter() - t:.3f} s, the ranks' spawn {two['spawn_s']:.3f} s ({card})")
        t = time.perf_counter()
        clis = phase_clis(root, dates, two["deterministic"], card)
        log(f"CLI phase: {time.perf_counter() - t:.3f} s ({card})")
        # BASELINE.json config #5: ViT-H fp32 on an 8-band SuperDove scene
        t = time.perf_counter()
        sd = phase_superdove(device, root, card)
        sd["seconds"] = time.perf_counter() - t
        log(f"SuperDove ViT-H phase: {sd['seconds']:.3f} s ({card})")
        # golden parity: the zero-shot and tuned chains against transformers' SegGpt
        t = time.perf_counter()
        gold = phase_golden_parity(device, root, dates, card)
        gold["phase_s"] = time.perf_counter() - t
        log(f"golden parity phase: {gold['phase_s']:.3f} s ({card})")

    t = time.perf_counter()
    kp = phase_painter_windows(device)
    log(f"Painter window kernel phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    pt = phase_painter_path(device)
    log(f"Painter predict and train path phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    ek = phase_eva02_kernels(device)
    log(f"EVA-02 kernel phase: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ep = phase_eva02_path(device, Path(tmp))
    log(f"EVA-02 predict, train and scene phase: {time.perf_counter() - t:.3f} s")

    kernels = [
        {
            "name": "attn_qkv_rel", "geometry": "vit_l", "route": "cuda",
            "source": "beach_seg_tpu_torch/ops/csrc/attn_qkv_rel.cu",
            "replaces": "beach_seg_tpu/ops/pallas_attn.py:389",
            "launches": m["launches"]["attn_qkv_rel"], "launches_train": tr["launches"]["attn_qkv_rel"],
            "max_abs_err": k["attn_err_clamp"], "max_abs_diff": k["attn_err_clamp"],
            "max_abs_err_by_softmax": {mode: k[f"attn_err_{mode}"] for mode in SOFTMAX_MODES},
            f"max_abs_err_grid_{GRID_CROSS[0]}x{GRID_CROSS[1]}": {mode: kc[f"qkv_rel_bf16_{mode}"] for mode in SOFTMAX_MODES},
            "max_abs_err_fp32_stable": k["attn32_err"], "design": WS_QKV_REL, "design_name": "ws",
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
    for hd, launches in ((HD, tr32["launches"]["attn_bwd"]), (HD_H, sd["train"]["launches"]["attn_bwd"])):
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
            fp32 = e.get("dtype") == "fp32"
            zs = oe["runs"]["zero_shot_fp32" if fp32 else "zero_shot_bf16"]
            e["launches_zero_shot"] = zs["launches"][e["name"]]
            e["launches_zero_shot_per_batch"] = zs["launches"][e["name"]] // zs["batches"]
            if not fp32:
                lg = oe["runs"]["legacy_bf16"]
                e["launches_legacy"] = lg["launches"][e["name"]]
                e["launches_legacy_per_batch"] = lg["launches"][e["name"]] // lg["batches"]
            e["max_abs_err_engine_batches"] = {
                k.split(" ", 1)[1] if e["name"] == "attn_qkv_rel" else k: v for k, v in oe["engine_batches"].items()
                if (k.startswith("attn_qkv_rel")) == (e["name"] == "attn_qkv_rel") and (k.split()[1] == "fp32") == fp32}
    # the training runtime's launches: its 2-epoch run_training (train steps and
    # eval batches), and one remat train step
    for e in kernels:
        if e["name"] in ("attn_qkv_rel", "ln_mlp", "attn_bwd", "ln_mlp_dx") and e["geometry"] == "vit_l" and e.get("dtype") != "fp32":
            e["launches_run_training"] = trn["launches"][e["name"]]
            e["launches_run_training_per_epoch"] = trn["launches"][e["name"]] // TRAIN_EPOCHS
            e["launches_remat_train_step"] = trn["remat"]["launches_remat"][e["name"]]
    # two ranks on the card: launches a train step (and predict call) on rank 0
    # under each mesh, and the kernels at the widths of mesh_model=2
    tk = two["kernels"]
    tp_width = {
        "attn_qkv_rel": ("attn", f"bf16 clamp, qkv ({B}, {GRID[0] * GRID[1]}, 3, {TP_C}), {TP_HEADS} heads"),
        "ln_mlp": ("mlp", f"bf16, x ({B * GRID[0] * GRID[1]}, {C}), M={TP_MLP}"),
        "attn_bwd": ("attn_bwd", f"bf16, q/k/v/g ({B * TP_HEADS}, {GRID[0] * GRID[1]}, {HD})"),
        "ln_mlp_dx": ("mlp_dx", f"bf16, x ({B * GRID[0] * GRID[1]}, {C}), M={TP_MLP}"),
    }
    for e in kernels:
        if e["name"] in tp_width and e["geometry"] == "vit_l" and e.get("dtype") != "fp32":
            key, shape = tp_width[e["name"]]
            e["launches_two_ranks_per_step"] = {tag: two[tag]["train_launches"][e["name"]]
                                                for tag in ("data=1 model=2", "data=2 model=1")}
            if e["name"] in ("attn_qkv_rel", "ln_mlp"):
                e["launches_two_ranks_predict"] = two["data=1 model=2"]["predict_launches"][e["name"]]
            e["tp_width"] = {"shape": shape, "max_abs_err": tk[f"{key}_err"], "ms": tk[f"{key}_ms"],
                             "plain_ms": tk[f"{key}_plain_ms"], "bound_ms": tk[f"{key}_bound"][0],
                             "bound_by": tk[f"{key}_bound"][1],
                             "library_ms": tk.get(f"{key}_library_ms")}
            if f"{key}_chain_ms" in tk:
                e["tp_width"]["chain_ms"] = tk[f"{key}_chain_ms"]
            if e["name"] == "attn_qkv_rel":
                e["tp_width"]["max_abs_err_fp32_stable"] = tk["attn32_err"]
            if e["name"] in ("ln_mlp", "ln_mlp_dx"):
                stages = MLP_STAGES[:3] if e["name"] == "ln_mlp" else ("ln_rows",) + MLP_STAGES[3:]
                e["tp_width"]["max_abs_err_by_stage"] = {st: tk["stages"][f"{st}_err"] for st in stages}
                e["tp_width"]["stage_ms"] = {st: tk["stages"][f"{st}_ms"] for st in stages}
            if e["name"] == "attn_bwd":
                e["tp_width"]["max_abs_err_by_output"] = tk["attn_bwd_errs"]
    # Painter's windowed blocks: #1 and #4 at each row count of windows, with
    # its launches of that shape a predict call (#1) or a train step (#4)
    win = f"{PAINTER_WIN[0]}x{PAINTER_WIN[1]}"
    sw = PAINTER_WIN[0] * PAINTER_WIN[1]
    for rows in PAINTER_ROWS:
        bh = rows * HEADS
        for name, key, src, tpu, launches, shape in (
            ("attn_qkv_rel", "attn", "attn_qkv_rel.cu", "pallas_attn.py:389", pt["predict_shapes"][("attn_qkv_rel", rows, sw)],
             f"bf16 clamp, qkv ({rows}, {sw}, 3, {C}), {HEADS} heads, grid {win}"),
            ("attn_bwd", "bwd", "attn_bwd.cu", "pallas_attn.py:722", pt["train_shapes"][("attn_bwd", bh, sw)],
             f"bf16, q/k/v/g ({bh}, {sw}, {HD}), rel ({PAINTER_WIN[0]}, {PAINTER_WIN[1]})"),
        ):
            err = kp[f"{key}_err_{rows}"] if key == "attn" else max(kp[f"bwd_errs_{rows}"].values())
            kernels.append({
                "name": name, "geometry": "painter_window", "route": "cuda",
                "source": f"beach_seg_tpu_torch/ops/csrc/{src}", "replaces": f"beach_seg_tpu/ops/{tpu}",
                ("launches_per_call" if key == "attn" else "launches_per_train_step"): launches,
                "max_abs_err": err, "ms": kp[f"{key}_ms_{rows}"], "plain_ms": kp[f"{key}_plain_ms_{rows}"],
                "bound_ms": kp[f"{key}_bound_{rows}"][0], "bound_by": kp[f"{key}_bound_{rows}"][1], "shape": shape,
                **({"max_abs_err_by_output": kp[f"bwd_errs_{rows}"]} if key == "bwd" else
                   {"design_name": "ws"}),
            })
    for name in ("attn_qkv_rel", "ln_mlp", "attn_bwd", "ln_mlp_dx"):
        first[name]["launches_painter"] = {path: pt[path]["launches"][name] for path in ("predict", "train")}
    for (geom, name), r in kg.items():
        m, k, n = r["shape"]
        kernels.append({
            "name": "linear_f32", "geometry": geom, "product": name, "dtype": "fp32", "route": "cuda",
            "source": "beach_seg_tpu_torch/ops/csrc/gemm_f32x3.cu", "replaces": "none (XLA's fp32 dot)",
            "max_rel_err": r["err"], "max_rel_err_dx": r["err_dx"],
            "library_rel_err": r["library_err"], "library_rel_err_dx": r["library_err_dx"],
            "ms": r["ms"], "ms_dx": r["ms_dx"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "bound_route": FP32_ROUTE,
            "library_ms": r["library_ms"], "library_ms_dx": r["library_ms_dx"], "design": LINEAR_DESIGN,
            "shape": f"fp32, x ({m}, {k}) · W ({k}, {n})" + (" + b" if name in LINEAR_BIAS else ""),
            **({"launches_fp32_predict": (m32 if geom == "vit_l" else mh32)["linear"][-1][0]} if name == "qkv" else {}),
            **({"launches_fp32_train": tr32["linear"][-1][0]} if (geom, name) == ("vit_l", "qkv") else {}),
        })
    superdove_entries(kernels, sd)
    golden_entries(kernels, gold)
    eva02_entries(kernels, ek, ep)
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
    log(f"run_training ViT-L bf16: {TRAIN_EPOCHS} epochs in {trn['train_s']:.3f} s, StepTimer steps/sec "
        f"{trn['steps_per_sec']}, peak memory of a train step {trn['remat']['peak_bytes']} bytes without remat and "
        f"{trn['remat']['peak_bytes_remat']} with, loggers {trn['logger']} ({card})")
    log(f"two ranks ViT-L bf16 B={B}: train_step warm s data=1 model=2 {two['data=1 model=2']['train_s']:.4f}, "
        f"data=2 model=1 {two['data=2 model=1']['train_s']:.4f}, one process {two['one_train_s']:.4f}; "
        f"collectives replayed a step {two['data=1 model=2']['train_collective_ms']:.3f} / "
        f"{two['data=2 model=1']['train_collective_ms']:.3f} ms (gloo); CLIs train {clis['train_s']:.3f} s, predict "
        f"{clis['predict_s']:.3f} s, compare {clis['compare_s']:.3f} s, pixel_agreement {clis['pixel_agreement']} ({card})")
    log(f"golden parity ViT-L (transformers {gold['versions']['transformers']}): worst per-class IoU {gold['worst_iou']}, "
        f"class shares {gold['class_shares']}, seconds {gold['seconds']}, phase {gold['phase_s']:.3f} s ({card})")
    log(f"golden parity launches: {json.dumps(gold['launches'])}")
    log(f"Painter ViT-L bf16: predict_step seconds per call {pt['predict']['seconds']}; train_step seconds per step "
        f"{pt['train']['seconds']}, peak memory {pt['train']['peak_bytes']} bytes, prompt gradient cosine kernels vs plain "
        f"{pt['train']['grad_cos']:.6f}")
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
