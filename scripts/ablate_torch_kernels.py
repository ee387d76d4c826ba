"""Where the time of the torch port's CUDA kernels goes: each is rebuilt
with one part removed or cheapened and timed beside the intact one at the
main path's shapes (B=8 tiles). bf16: the LN→MLP (#2, ln_mlp.cu) and its dx
(#5, ln_mlp_dx.cu) at ViT-L and ViT-H widths, whole and by stage kernel,
with gemm_sm90.cuh's ring cut to one stage, without its producer warpgroup
(the consumers' first thread loads), without the epilogue's GELU or gelu',
without dual_dh's second product (g·W2ᵀ) or without the epilogue's stores;
the bf16 flash forward (attn_flash.cuh) as the ViT-H packed attention (#3,
head_dim 80) and the ViT-L qkv-layout attention (#6), and the bf16
attention backward (#4) at head dims 80 and 64, each without its rel terms
(the slot chunks on the tensor cores), without its ring's prefetch (every
step waits for its next stage's loads), and the forward without PV, the
backward without drh/drw or without its k-major kernel; the ViT-L qkv-rel
attention (#1, clamp: attn_ws.cuh's warp-specialized kernel) without its
rel terms, its warpgroups' turns, its exponentials or PV, with a 2-stage
ring, and its pre-passes alone.
fp32: the qkv-rel attention and the attention backward (split-TF32
products, ``csrc/tf32x3.cuh``) with one part removed or cheapened (one TF32
product instead of three, no split, the hardware exp, ...) or with the split
done the costlier ways (the small part rounded too; both parts by
``cvt.rna.tf32.f32``), at ViT-L's shapes in fp32. One CUDA card.

    python3 scripts/ablate_torch_kernels.py [bf16|fp32|mlp|check]

(no argument: bf16 and fp32; ``mlp``: the two MLP groups alone). The
variants are text edits of ``beach_seg_tpu_torch/ops/csrc/`` (a source or a
shared header), each compiled in its own temporary directory; the outputs of
a variant with a part removed are wrong by construction and only their times
mean anything. Prints the card, ptxas' register and spill lines of the fp32
instances, then one JSON line per variant. Exits non-zero without a CUDA
device.

``check`` instead holds faulty builds against their plain versions by
chip_smoke.py's limits, which each must fail: the bf16 flash forward (#3,
#6, #7: no rel terms, a crossing slot chunk dropped, a key tile dropped, no
tail mask; #1's ws body: no rel terms, a crossing slot chunk dropped, no
tail mask, no v bias) by the forward attention limits, and the LN→MLP (the last 64-channel
K tile of W1 or 128-unit hidden tile of W2 dropped) and its dx (gelu' or the
LN VJP's xhat term left out) by the MLP limits, at ViT-L and ViT-H shapes
and a ragged N.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# variant → edits: (old, new) in the kernel's source, or (header, old, new)
# the LN→MLP stage kernels (gemm_sm90.cuh's TMA + wgmma products): ln_mlp.cu,
# then ln_mlp_dx.cu, each with its ring cut to one stage, without its
# producer warpgroup (two warpgroups a block, the first consumer thread
# issuing the loads NS entries ahead, each once the entry it replaces is
# done), and without its epilogue's activation (GELU; gelu') or, for
# dual_dh, its second product (g·W2ᵀ); "no_global_stores" keeps the products
# and the staging in shared memory and drops the epilogue's stores to device
# memory
HAND_BACK = "      if (done >= 0 && signals) bar_arrive(smem_u32(&empty[done % NS]));\n"
NO_PRODUCER = [
    ("gemm_sm90.cuh", "constexpr int NT = 384;", "constexpr int NT = 256;"),
    ("gemm_sm90.cuh", """  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0)
      for (int i = 0; i < total; ++i) load_entry(i);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(CONSUMER_REGS));
  const int cw = wg - 1;  // this consumer warpgroup: rows 64·cw of the tile
""", """  const int cw = wg;
  const bool loads = threadIdx.x == 0;
  if (loads)
    for (int i = 0; i < NS && i < total; ++i) load_entry(i);
"""),
    ("gemm_sm90.cuh", HAND_BACK, HAND_BACK + "      if (loads && done >= 0 && done + NS < total) load_entry(done + NS);\n"),
    ("gemm_sm90.cuh", "  if (attr.numRegs != LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;\n", ""),
]
NO_STORES = ("gemm_sm90.cuh", "    if (row < N && col < NOUT) {\n      uint4 u;", "    if (row < 0) {\n      uint4 u;")
MLP = {
    "ring_1": [("constexpr int RING = 4;", "constexpr int RING = 1;")],
    "no_producer_warp": NO_PRODUCER,
    "no_gelu": [("return pack(gelu_epi<APPROX>(v[0][0] + b.x), gelu_epi<APPROX>(v[0][1] + b.y));", "return pack(v[0][0] + b.x, v[0][1] + b.y);")],
    "no_global_stores": [NO_STORES],
}
NO_GELU_GRAD = ("v[NP - 1][0] * gelu_grad_epi<APPROX>(v[0][0] + b.x), v[NP - 1][1] * gelu_grad_epi<APPROX>(v[0][1] + b.y)",
                "v[NP - 1][0] * v[0][0], v[NP - 1][1] * v[0][1]")
MLP_DX = {
    "ring_1": [("constexpr int RING_DUAL = 6;", "constexpr int RING_DUAL = 1;"), ("constexpr int RING_DLN = 4;", "constexpr int RING_DLN = 1;")],
    "no_producer_warp": NO_PRODUCER,
    "no_second_accumulator": [("constexpr int DUAL = 2;", "constexpr int DUAL = 1;")],
    "no_gelu_grad": [NO_GELU_GRAD],
    "no_global_stores": [NO_STORES],
}
# faults of the LN→MLP kernels, for the `check` mode: each must fail
# chip_smoke's MLP limits: the last 64-channel K tile of ln·W1 and the last
# 128-unit hidden tile (two k steps) of h·W2 left out of the forward's
# products (the kernel walks fewer k steps of full-size operands; in
# ln_mlp.cu's library only lin1 has K = C ≤ 1280 and only lin2 K = M > 1280),
# gelu' left out of dh, the xhat term left out of the LN VJP
KSTEPS = "maps[2], maps[3], N, NOUT, K / BK, epi);"
MLP_FAULTS = {
    "drop_w1_k_tile": [("gemm_sm90.cuh", KSTEPS, "maps[2], maps[3], N, NOUT, K / BK - (K <= 1280), epi);")],
    "drop_w2_hidden_tile": [("gemm_sm90.cuh", KSTEPS, "maps[2], maps[3], N, NOUT, K / BK - 2 * (K > 1280), epi);")],
}
MLP_DX_FAULTS = {
    "no_gelu_grad": [NO_GELU_GRAD],
    "no_xhat_term": [("(d[i][e] - dmean - xh[i][e] * s2 / C) * rs", "(d[i][e] - dmean) * rs")],
}
# the bf16 wgmma designs (attn_flash.cuh behind #3, #6, #7; attn_bwd.cu's bf16 instance)
FLASH = {
    "no_rel_terms": [("attn_flash.cuh", "      if (touched(c, nx, hkp, c_lo, c_hi)) {  // rel terms",
                      "      if (false) {  // rel terms")],
    "no_prefetch": [("attn_flash.cuh", "    if (kt + NS - 1 < nk) load_stage(kt + NS - 1);\n    cp_async_commit();\n",
                     "    if (kt + NS - 1 < nk) load_stage(kt + NS - 1);\n    cp_async_commit();\n    cp_async_wait<0>();\n")],
    "no_pv": [("attn_flash.cuh", "    for (int ks = 0; ks < 4; ++ks) mma_rs<HD>(o, pa[ks], mndesc(sb + TB + ks * 16 * 32, 64), 1);\n", "")],
}
# #1 bf16 (attn_qkv_rel.cu: attn_ws.cuh's warp-specialized kernel): without
# its rel terms, without the two warpgroups' turns, without the
# exponentials, without PV, with the ring cut to 2 stages, and its two
# pre-pass launches alone
WS = "attn_ws.cuh"
WS_PV = "    for (int ks = 0; ks < 4; ++ks) mma_rs<HD>(o, pa[ks], mndesc(sb + TB + ks * 16 * 32, 64), 1);\n"
WS_BIAS = "        const uint4 bb = __ldg(reinterpret_cast<const uint4*>(bias + w * C + h * HD + c8));\n"
ATTN = {
    "no_rel_terms": [(WS, "      if (touched(c, nx, hkp, c_lo, c_hi)) mma_rs_k", "      if (false) mma_rs_k")],
    "no_turns": [(WS, "  const bool turns = nwg == NWG;", "  const bool turns = false;")],
    "no_exp": [(WS, "      s[i] = __expf(SOFTMAX == STABLE ? x - m[(i >> 1) & 1] : SOFTMAX == CLAMP ? fminf(x, 80.0f) : x);",
                "      s[i] = x;")],
    "no_pv": [(WS, WS_PV, "")],
    "ring_2": [(WS, "constexpr int NS = 5;", "constexpr int NS = 2;")],
    "pre_passes_only": [(WS, "  kernel<<<grid, NTB, bytes, st>>>(", "  if (S < 0) kernel<<<grid, NTB, bytes, st>>>(")],
}
# faults of the bf16 flash forward, for the `check` mode: each must fail
# chip_smoke's forward limits, or the limits see too little
FLASH_FAULTS = {
    "no_rel_terms": FLASH["no_rel_terms"],
    "drop_crossing_chunk": [("attn_flash.cuh", "c_hi = (min(k0 + 63, S - 1) / wk) / 16;", "c_hi = c_lo;")],
    "drop_key_tile": [("attn_flash.cuh", "        if (key >= S) x = -INFINITY;\n",
                       "        if (key >= S || kt == nk / 2) x = -INFINITY;\n")],
    "no_tail_mask": [("attn_flash.cuh", "        if (key >= S) x = -INFINITY;\n", "")],
}
# and of #1 bf16 (a dropped k bias is not among them: it adds q·bk to every
# score of a row, which the softmax cancels up to rounding)
QKV_REL_FAULTS = {
    "no_rel_terms": ATTN["no_rel_terms"],
    "drop_crossing_chunk": [(WS, "c_hi = (min(k0 + 63, S - 1) / wk) / 16;", "c_hi = c_lo;")],
    "no_tail_mask": [(WS, "        if (key >= S) x = -INFINITY;\n", "")],
    "no_v_bias": [(WS, WS_BIAS, WS_BIAS.replace("const uint4 bb = ", "const uint4 bb = w == 2 ? make_uint4(0u, 0u, 0u, 0u) : "))],
}
BWD = {  # attn_bwd.cu, bf16 instance
    "no_rel_terms": [
        ("      if (touched(c, nx, hkp, c_lo, c_hi)) mma_ss<64>(s, kdesc(sR + c * BT * 32), kdesc(sb + 2 * TB + c * BT * 32), 1);\n", ""),
        ("      if (touched(c, nx, hkp, c_lo, c_hi)) mma_ss<64>(st, kdesc(sE + c * BT * 32), kdesc(sb + 2 * TB + c * BT * 32), 1);\n", ""),
    ],
    "no_drh_drw": [("      if (touched(c, nx, hkp, c_lo, c_hi)) {  // drh, drw", "      if (false) {  // drh, drw")],
    "no_prefetch": [
        ("    if (it + NS - 1 < 2 * nk) load_stage(it + NS - 1);\n    cp_async_commit();\n",
         "    if (it + NS - 1 < 2 * nk) load_stage(it + NS - 1);\n    cp_async_commit();\n    cp_async_wait<0>();\n"),
        ("    if (qt + NS - 1 < nq) load_stage(qt + NS - 1);\n    cp_async_commit();\n",
         "    if (qt + NS - 1 < nq) load_stage(qt + NS - 1);\n    cp_async_commit();\n    cp_async_wait<0>();\n"),
    ],
    "q_kernel_only": [("  bwd_k_kernel<HD><<<grid, NT, smk, st>>>(", "  if (S < 0) bwd_k_kernel<HD><<<grid, NT, smk, st>>>(")],
}

# the split-TF32 products of the fp32 instances (tf32x3.cuh)
ONE_PRODUCT = [("tf32x3.cuh", "  mma(d, a.small, b.big);\n  mma(d, a.big, b.small);\n  mma(d, a.big, b.big);\n",
                "  mma(d, a.big, b.big);\n"),
               ("tf32x3.cuh", "  mma(d, a.small, e);\n  mma(d, a.big, e);\n", "  mma(d, a.big, e);\n")]
NO_SPLIT = [("tf32x3.cuh", "  big = round_tf32(x);\n  small = __float_as_uint(x - __uint_as_float(big));\n",
             "  big = small = __float_as_uint(x);\n")]
# the small part rounded to TF32 too (integer add and mask), or both parts by cvt.rna.tf32.f32
RNA_SMALL = [("tf32x3.cuh", "  small = __float_as_uint(x - __uint_as_float(big));\n",
              "  small = round_tf32(x - __uint_as_float(big));\n")]
CVT_SPLIT = [("tf32x3.cuh", "{ return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }",
              '{\n  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n  return r;\n}'),
             *RNA_SMALL]
ATTN32 = {  # attn_qkv_rel.cu, fp32 instance
    "fp32_one_product": ONE_PRODUCT,
    "fp32_no_split": NO_SPLIT,
    "fp32_rna_small": RNA_SMALL,
    "fp32_cvt_split": CVT_SPLIT,
    "fp32_fast_exp": [("        s[j][c] = softmax_p<false>(s[j][c], m[c / 2], softmax);",
                       "        s[j][c] = softmax_p<true>(s[j][c], m[c / 2], softmax);")],
    "fp32_no_rel_lookups": [("          s[j][e] += rh.x + rw.x;\n          s[j][2 + e] += rh.y + rw.y;\n", "")],
    "fp32_no_pv": [("        mma3(pv[nt], pa, split_b(vr[0], vr[LD]));\n", "")],
}
BWD32 = {  # attn_bwd.cu, fp32 instance at head_dim 64
    "fp32_one_product": ONE_PRODUCT,
    "fp32_no_split": NO_SPLIT,
    "fp32_rna_small": RNA_SMALL,
    "fp32_cvt_split": CVT_SPLIT,
    "fp32_fast_exp": [("            const float u = expf(s[j][2 * i + e] - mnew);", "            const float u = __expf(s[j][2 * i + e] - mnew);"),
                      ("        s[j][c] = expf(s[j][c] - m[i]) * linv[i]", "        s[j][c] = __expf(s[j][c] - m[i]) * linv[i]"),
                      ("            p = expf(s - m) * linv;", "            p = __expf(s - m) * linv;")],
    "fp32_no_slot_sums": [("    slot_sums(sHh + kh0, sh, s, nh, rA, rB, gr, t);", "    (void)nh;"),
                          ("    slot_sums(sHw, sw, s, min(wk, 32), rA, rB, gr, t);", ""),
                          ("    if (wk > 32) slot_sums(sHw + 32, sw, s, wk - 32, rA, rB, gr, t, 32);", "")],
    "fp32_k_no_step_loads": [("      load_step(sRh, sRw, sM, rhp, rwp, stats + (size_t)bh * S, (size_t)BH * S, S, hk, wk, q0 + BK, tid);", "")],
    "fp32_q_kernel_only": [("  bwd_k_kernel<HD><<<grid, NT, smem_k<HD>(), st>>>((const float*)q,",
                            "  if (S < 0) bwd_k_kernel<HD><<<grid, NT, smem_k<HD>(), st>>>((const float*)q,")],
}


def build_variants(specs: list[tuple[str, str, dict]], out: Path, show_ptxas: set[str] = frozenset()) -> dict:
    """Compile every (group, source name, variants) spec's intact source and
    its variants, all ``nvcc`` processes at once, each in its own directory
    beside copies of the shared headers; returns group → variant → library."""
    from beach_seg_tpu_torch.ops import build

    procs = {}
    for group, name, edits in specs:
        for variant, changes in {"intact": [], **edits}.items():
            files = {p.name: p.read_text() for p in [build.CSRC / f"{name}.cu", *build.CSRC.glob("*.cuh")]}
            for change in changes:
                fname, old, new = change if len(change) == 3 else (f"{name}.cu", *change)
                if files[fname].count(old) != 1:
                    raise RuntimeError(f"{fname} no longer has the text variant {group} {variant} edits")
                files[fname] = files[fname].replace(old, new)
            d = out / f"{group}_{variant}"
            d.mkdir()
            for fname, text in files.items():
                (d / fname).write_text(text)
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / f"lib{name}.so"), str(d / f"{name}.cu")]
            procs[group, variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                                     d / f"lib{name}.so")
    libs: dict[str, dict[str, ctypes.CDLL]] = {}
    for (group, variant), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {group} {variant}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines if group in show_ptxas else ()):
            if "Compiling entry" in line and (group not in ("attn32", "bwd32") or "PKf" in line):
                print(f"{group} {variant}: {line.strip()[-70:]} | {' | '.join(x.strip() for x in lines[i + 1:i + 3])}")
        libs.setdefault(group, {})[variant] = ctypes.CDLL(str(so))
    return libs


@contextlib.contextmanager
def loaded(lib: ctypes.CDLL):
    """The wrappers launch from ``lib`` (a variant's build) while inside."""
    from beach_seg_tpu_torch.ops import build

    load = build.load

    def load_variant(name, prototypes):
        for fn, argtypes in prototypes.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
        return lib

    build.load = load_variant
    try:
        yield
    finally:
        build.load = load


def check_faults() -> int:
    """Each FLASH_FAULTS variant of #3, #7 and #6 and each QKV_REL_FAULTS
    variant of #1 (clamp, its default), and the intact sources, through the
    wrappers at B=8 bf16 on the ViT grid and on GRID_CROSS, against the
    plain versions: one JSON line each with chip_smoke's readings
    (largest error, max|plain|, error norm over the output's) and whether
    they pass its limits. Exits non-zero if the intact kernel fails or a
    fault passes at a grid where it changes what the kernel computes (a
    dropped crossing chunk changes nothing on the ViT grid)."""
    import chip_smoke
    from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp
    from beach_seg_tpu_torch.ops.attention import attention_fused_plain, attention_packed_plain, attention_qkv_plain

    dev = torch.device("cuda")
    heads, hd = chip_smoke.HEADS, chip_smoke.HD
    bh, scale = chip_smoke.B * heads, hd**-0.5
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants([(name, name, FLASH_FAULTS) for name in ("attn_packed", "attn_fused", "attn_qkv")]
                              + [("attn_qkv_rel", "attn_qkv_rel", QKV_REL_FAULTS), ("ln_mlp", "ln_mlp", MLP_FAULTS),
                                 ("ln_mlp_dx", "ln_mlp_dx", MLP_DX_FAULTS)], Path(tmp))
        for grid in (chip_smoke.GRID, chip_smoke.GRID_CROSS):
            gh, gw = grid
            q, k, v, rh, rw = chip_smoke.packed_inputs(dev, torch.bfloat16, bh, hd, seed=8, grid=grid)
            qkv, _, _, (rh64, rw64) = chip_smoke.qkv_slot_inputs(dev, torch.bfloat16, grid=grid)
            qkv4, bias, rh_tab, rw_tab = chip_smoke.attn_inputs(torch.bfloat16, dev, grid=grid)
            calls = {
                "attn_packed": (cuda_attn.attn_packed, attention_packed_plain, (q, k, v, rh, rw, scale, heads)),
                "attn_fused": (cuda_attn.attn_fused, attention_fused_plain, (q, k, v, rh, rw, scale)),
                "attn_qkv": (cuda_attn.attn_qkv, attention_qkv_plain, (qkv, rh64, rw64, scale, gh, gw, heads)),
                "attn_qkv_rel": (cuda_attn.attn_qkv_rel, cuda_attn.attn_qkv_rel_plain,
                                 (qkv4, bias, rh_tab, rw_tab, scale, gw, heads, "clamp")),
            }
            for name, (fn, plain, args) in calls.items():
                want = plain(*args)
                for variant, lib in libs[name].items():
                    with loaded(lib):
                        got = fn(*args)
                    torch.cuda.synchronize()
                    e = chip_smoke.attn_errors(got, want)
                    passes = chip_smoke.attn_within(e, torch.bfloat16)
                    inert = variant == "drop_crossing_chunk" and grid == chip_smoke.GRID
                    bad += passes != (variant == "intact" or inert)
                    print(json.dumps({"kernel": name, "variant": variant, "grid": list(grid), **e, "passes": passes}), flush=True)
                    del got
        # the LN→MLP and its dx (tanh GELU, the bf16 model's) at the B=8
        # shapes of ViT-L and ViT-H and at a ragged N = S + 9
        s = chip_smoke.GRID[0] * chip_smoke.GRID[1]
        for geo, c, m, n in (("vit_l", chip_smoke.C, chip_smoke.MLP, chip_smoke.B * s),
                             ("vit_h", chip_smoke.C_H, chip_smoke.MLP_H, chip_smoke.B * s),
                             ("vit_l_ragged", chip_smoke.C, chip_smoke.MLP, s + 9)):
            x, ls, lb, w1, b1, w2, b2, gy = chip_smoke.mlp_inputs(dev, 9, n, c, m)
            for name, fn, plain, last, tol in (
                ("ln_mlp", cuda_mlp.ln_mlp, cuda_mlp.ln_mlp_plain, b2, chip_smoke.MLP_BF16_REL_TOL),
                ("ln_mlp_dx", cuda_mlp.ln_mlp_dx, cuda_mlp.ln_mlp_dx_plain, gy, chip_smoke.MLP_DX_REL_TOL),
            ):
                args = (x, ls, lb, w1, b1, w2, last, 1e-6, True)
                want = plain(*args)
                for variant, lib in libs[name].items():
                    with loaded(lib):
                        got = fn(*args)
                    torch.cuda.synchronize()
                    e = chip_smoke.attn_errors(got, want)
                    passes = chip_smoke.mlp_within(e, tol)
                    bad += passes != (variant == "intact")
                    print(json.dumps({"kernel": name, "variant": variant, "shape": geo, **e, "passes": passes}), flush=True)
                    del got
            del x, w1, w2, gy
            torch.cuda.empty_cache()
    return int(bad > 0)


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("all", "bf16", "fp32", "mlp", "check"):
        print("usage: ablate_torch_kernels.py [bf16|fp32|mlp|check]", file=sys.stderr)
        return 2
    import chip_smoke

    print(chip_smoke.card_line())
    if which == "check":
        return check_faults()
    from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gh, gw = chip_smoke.GRID
    s, c, m, b = gh * gw, chip_smoke.C, chip_smoke.MLP, chip_smoke.B
    specs = []
    if which in ("all", "bf16"):
        specs += [("attn", "attn_qkv_rel", ATTN), ("packed", "attn_packed", FLASH),
                  ("qkv", "attn_qkv", FLASH), ("bwd", "attn_bwd", BWD), ("bwd64", "attn_bwd", BWD)]
    if which in ("all", "bf16", "mlp"):
        specs += [("mlp", "ln_mlp", MLP), ("mlp_dx", "ln_mlp_dx", MLP_DX)]
    if which in ("all", "fp32"):
        specs += [("attn32", "attn_qkv_rel", ATTN32), ("bwd32", "attn_bwd", BWD32)]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(specs, Path(tmp), show_ptxas={"attn32", "bwd32"})
        calls = {}  # group → (entry, argtypes, argument pointers and sizes, iterations)
        if which in ("all", "bf16"):
            # ViT-H: (B·H, S, 80) q, k, v, g and the rel terms, bf16
            bh, hd = b * chip_smoke.HEADS, chip_smoke.HD_H
            hq, hk_, hv, hrh, hrw, hg = chip_smoke.attn_bwd_inputs(dev, bh, hd=hd)
            hout = torch.empty((b, s, chip_smoke.C_H), dtype=torch.bfloat16, device=dev)
            dq, dk, dv = torch.empty_like(hq), torch.empty(hq.shape, device=dev), torch.empty(hq.shape, device=dev)
            drh, drw, stats = torch.empty_like(hrh), torch.empty_like(hrw), torch.empty((3, bh, s), device=dev)
            qkv, bias, rh, rw = chip_smoke.attn_inputs(torch.bfloat16, dev)
            out = torch.empty((b, s, c), dtype=torch.bfloat16, device=dev)
            e, slots, kv = cuda_attn._ws_scratch(b, chip_smoke.HEADS, s, gh, gw, dev)
            calls["attn"] = ("attn_qkv_rel_bf16", cuda_attn._PROTO_BF16, (qkv, bias, rh, rw, e, slots, kv, out, b, s, c,
                                                                          chip_smoke.HEADS, gh, gw, chip_smoke.HD**-0.5, 1), 20)
            calls["packed"] = ("attn_packed_bf16", cuda_attn._PACKED_PROTO, (hq, hk_, hv, hrh, hrw, e, hout, bh, s, hd,
                                                                             chip_smoke.HEADS, gh, gw, hd**-0.5), 20)
            calls["bwd"] = ("attn_bwd_bf16", cuda_attn._BWD_PROTO,
                            (hq, hk_, hv, hrh, hrw, hg, e, slots, dq, dk, dv, drh, drw, stats, bh, s, hd, gh, gw, hd**-0.5), 10)
            # ViT-L: #6 over the (B, S, 3C) qkv tensor, #4 at head_dim 64
            lqkv, _, _, (lrh64, lrw64) = chip_smoke.qkv_slot_inputs(dev, torch.bfloat16)
            calls["qkv"] = ("attn_qkv_bf16", cuda_attn._QKV_PROTO, (lqkv, lrh64, lrw64, e, out, b, s, chip_smoke.HD,
                                                                    chip_smoke.HEADS, gh, gw, chip_smoke.HD**-0.5), 20)
            lq, lk, lv, lrh, lrw, lg = chip_smoke.attn_bwd_inputs(dev, bh, hd=chip_smoke.HD)
            ldq, ldk, ldv = torch.empty_like(lq), torch.empty(lq.shape, device=dev), torch.empty(lq.shape, device=dev)
            calls["bwd64"] = ("attn_bwd_bf16", cuda_attn._BWD_PROTO,
                              (lq, lk, lv, lrh, lrw, lg, e, slots, ldq, ldk, ldv, torch.empty_like(lrh), torch.empty_like(lrw),
                               stats, bh, s, chip_smoke.HD, gh, gw, chip_smoke.HD**-0.5), 10)
        wrapped = {"mlp": {}, "mlp_dx": {}}  # group → label → a call through the wrappers
        if which in ("all", "bf16", "mlp"):
            # the LN→MLP at ViT-L and ViT-H widths, B=8: whole and by stage
            for geo, cw, mw in (("vit_l", c, m), ("vit_h", chip_smoke.C_H, chip_smoke.MLP_H)):
                x, ls, lb, w1, b1, w2, b2, gy = chip_smoke.mlp_inputs(dev, 1, b * s, cw, mw)
                ln, mean, rstd = cuda_mlp.ln_rows_plain(x, ls, lb, 1e-6)
                h = cuda_mlp.lin1_gelu_plain(ln, w1, b1, True)
                dh = cuda_mlp.dual_dh_plain(ln, gy, w1, b1, w2, True)
                args = (x, ls, lb, w1, b1, w2)
                wrapped["mlp"].update({
                    f"ln_mlp_{geo}": lambda a=args, b2=b2: cuda_mlp.ln_mlp(*a, b2, 1e-6, True),
                    f"lin1_gelu_{geo}": lambda ln=ln, w1=w1, b1=b1: cuda_mlp.lin1_gelu(ln, w1, b1, True),
                    f"lin2_{geo}": lambda h=h, w2=w2, b2=b2: cuda_mlp.lin2(h, w2, b2),
                })
                wrapped["mlp_dx"].update({
                    f"ln_mlp_dx_{geo}": lambda a=args, gy=gy: cuda_mlp.ln_mlp_dx(*a, gy, 1e-6, True),
                    f"dual_dh_{geo}": lambda ln=ln, gy=gy, w1=w1, b1=b1, w2=w2: cuda_mlp.dual_dh(ln, gy, w1, b1, w2, True),
                    f"dln_{geo}": lambda dh=dh, w1=w1: cuda_mlp.dln(dh, w1),
                })
        if which in ("all", "fp32"):
            # ViT-L in fp32: the qkv-rel forward at B=8 and the backward at head_dim 64
            bh, hd = b * chip_smoke.HEADS, chip_smoke.HD
            qkv, bias, rh, rw = chip_smoke.attn_inputs(torch.float32, dev)
            out = torch.empty((b, s, c), device=dev)
            fq, fk, fv, frh, frw, fg = chip_smoke.attn_bwd_inputs(dev, bh, hd=hd, dtype=torch.float32)
            dq, dk, dv = (torch.empty_like(fq) for _ in range(3))
            drh, drw, stats = torch.empty_like(frh), torch.empty_like(frw), torch.empty((3, bh, s), device=dev)
            calls["attn32"] = ("attn_qkv_rel_f32", cuda_attn._PROTO, (qkv, bias, rh, rw, None, out, b, s, c, chip_smoke.HEADS,
                                                                      gh, gw, hd**-0.5, 0), 5)
            calls["bwd32"] = ("attn_bwd_f32", cuda_attn._BWD_PROTO,
                              (fq, fk, fv, frh, frw, fg, None, None, dq, dk, dv, drh, drw, stats, bh, s, hd, gh, gw, hd**-0.5), 3)
        for rep in range(2):  # two passes, to show the spread
            for group, variants in libs.items():
                if group in wrapped:
                    for variant, lib in variants.items():
                        with loaded(lib):
                            for label, fn in wrapped[group].items():
                                ms = chip_smoke.time_ms(fn, iters=10, warmup=2)
                                print(json.dumps({"kernel": label, "variant": variant, "pass": rep, "ms": ms}), flush=True)
                    continue
                entry, argtypes, args, iters = calls[group]
                ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args] + [stream]  # None: a null pointer
                for variant, lib in variants.items():
                    fn = getattr(lib, entry)
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
                    ms = chip_smoke.time_ms(lambda: fn(*ptrs), iters=iters, warmup=2)
                    print(json.dumps({"kernel": entry, "variant": variant, "pass": rep, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
