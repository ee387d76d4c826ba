"""Where the time of the torch port's CUDA kernels goes: the two ViT-L
forward kernels are rebuilt with one phase removed and timed beside the
intact ones at the main path's shapes (B=8 tiles of ViT-L); the two ViT-H
attention kernels (packed forward, backward at head_dim 80), whose
instances spill registers, are rebuilt with one block per SM in their
launch bounds and timed beside the intact ones at ViT-H's shapes. One CUDA
card.

    python3 scripts/ablate_torch_kernels.py

The variants are text edits of ``beach_seg_tpu_torch/ops/csrc/*.cu`` compiled
into a temporary directory; the phase-removed outputs are wrong by
construction and only their times mean anything. Prints the card, ptxas'
register and spill lines of the launch-bound variants, then one JSON line per
variant. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ATTN = {  # variant → (text in attn_qkv_rel.cu, replacement)
    "no_rel_terms": ("    const int nrows = min(BQ, S - q0);", "    const int nrows = 0;"),
    "no_rel_lookups": (
        "          s[j][e] += __bfloat162float(sRh[rA * RLD + kh]) + __bfloat162float(sRw[rA * RLD + kw]);\n"
        "          s[j][2 + e] += __bfloat162float(sRh[rB * RLD + kh]) + __bfloat162float(sRw[rB * RLD + kw]);\n",
        "",
    ),
    "no_bias_pass": ("    for (int i = tid; i < 2 * BK * 8; i += NT) {\n      const int which = i / (BK * 8), r = (i / 8) % BK, c8 = (i % 8) * 8;\n      uint4* t",
                     "    for (int i = tid; i < 0; i += NT) {\n      const int which = i / (BK * 8), r = (i / 8) % BK, c8 = (i % 8) * 8;\n      uint4* t"),
    "no_pv": ("        mma(o[2 * jj], pa[t], vb[0], vb[1]);\n        mma(o[2 * jj + 1], pa[t], vb[2], vb[3]);", ""),
}
MLP = {  # variant → (text in ln_mlp.cu, replacement)
    "no_weight_loads": ("  auto issue = [&](int s, int st) {\n", "  auto issue = [&](int s, int st) {\n    return;\n"),
    "no_lin1_products": ("      for (int kk = 0; kk < KC / 16; ++kk) {\n        uint32_t b[4];",
                         "      for (int kk = 0; kk < 0; ++kk) {\n        uint32_t b[4];"),
    "no_lin2_products": ("      for (int cf = 0; cf < WC / 16; ++cf) {\n        uint32_t b[4];",
                         "      for (int cf = 0; cf < 0; ++cf) {\n        uint32_t b[4];"),
}
PACKED = {"one_block_per_sm": ("__global__ void __launch_bounds__(NT, 2) attn_kernel(",  # attn_packed.cu
                               "__global__ void __launch_bounds__(NT, 1) attn_kernel(")}
BWD = {"one_block_per_sm": ("__global__ void __launch_bounds__(NT, 2) bwd_k_kernel(",  # attn_bwd.cu
                            "__global__ void __launch_bounds__(NT, 1) bwd_k_kernel(")}


def build_variants(name: str, edits: dict, out: Path, show_ptxas: bool = False) -> dict[str, ctypes.CDLL]:
    from beach_seg_tpu_torch.ops import build

    src = (build.CSRC / f"{name}.cu").read_text()
    texts = {"intact": src}
    for variant, (old, new) in edits.items():
        if src.count(old) != 1:
            raise RuntimeError(f"{name}.cu no longer has the text variant {variant} edits")
        texts[variant] = src.replace(old, new)
    procs = {}
    for variant, text in texts.items():
        cu = out / f"{name}_{variant}.cu"
        cu.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[variant] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {variant}:\n{log}")
        for line in log.splitlines() if show_ptxas else ():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"{name} {variant}: {line.strip()}")
        libs[variant] = ctypes.CDLL(str(out / f"{name}_{variant}.so"))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp

    print(chip_smoke.card_line())
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gh, gw = chip_smoke.GRID
    s, c, m, b = gh * gw, chip_smoke.C, chip_smoke.MLP, chip_smoke.B
    with tempfile.TemporaryDirectory() as tmp:
        attn = build_variants("attn_qkv_rel", ATTN, Path(tmp))
        mlp = build_variants("ln_mlp", MLP, Path(tmp))
        packed = build_variants("attn_packed", PACKED, Path(tmp), show_ptxas=True)
        bwd = build_variants("attn_bwd", BWD, Path(tmp), show_ptxas=True)
        # ViT-H: (B·H, S, 80) q, k, v, g and the rel terms, bf16
        bh, hd = b * chip_smoke.HEADS, chip_smoke.HD_H
        hq, hk_, hv, hrh, hrw, hg = chip_smoke.attn_bwd_inputs(dev, bh, hd=hd)
        hout = torch.empty((b, s, chip_smoke.C_H), dtype=torch.bfloat16, device=dev)
        dq, dk, dv = torch.empty_like(hq), torch.empty(hq.shape, device=dev), torch.empty(hq.shape, device=dev)
        drh, drw, stats = torch.empty_like(hrh), torch.empty_like(hrw), torch.empty((3, bh, s), device=dev)
        qkv, bias, rh, rw = chip_smoke.attn_inputs(torch.bfloat16, dev)
        out = torch.empty((b, s, c), dtype=torch.bfloat16, device=dev)
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((b * s, c), generator=g, device=dev).to(torch.bfloat16)
        ls, lb = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        w1 = (torch.randn((c, m), generator=g, device=dev) / c**0.5).to(torch.bfloat16)
        w2 = (torch.randn((m, c), generator=g, device=dev) / m**0.5).to(torch.bfloat16)
        b1 = torch.zeros(m, dtype=torch.bfloat16, device=dev)
        b2 = torch.zeros(c, dtype=torch.bfloat16, device=dev)
        y = torch.empty_like(x)
        for rep in range(2):  # two passes, to show the spread
            for variant, lib in attn.items():
                fn = getattr(lib, "attn_qkv_rel_bf16")
                fn.argtypes, fn.restype = cuda_attn._PROTO, ctypes.c_int
                ms = chip_smoke.time_ms(lambda: fn(qkv.data_ptr(), bias.data_ptr(), rh.data_ptr(), rw.data_ptr(),
                                                   out.data_ptr(), b, s, c, chip_smoke.HEADS, gh, gw,
                                                   chip_smoke.HD**-0.5, 1, stream), iters=20, warmup=2)
                print(json.dumps({"kernel": "attn_qkv_rel", "variant": variant, "pass": rep, "ms": ms}))
            for variant, lib in mlp.items():
                fn = getattr(lib, "ln_mlp_bf16")
                fn.argtypes, fn.restype = cuda_mlp._PROTO["ln_mlp_bf16"], ctypes.c_int
                ms = chip_smoke.time_ms(lambda: fn(x.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1.data_ptr(),
                                                   b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                                                   b * s, c, m, 1e-6, 1, stream), iters=20, warmup=2)
                print(json.dumps({"kernel": "ln_mlp", "variant": variant, "pass": rep, "ms": ms}))
            for variant, lib in packed.items():
                fn = getattr(lib, "attn_packed_bf16")
                fn.argtypes, fn.restype = cuda_attn._PACKED_PROTO, ctypes.c_int
                ms = chip_smoke.time_ms(lambda: fn(hq.data_ptr(), hk_.data_ptr(), hv.data_ptr(), hrh.data_ptr(),
                                                   hrw.data_ptr(), hout.data_ptr(), bh, s, hd, chip_smoke.HEADS, gh, gw,
                                                   hd**-0.5, stream), iters=20, warmup=2)
                print(json.dumps({"kernel": "attn_packed", "variant": variant, "pass": rep, "ms": ms}))
            for variant, lib in bwd.items():
                fn = getattr(lib, "attn_bwd_bf16")
                fn.argtypes, fn.restype = cuda_attn._BWD_PROTO["attn_bwd_bf16"], ctypes.c_int
                ms = chip_smoke.time_ms(lambda: fn(hq.data_ptr(), hk_.data_ptr(), hv.data_ptr(), hrh.data_ptr(),
                                                   hrw.data_ptr(), hg.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                                   dv.data_ptr(), drh.data_ptr(), drw.data_ptr(), stats.data_ptr(),
                                                   bh, s, hd, gh, gw, hd**-0.5, stream), iters=10, warmup=2)
                print(json.dumps({"kernel": "attn_bwd", "variant": variant, "pass": rep, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
