"""Microbenchmark of the port's attention-layer pieces on one CUDA card.

    python3 scripts/bench_torch_attn_parts.py [all|relk|softmax|kernel|producer|fused]

The pieces of ``scripts/bench_attn_parts.py`` (the JAX package's bench) at
its geometry, B=32 tiles, ViT-L (16 heads of 64, a 56×28 grid, S=1568),
bf16:
  relk      the qkv-rel attention with the rel tables in (``attn_qkv_rel``,
            port of ``_kernel_qkv_rel``; zero qkv bias, the dtype's default
            softmax);
  softmax   the same kernel in each of its three softmax modes (stable,
            clamp, fast);
  kernel    ``fused_attention_qkv`` on precomputed 64-slot rel terms (the
            CUDA port of ``_kernel_qkv``);
  producer  ``rel_pos_terms_split`` alone (the slot terms' einsums);
  fused     producer + kernel.
Prints the card's name and power limit, then one line per piece: ms per call
and TF/s, counting the attention's two products, 4·B·nH·S²·hd FLOP (the JAX
bench counts its TPU kernel's padded packed contraction instead).

Each piece is timed with CUDA events over repeated calls after a warm-up
(``chip_smoke.time_ms``); the JAX bench's differential salted copies exist
for the TPU runtime's memoizer and its fixed dispatch cost, and have no
counterpart here. Its ``block_q`` lines are dropped: the q-block is a Mosaic
compiler knob, and the port's kernels fix their tiles at compile time.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B, NH, HD, GH, GW = 32, 16, 64, 56, 28
C = NH * HD
S = GH * GW
DT = torch.bfloat16
ITERS = 10


def timeit(name: str, fn, flops: float | None = None) -> float:
    import chip_smoke

    dt = chip_smoke.time_ms(fn, iters=ITERS, warmup=2)
    eff = f"  {flops / (dt / 1000) / 1e12:7.1f} TF/s" if flops else ""
    print(f"{name:40s} {dt:8.3f} ms{eff}", flush=True)
    return dt


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch_attn_parts: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from beach_seg_tpu_torch.ops import cuda_attn
    from beach_seg_tpu_torch.ops.attention import rel_pos_terms_split, rel_tables_padded
    from beach_seg_tpu_torch.utils import resolve_device

    dev = resolve_device("cuda")
    print(chip_smoke.card_line(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = (0.05 * torch.randn((B, S, 3 * C), generator=g, device=dev)).to(DT)
    rph = (0.05 * torch.randn((2 * GH - 1, HD), generator=g, device=dev)).to(DT)
    rpw = (0.05 * torch.randn((2 * GW - 1, HD), generator=g, device=dev)).to(DT)

    def producer():
        return rel_pos_terms_split(qkv[..., :C].reshape(B, GH, GW, NH, HD), rph, rpw, (GH, GW), (GH, GW))

    rel_h64, rel_w64 = producer()
    zbias = torch.zeros((3, C), dtype=DT, device=dev)
    rh_tab, rw_tab = rel_tables_padded(rph, rpw, (GH, GW), (GH, GW))
    qkv4 = qkv.reshape(B, S, 3, C)

    def rel_in_kernel(softmax=None):
        return lambda: cuda_attn.qkv_rel_attention(qkv4, zbias, rh_tab, rw_tab, HD**-0.5, GW, NH, softmax)

    def fused():
        rh, rw = producer()
        return cuda_attn.fused_attention_qkv(qkv, rh, rw, HD**-0.5, GH, GW, NH)

    attn_flops = 4 * B * NH * S * S * HD
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "relk"):
        timeit("rel-in-kernel (tables in)", rel_in_kernel(), flops=attn_flops)
    if which in ("all", "softmax"):
        for mode in cuda_attn.SOFTMAX_MODES:
            timeit(f"rel-in-kernel {mode}", rel_in_kernel(mode), flops=attn_flops)
    if which in ("all", "kernel"):
        timeit(
            "kernel_only (split rel)",
            lambda: cuda_attn.fused_attention_qkv(qkv, rel_h64, rel_w64, HD**-0.5, GH, GW, NH),
            flops=attn_flops,
        )
    if which in ("all", "producer"):
        timeit("rel_pos_terms_split", producer, flops=2 * B * NH * S * HD * (GH + GW))
    if which in ("all", "fused"):
        timeit("producer+kernel", fused, flops=attn_flops)
    return 0


if __name__ == "__main__":
    sys.exit(main())
