"""Component microbenchmark of the port's ViT-L forward layer on one CUDA card.

    python3 scripts/bench_torch_parts.py

The pieces of ``scripts/bench_parts.py`` (the JAX package's bench) at its
geometry, B=32 tiles, S=1568 (56×28 grid), C=1024, 16 heads of 64, bf16:
the qkv product, the rel-pos terms (einsums), the fused attention
(``ops.cuda_attn.fused_attention``: the CUDA port of the TPU kernel
``_kernel``), the plain attention oracle, the proj product, the MLP in three
GELU variants, the fp32 LayerNorm and the attention's two products alone;
then the per-layer sum and the encoder's 27 layer-equivalents (layers 0-2
run at 2B before the stream merge) as tiles/s. Prints the card's name and
power limit, then one line per piece: ms per call and TF/s where a FLOP count
is given.

Each piece is timed with CUDA events over repeated calls after a warm-up
(``chip_smoke.time_ms``); the JAX bench's salted ``lax.scan`` exists for the
TPU runtime's memoizer and has no counterpart here. Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B = 32
GH, GW = 56, 28
S = GH * GW
C, NH = 1024, 16
HD = C // NH
DT = torch.bfloat16
ITERS = 24


def timeit(name: str, fn, flops: float | None = None, iters: int = ITERS) -> float:
    import chip_smoke

    dt = chip_smoke.time_ms(fn, iters=iters, warmup=2)
    eff = f"  {flops / (dt / 1000) / 1e12:7.1f} TF/s" if flops else ""
    print(f"{name:36s} {dt:8.3f} ms{eff}", flush=True)
    return dt


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch_parts: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from beach_seg_tpu_torch.ops import cuda_attn
    from beach_seg_tpu_torch.ops.attention import attention_reference, rel_pos_terms
    from beach_seg_tpu_torch.utils import resolve_device

    dev = resolve_device("cuda")
    print(chip_smoke.card_line(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, sc=1.0: (sc * torch.randn(shape, generator=g, device=dev)).to(DT)  # noqa: E731
    x = rnd(B, S, C)
    qkv_k, proj_k = rnd(C, 3 * C, sc=0.02), rnd(C, C, sc=0.02)
    mlp_k1, mlp_k2 = rnd(C, 4 * C, sc=0.02), rnd(4 * C, C, sc=0.02)
    q, k, v = rnd(B * NH, S, HD), rnd(B * NH, S, HD), rnd(B * NH, S, HD)
    rph, rpw = rnd(2 * GH - 1, HD, sc=0.02), rnd(2 * GW - 1, HD, sc=0.02)
    rh, rw = rel_pos_terms(q, rph, rpw, (GH, GW), (GH, GW))
    rh_f, rw_f = rh.reshape(B * NH, S, GH).contiguous(), rw.reshape(B * NH, S, GW).contiguous()

    fl_qkv = 2 * B * S * C * 3 * C
    fl_attn = 2 * B * NH * S * S * HD * 2
    fl_proj = 2 * B * S * C * C
    fl_mlp = 2 * B * S * C * 4 * C * 2
    fl_rel = 2 * B * NH * S * HD * (GH + GW)

    t_qkv = timeit("qkv matmul (S,C)x(C,3C)", lambda: x @ qkv_k, flops=fl_qkv)
    t_rel = timeit("rel_pos_terms (einsums)", lambda: rel_pos_terms(q, rph, rpw, (GH, GW), (GH, GW)), flops=fl_rel)
    t_att = timeit(
        "fused attention kernel", lambda: cuda_attn.fused_attention(q, k, v, rh_f, rw_f, HD**-0.5, GH, GW), flops=fl_attn
    )
    timeit("plain reference attention", lambda: attention_reference(q, k, v, rh, rw, HD**-0.5), flops=fl_attn, iters=6)
    t_proj = timeit("proj matmul (S,C)x(C,C)", lambda: x @ proj_k, flops=fl_proj)

    def mlp(gelu):
        return lambda: gelu(x @ mlp_k1) @ mlp_k2

    t_mlp = timeit("mlp (fp32 exact gelu)", mlp(lambda h: F.gelu(h.float()).to(DT)), flops=fl_mlp)
    timeit("mlp (bf16 exact gelu)", mlp(F.gelu), flops=fl_mlp)
    timeit("mlp (bf16 tanh gelu)", mlp(lambda h: F.gelu(h, approximate="tanh")), flops=fl_mlp)

    def ln():
        xf = x.float()
        m = xf.mean(-1, keepdim=True)
        var = ((xf - m) ** 2).mean(-1, keepdim=True)
        return ((xf - m) * torch.rsqrt(var + 1e-6)).to(DT)

    t_ln = timeit("layernorm fp32", ln)
    timeit("attn qk+pv matmuls only", lambda: (q @ k.transpose(1, 2)) @ v, flops=fl_attn, iters=6)

    layer = t_qkv + t_rel + t_att + t_proj + t_mlp + 2 * t_ln
    total = layer * (21 + 3 * 2)  # layers 0-2 run at 2B before merge@2
    print(f"\nper-layer sum                      {layer:8.3f} ms")
    print(f"27 layer-equivalents               {total:8.1f} ms -> {B / (total / 1000):6.1f} tiles/s (encoder only)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
