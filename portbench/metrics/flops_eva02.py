"""Operations and bytes of the EVA-02 painter (``reference/eva02.py``'s
block in SegGPT's topology), from shapes alone.

A layer's row, at S tokens, width C, SwiGLU hidden width M:

- qkv 2·S·C·3C and the out projection 2·S·C²;
- the SwiGLU MLP's three products, 6·S·C·M (W1 and W2 C → M, W3 M → C);
- attention 4·S²·C (scores and PV); no rel-pos terms. The rotations,
  biases and LayerNorms are elementwise work and are not counted.

The embedding of both canvases, the two streams up to ``merge_index`` and
the query-half decoder are ``flops.py``'s.

The two kernels' least times count, besides their operations at the bf16
peak, the bytes of each of their launches once (read once, written once):

- the RoPE attention (``bst.kernel.attn_qkv_rope``): its pre-pass reads the
  qkv product, the q and v biases and the cos / sin tables and writes the
  rotated q, k and biased v; its key loop reads those and writes the heads'
  output;
- the SwiGLU MLP (``bst.kernel.swiglu_mlp``): ``ln_rows`` reads x and writes
  ln; the dual product reads ln, W1 and W2 and writes h; the LN over the
  hidden width reads h and writes hl; the last product reads hl and W3 and
  writes the output. The hidden width counts at its padding to a multiple of
  64, as the kernels store it.
"""

from __future__ import annotations

from portbench.metrics import flops


def padded_mlp(sh: flops.Shape) -> int:
    return -(-sh.mlp // 64) * 64


def linear_flops(sh: flops.Shape) -> float:
    """qkv, the out projection and the SwiGLU MLP of one layer on one row."""
    s, c = sh.tokens, sh.hidden
    return 2.0 * s * c * 3 * c + 2.0 * s * c * c + mlp_flops(sh)


def mlp_flops(sh: flops.Shape) -> float:
    return 6.0 * sh.tokens * sh.hidden * sh.mlp


def attention_flops(sh: flops.Shape) -> float:
    """Scores and PV of one layer on one row."""
    return 4.0 * sh.tokens * sh.tokens * sh.hidden


def forward_flops_per_tile(sh: flops.Shape) -> float:
    """One tile through predict: two canvases embedded, the encoder's
    layer-rows, the query half decoded."""
    per_layer = linear_flops(sh) + attention_flops(sh)
    return 2 * flops.embed_flops(sh) + flops.layer_rows(sh) * per_layer + flops.decoder_flops(sh)


def attention_fwd_bound_s(sh: flops.Shape, rows: int, launches: int, peak: float) -> tuple[float, str]:
    """``launches`` launches of the RoPE attention over ``rows`` rows in
    all, bf16: the operations at ``peak`` or the launches' bytes."""
    s, c, hd = sh.tokens, sh.hidden, sh.head_dim
    per_row = 3 * s * c + 3 * s * c + 3 * s * c + s * c  # qkv in; q, k, v out and in; the output
    per_launch = 2 * c + 2 * s * (hd // 2) * 2  # the q and v biases (bf16); cos and sin (fp32)
    nbytes = 2 * rows * per_row + 2 * launches * per_launch
    return flops.bound_s(rows * attention_flops(sh), nbytes, peak)


def mlp_fwd_bound_s(sh: flops.Shape, rows: int, launches: int, peak: float) -> tuple[float, str]:
    """``launches`` launches of the SwiGLU MLP over ``rows`` rows in all,
    bf16 activations and weights, fp32 LayerNorm parameters."""
    s, c, mp = sh.tokens, sh.hidden, padded_mlp(sh)
    per_row = 2 * s * c + 2 * s * c + 2 * s * mp + 2 * s * mp + s * c  # x, ln, h, hl each out and in; the output
    per_launch = 2 * (3 * c * mp + 2 * mp + c) + 4 * (2 * c + 2 * mp)  # W1, W2, W3 and their biases; LN params
    nbytes = 2 * rows * per_row + launches * per_launch
    return flops.bound_s(rows * mlp_flops(sh), nbytes, peak)
