"""Operations and bytes of SegGPT's algorithmic work, from shapes alone.

Everything here counts what the model needs, whatever implements it, so a
later kernel that stores more, recomputes more or splits its products
another way is still read against the same work:

- per encoder layer and row, at S tokens, width C, MLP width M and a
  (gh, gw) grid: qkv 2·S·C·3C, out projection 2·S·C², MLP 2·2·S·C·M,
  attention 4·S²·C (scores and PV), decomposed rel-pos terms
  2·S·C·(gh + gw);
- the layers up to and including ``merge_index`` run on both streams (pixel
  and mask), so their forward counts two rows a tile;
- the patch embedding of both canvases, and the decoder over the query half
  only (the prompt half of the painted canvas is not asked for);
- a train step's backward computes input gradients only (the backbone is
  frozen; the prompt pixels train): one product the size of each linear
  layer's forward, 8·S²·hd a head for attention (dV, dP, dQ, dK; the
  recompute of S is not counted), the rel terms once more, and only along
  the path from the loss to the prompt pixels: the pixel stream before the
  merge, the query half of the decoder, the prompt half of the pixel
  canvas's patch embedding. Remat's recompute is not model work.

Peaks are NVIDIA's data-sheet rates for one H100 SXM at 700 W, dense.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
PEAK_TF32 = 495e12  # FLOP/s, dense TF32 tensor cores: the peak of an fp32 layer
HBM_BYTES_PER_S = 3.35e12
MFU_PEAK = PEAK_BF16  # every mfu.* divides by the bf16 peak, in both dtypes


@dataclass(frozen=True)
class Shape:
    """The sizes the counts need, read from a configuration file's ``model``."""

    hidden: int
    layers: int
    heads: int
    mlp: int
    patch: int
    canvas: tuple[int, int]  # (2·inpt, inpt): prompt above query
    decoder_hidden: int
    merge_index: int
    n_intermediate: int

    @classmethod
    def from_model(cls, m: dict) -> "Shape":
        c = int(m["hidden_size"])
        return cls(
            hidden=c,
            layers=int(m["num_hidden_layers"]),
            heads=int(m["num_attention_heads"]),
            mlp=int(m.get("mlp_dim") or 4 * c),
            patch=int(m["patch_size"]),
            canvas=(int(m["image_size"][0]), int(m["image_size"][1])),
            decoder_hidden=int(m["decoder_hidden_size"]),
            merge_index=int(m["merge_index"]),
            n_intermediate=len(m["intermediate_hidden_state_indices"]),
        )

    @property
    def grid(self) -> tuple[int, int]:
        return self.canvas[0] // self.patch, self.canvas[1] // self.patch

    @property
    def tokens(self) -> int:
        gh, gw = self.grid
        return gh * gw

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def dual_layers(self) -> int:
        """Layers that run on both streams."""
        return self.merge_index + 1


def attention_flops(sh: Shape) -> float:
    """Scores, PV and the rel terms of one layer on one row."""
    gh, gw = sh.grid
    s, c = sh.tokens, sh.hidden
    return 4.0 * s * s * c + 2.0 * s * c * (gh + gw)


def attention_bwd_flops(sh: Shape) -> float:
    """dV, dP, dQ, dK (8·S²·hd a head) and the rel terms' input gradient."""
    gh, gw = sh.grid
    s, c = sh.tokens, sh.hidden
    return 8.0 * s * s * c + 2.0 * s * c * (gh + gw)


def linear_flops(sh: Shape) -> float:
    """qkv, out projection and the MLP of one layer on one row."""
    s, c = sh.tokens, sh.hidden
    return 2.0 * s * c * 3 * c + 2.0 * s * c * c + 4.0 * s * c * sh.mlp


def embed_flops(sh: Shape) -> float:
    """The patch embedding of one canvas."""
    return 2.0 * sh.tokens * sh.patch * sh.patch * 3 * sh.hidden


def decoder_flops(sh: Shape) -> float:
    """The decoder over the query half: embed, 3×3 conv, head."""
    s_half = sh.tokens // 2
    pixels = s_half * sh.patch * sh.patch
    dh = sh.decoder_hidden
    embed = 2.0 * s_half * sh.n_intermediate * sh.hidden * sh.patch * sh.patch * dh
    return embed + 2.0 * pixels * 9 * dh * dh + 2.0 * pixels * dh * 3


def layer_rows(sh: Shape) -> int:
    """Layer-rows a tile takes in the forward: both streams before the merge."""
    return 2 * sh.dual_layers + (sh.layers - sh.dual_layers)


def forward_flops_per_tile(sh: Shape) -> float:
    """One tile through predict: two canvases embedded, the encoder, the
    query half decoded."""
    per_layer = linear_flops(sh) + attention_flops(sh)
    return 2 * embed_flops(sh) + layer_rows(sh) * per_layer + decoder_flops(sh)


def backward_flops_per_tile(sh: Shape) -> float:
    """Input gradients from the loss to the prompt pixels: every layer on
    the pixel stream's row only, the decoder's query half, the prompt half
    of the pixel canvas's embedding."""
    per_layer = linear_flops(sh) + attention_bwd_flops(sh)
    return embed_flops(sh) / 2 + sh.layers * per_layer + decoder_flops(sh)


def train_flops_per_tile(sh: Shape) -> float:
    return forward_flops_per_tile(sh) + backward_flops_per_tile(sh)


def bound_s(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time the card could take, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_fwd_bound_s(sh: Shape, rows: int, itemsize: int, peak: float) -> tuple[float, str]:
    """One forward of the fused qkv-rel attention over ``rows`` rows: the qkv
    product's output and its bias in, the rel tables in, the heads' output
    out, each byte once, in the layer's dtype."""
    gh, gw = sh.grid
    s, c, hd = sh.tokens, sh.hidden, sh.head_dim
    flops = rows * attention_flops(sh)
    nbytes = itemsize * (rows * s * 3 * c + rows * s * c + 3 * c + (2 * gh - 1 + 2 * gw - 1) * hd)
    return bound_s(flops, nbytes, peak)


def attention_bwd_bound_s(sh: Shape, rows: int, itemsize: int, peak: float) -> tuple[float, str]:
    """One attention backward over ``rows`` rows that need input gradients:
    q, k, v, the output's gradient and the rel terms in; dq, dk, dv and the
    rel terms' gradients out."""
    gh, gw = sh.grid
    s, c = sh.tokens, sh.hidden
    flops = rows * attention_bwd_flops(sh)
    rel = rows * sh.heads * s * (gh + gw)
    nbytes = itemsize * (rows * s * c * 4 + rel + rows * s * c * 3 + rel)
    return bound_s(flops, nbytes, peak)
