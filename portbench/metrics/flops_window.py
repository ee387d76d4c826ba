"""Operations and bytes of a model whose blocks attend in windows or over
the whole grid (Painter: ViTDet's blocks, ``global_attn_indexes`` global,
the rest in ``window_size``² windows), from shapes alone.

A global block's row is ``metrics/flops.py``'s. A windowed block's row, at
width C on a grid padded to (Hp, Wp) = S_pad tokens, windows of w²:

- attention 4·S_pad·w²·C (scores and PV within each window) and the
  decomposed rel-pos terms 2·S_pad·C·2w;
- qkv 2·S_pad·C·3C and the out projection 2·S_pad·C², since they run on
  the padded windows; the MLP 4·S·C·M on the grid itself.

Padded tokens are counted because the model computes them (at the
benchmark's 56×28 grid and w = 14 there are none). The embedding, the
decoder, the two streams up to ``merge_index`` and the peaks are
``flops.py``'s.
"""

from __future__ import annotations

from dataclasses import dataclass

from portbench.metrics import flops


@dataclass(frozen=True)
class WindowShape(flops.Shape):
    """``flops.Shape`` and the block kinds: the window side (0: every block
    global) and the global blocks."""

    window: int = 0
    global_blocks: tuple[int, ...] = ()

    @classmethod
    def from_model(cls, m: dict) -> "WindowShape":
        base = flops.Shape.from_model(m)
        return cls(**base.__dict__, window=int(m.get("window_size", 0)),
                   global_blocks=tuple(int(i) for i in m.get("global_attn_indexes", ())))

    def is_global(self, i: int) -> bool:
        return self.window == 0 or i in self.global_blocks

    @property
    def padded_grid(self) -> tuple[int, int]:
        gh, gw = self.grid
        w = self.window
        return -(-gh // w) * w, -(-gw // w) * w

    @property
    def padded_tokens(self) -> int:
        hp, wp = self.padded_grid
        return hp * wp


def window_attention_flops(sh: WindowShape) -> float:
    """Scores, PV and the rel terms of one windowed layer on one row."""
    s, c, w = sh.padded_tokens, sh.hidden, sh.window
    return 4.0 * s * w * w * c + 2.0 * s * c * 2 * w


def window_linear_flops(sh: WindowShape) -> float:
    """qkv and the out projection on the padded windows, the MLP on the grid."""
    s_pad, s, c = sh.padded_tokens, sh.tokens, sh.hidden
    return 2.0 * s_pad * c * 3 * c + 2.0 * s_pad * c * c + 4.0 * s * c * sh.mlp


def rows_by_kind(sh: WindowShape) -> tuple[int, int]:
    """Layer-rows a tile takes in the forward, (global, windowed): two rows
    a block up to ``merge_index``."""
    glob = win = 0
    for i in range(sh.layers):
        rows = 2 if i <= sh.merge_index else 1
        if sh.is_global(i):
            glob += rows
        else:
            win += rows
    return glob, win


def forward_flops_per_tile(sh: WindowShape) -> float:
    """One tile through predict: two canvases embedded, the encoder's rows
    by kind, the query half decoded."""
    glob, win = rows_by_kind(sh)
    per_global = flops.linear_flops(sh) + flops.attention_flops(sh)
    per_window = window_linear_flops(sh) + window_attention_flops(sh) if win else 0.0
    return 2 * flops.embed_flops(sh) + glob * per_global + win * per_window + flops.decoder_flops(sh)


def window_attention_fwd_bound_s(sh: WindowShape, rows: int, itemsize: int, peak: float) -> tuple[float, str]:
    """One forward of the qkv-rel attention over ``rows`` windowed rows:
    the padded qkv product and its bias in, each window's rel tables in, the
    heads' output out, each byte once, in the layer's dtype."""
    s, c, hd, w = sh.padded_tokens, sh.hidden, sh.head_dim, sh.window
    nbytes = itemsize * (rows * s * 3 * c + rows * s * c + 3 * c + 2 * (2 * w - 1) * hd)
    return flops.bound_s(rows * window_attention_flops(sh), nbytes, peak)


def attention_fwd_bound_s(sh: WindowShape, tiles: int, itemsize: int, peak: float) -> float:
    """The least time of the attention forwards of ``tiles`` tiles: the
    global rows' bound plus the windowed rows' bound."""
    glob, win = rows_by_kind(sh)
    total = flops.attention_fwd_bound_s(sh, tiles * glob, itemsize, peak)[0] if glob else 0.0
    if win:
        total += window_attention_fwd_bound_s(sh, tiles * win, itemsize, peak)[0]
    return total
