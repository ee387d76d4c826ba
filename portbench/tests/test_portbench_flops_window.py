"""``metrics/flops_window.py`` against counts worked by hand: Painter ViT-L
at 56×28 with 14×14 windows, and a grid the window does not divide."""

from __future__ import annotations

import json

import pytest

from portbench.metrics import flops, flops_window
from portbench.tests.conftest import ROOT


def painter(**over) -> flops_window.WindowShape:
    m = json.loads((ROOT / "portbench" / "configs" / "painter_vit_l_bf16.json").read_text())["model"]
    return flops_window.WindowShape.from_model(dict(m, **over))


def test_windowed_row_at_painter_vit_l():
    sh = painter()
    s, c, w = 1568, 1024, 14
    assert (sh.window, sh.padded_grid, sh.padded_tokens) == (14, (56, 28), s)
    # scores and PV within 8 windows of 196 tokens, rel terms 2·S·C·(w + w)
    assert flops_window.window_attention_flops(sh) == 4 * s * w * w * c + 2 * s * c * 2 * w == 1_348_730_880
    assert flops_window.window_linear_flops(sh) == flops.linear_flops(sh)  # no pad at 56×28


def test_rows_by_kind():
    # blocks 0–2 on both streams; 2, 5, …, 23 global: 2 + 7 global rows, 4 + 14 windowed
    assert flops_window.rows_by_kind(painter()) == (9, 18)
    assert flops_window.rows_by_kind(painter(window_size=0)) == (27, 0)


def test_painter_tile_by_hand():
    sh = painter()
    s, c = 1568, 1024
    lin = 24 * s * c * c  # 39 460 012 032 a row
    glob = 4 * s * s * c + 2 * s * c * 84  # 10 340 270 080
    win = 1_348_730_880
    embed = 2 * s * 768 * c
    decoder = 2 * 784 * 4096 * 16384 + 2 * 784 * 256 * 9 * 64 * 64 + 2 * 784 * 256 * 64 * 3
    want = 27 * lin + 9 * glob + 18 * win + 2 * embed + decoder
    assert flops_window.forward_flops_per_tile(sh) == want
    assert flops_window.forward_flops_per_tile(sh) == pytest.approx(1.3078e12, rel=1e-4)
    # every block global is SegGPT's count
    assert flops_window.forward_flops_per_tile(painter(window_size=0)) == flops.forward_flops_per_tile(sh)


def test_padded_grid():
    # a 448×224 canvas: grid 28×14, windows of 12 pad it to 36×24 (3×2 windows)
    sh = painter(image_size=[448, 224], window_size=12)
    s, s_pad, c, m, w = 392, 864, 1024, 4096, 12
    assert (sh.padded_grid, sh.padded_tokens) == ((36, 24), s_pad)
    assert flops_window.window_attention_flops(sh) == 4 * s_pad * w * w * c + 2 * s_pad * c * 2 * w
    assert flops_window.window_linear_flops(sh) == 8 * s_pad * c * c + 4 * s * c * m


def test_attention_bound_sums_the_kinds():
    sh = painter()
    tiles = 8
    glob, _ = flops.attention_fwd_bound_s(sh, tiles * 9, 2, flops.PEAK_BF16)
    win, by = flops_window.window_attention_fwd_bound_s(sh, tiles * 18, 2, flops.PEAK_BF16)
    # a windowed row moves a global row's bytes (12.8 MB) for 1/7.7 of its
    # work: its bound is the bytes'
    assert by == "bytes"
    assert win == pytest.approx(2 * (tiles * 18 * 1568 * 4096 + 3 * 1024 + 2 * 27 * 64) / 3.35e12)
    assert flops_window.attention_fwd_bound_s(sh, tiles, 2, flops.PEAK_BF16) == pytest.approx(glob + win)
