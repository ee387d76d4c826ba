"""The FLOP and byte counts against values worked by hand at the ViT-L and
ViT-H widths."""

from __future__ import annotations

import json

import pytest

from portbench.metrics import flops
from portbench.tests.conftest import ROOT


def shape(config: str) -> flops.Shape:
    return flops.Shape.from_model(json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())["model"])


@pytest.mark.parametrize("config, c, layers, m, dual", [
    ("seggpt_vit_l_bf16", 1024, 24, 4096, 3),
    ("seggpt_vit_h_fp32", 1280, 32, 5120, 3),
])
def test_per_layer_counts(config, c, layers, m, dual):
    sh = shape(config)
    s, gh, gw = 56 * 28, 56, 28
    assert (sh.tokens, sh.grid, sh.head_dim) == (s, (gh, gw), c // 16)
    # qkv 2·S·C·3C + proj 2·S·C² + MLP 2·2·S·C·M
    assert flops.linear_flops(sh) == 6 * s * c * c + 2 * s * c * c + 4 * s * c * m
    # scores and PV 4·S²·C, rel terms 2·S·C·(gh + gw)
    assert flops.attention_flops(sh) == 4 * s * s * c + 2 * s * c * 84
    # dV, dP, dQ, dK: 8·S²·hd a head (no recompute of S)
    assert flops.attention_bwd_flops(sh) == 8 * s * s * c + 2 * s * c * 84
    # both streams through the layers up to and including merge_index 2
    assert flops.layer_rows(sh) == 2 * dual + (layers - dual)


def test_vit_l_tile_by_hand():
    sh = shape("seggpt_vit_l_bf16")
    s, c = 1568, 1024
    layer = 24 * s * c * c + 4 * s * s * c + 2 * s * c * 84  # 39 460 012 032 + 10 340 270 080
    assert layer == 49_800_282_112
    embed = 2 * s * 768 * c  # one canvas: 16·16·3 pixels a patch
    decoder = 2 * 784 * 4096 * 16384 + 2 * 784 * 256 * 9 * 64 * 64 + 2 * 784 * 256 * 64 * 3
    assert flops.forward_flops_per_tile(sh) == 27 * layer + 2 * embed + decoder
    assert flops.forward_flops_per_tile(sh) == pytest.approx(1.4696e12, rel=1e-4)


def test_vit_h_train_tile_by_hand():
    sh = shape("seggpt_vit_h_fp32")
    s, c = 1568, 1280
    lin = 24 * s * c * c
    fwd_layer = lin + 4 * s * s * c + 2 * s * c * 84
    bwd_layer = lin + 8 * s * s * c + 2 * s * c * 84
    embed = 2 * s * 768 * c
    decoder = 2 * 784 * 5120 * 16384 + 2 * 784 * 256 * 9 * 64 * 64 + 2 * 784 * 256 * 64 * 3
    # forward: 3 layers on both streams, 29 on one; backward: every layer on
    # the pixel stream only, the prompt half of its embedding
    assert flops.forward_flops_per_tile(sh) == 35 * fwd_layer + 2 * embed + decoder
    assert flops.backward_flops_per_tile(sh) == 32 * bwd_layer + embed / 2 + decoder
    assert flops.train_flops_per_tile(sh) == pytest.approx(5.70e12, rel=1e-2)


def test_rooflines_use_fixed_peaks_and_interface_bytes():
    sh = shape("seggpt_vit_h_fp32")
    s, c = 1568, 1280
    t, kind = flops.attention_bwd_bound_s(sh, 1, 4, flops.PEAK_TF32)
    assert kind == "operations"
    assert t == pytest.approx((8 * s * s * c + 2 * s * c * 84) / 495e12)
    sh_l = shape("seggpt_vit_l_bf16")
    t, kind = flops.attention_fwd_bound_s(sh_l, 16, 2, flops.PEAK_BF16)
    assert kind == "operations"
    nbytes = 2 * (16 * 1568 * 3 * 1024 + 16 * 1568 * 1024 + 3 * 1024 + (111 + 55) * 64)
    assert t == pytest.approx(max(16 * (4 * 1568**2 * 1024 + 2 * 1568 * 1024 * 84) / 989e12, nbytes / 3.35e12))
    assert (flops.PEAK_BF16, flops.PEAK_TF32, flops.HBM_BYTES_PER_S, flops.MFU_PEAK) == (989e12, 495e12, 3.35e12, 989e12)
