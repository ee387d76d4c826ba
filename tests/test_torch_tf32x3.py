"""The split-TF32 ("3xTF32") arithmetic of the port's fp32 attention kernels
(#1 ``csrc/attn_qkv_rel.cu``, #4 ``csrc/attn_bwd.cu`` and the flash forward
of #3, #6 and #7, ``csrc/attn_flash.cuh``; the split in
``csrc/tf32x3.cuh``), emulated in numpy and held against the JAX package's
fp32 attention on the same seeded inputs.

Each fp32 operand x is split into big = rna_tf32(x) (round to nearest, ties
away from zero, to 10 stored mantissa bits: ``cvt.rna.tf32.f32``) and small =
x - big, which the tensor cores read truncated to TF32; a product is
small·big + big·small + big·big with fp32 sums. The kernels sum a long
contraction (over keys or queries) in steps on the tensor cores and add the
steps in fp32; the emulation does the same. Built from those products: the
forward of #1 (q + bias, rel terms from the unscaled q on the FP32 units,
q·scale, the k bias as (q·scale)·bk on each row's scores, the online
softmax's function, division after PV, the v bias on the output), the five
outputs of #4, and the flash forward (q·kᵀ over the whole head dim in one
accumulator, the rel terms added per score: (round(q·scale)·k + rel_h) +
rel_w, or #7's (q·k)·scale + (rel_h + rel_w); one PV accumulator per
64-key tile added in fp32; division after PV).
Against ``_pallas_attention_qkv_rel`` / ``_pallas_attention_bwd`` /
``_pallas_attention_packed`` / ``_pallas_attention_qkv`` /
``_pallas_attention`` in interpret mode at tiny grids, and against
``attention_reference`` / ``_reference_flat`` at one ViT-L head (S=1568),
where the sums are as long as on the card: the forwards within the 1e-5 the
JAX suite holds its own fp32 kernels to, the backward within 1e-5 of each
output's scale. Single TF32 products miss those bounds at the ViT-L head,
so the tests tell the two apart.

The bf16 qkv-rel kernel adds its rel terms as slot rows times the 0/1
key-to-slot matrix E that ``fill_slots`` builds (``csrc/wgmma.cuh``); a
test here holds that formulation, in the port's torch, to the per-score
lookup of ``attn_qkv_rel_plain`` bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beach_seg_tpu.ops import attention as jattn
from beach_seg_tpu.ops import pallas_attn
from beach_seg_tpu_torch.ops.attention import rel_tables_padded

STEP = 32  # rows of a contraction the kernels sum on the tensor cores before an fp32 add
BK = 64  # keys of the flash forward's tile, whose PV product is one accumulator
VIT_L_GRID = (56, 28)


def round_tf32(x):
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 stored mantissa bits, ties
    away from zero (the carry of the half-ulp add runs into the exponent)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def trunc_tf32(x):
    """The tensor cores' reading of a .tf32 operand: the 13 low bits dropped."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    big = round_tf32(x)
    return big, trunc_tf32(x - big)


def mm3(a, b, step=None):
    """a @ b as the kernels form it: split-TF32 products (the two small terms,
    then big·big), summed on the contraction axis in steps added in fp32."""
    n = a.shape[-1]
    out = None
    for k0 in range(0, n, step or n):
        (ab, asm), (bb, bsm) = split(a[..., k0:k0 + (step or n)]), split(b[..., k0:k0 + (step or n), :])
        part = (asm @ bb + ab @ bsm) + ab @ bb
        out = part if out is None else out + part
    return out


def mm1(a, b, step=None):
    """a @ b in single TF32 products (what the tensor cores give without the split)."""
    return round_tf32(a) @ round_tf32(b)


def _softmax_p(s, softmax):
    if softmax == "stable":
        p = np.exp(s - s.max(-1, keepdims=True))
        return p, p.sum(-1, keepdims=True)
    p = np.exp(np.minimum(s, np.float32(80.0)) if softmax == "clamp" else s)
    return p, p.sum(-1, keepdims=True) + np.float32(1e-30)


def fwd_emulated(qkv, bias, rh_tab, rw_tab, scale, gw, num_heads, softmax="stable", mm=mm3):
    """#1's function: qkv (B, S, 3, C), bias (3, C), tables (Gh, 64, hd) /
    (Gw, 64, hd) → (B, S, C)."""
    b, s, _, c = qkv.shape
    hd = c // num_heads
    gh = s // gw
    heads = lambda x: x.reshape(b, s, num_heads, hd).transpose(0, 2, 1, 3)  # noqa: E731  (B, H, S, hd)
    q, k, v = heads(qkv[:, :, 0] + bias[0]), heads(qkv[:, :, 1]), heads(qkv[:, :, 2])
    bk, bv = bias[1].reshape(num_heads, 1, hd), bias[2].reshape(num_heads, 1, hd)
    rows = np.arange(s)
    rel_h = np.einsum("bnrc,rjc->bnrj", q, rh_tab[rows // gw, :gh])  # from the unscaled q
    rel_w = np.einsum("bnrc,rjc->bnrj", q, rw_tab[rows % gw, :gw])
    qs = q * np.float32(scale)
    scores = ((qs * bk).sum(-1, keepdims=True) + mm(qs, k.swapaxes(-1, -2))) + (rel_h[..., rows // gw] + rel_w[..., rows % gw])
    p, r = _softmax_p(scores, softmax)
    out = mm(p, v, STEP) / r + bv * (p.sum(-1, keepdims=True) / r)
    return out.transpose(0, 2, 1, 3).reshape(b, s, c)


def bwd_emulated(q, k, v, rel_h, rel_w, g, scale, mm=mm3):
    """#4's five outputs: q, k, v, g (BH, S, D), rel_h (BH, S, Hk), rel_w
    (BH, S, Wk) → dq, dk, dv, drh, drw."""
    s, hk, wk = q.shape[1], rel_h.shape[-1], rel_w.shape[-1]
    keys = np.arange(s)
    scores = mm(q, k.swapaxes(-1, -2)) * np.float32(scale) + (rel_h[..., keys // wk] + rel_w[..., keys % wk])
    u = np.exp(scores - scores.max(-1, keepdims=True))
    l = u.sum(-1, keepdims=True)
    p = u * (np.float32(1.0) / l)
    dp = mm(g, v.swapaxes(-1, -2))
    ds = p * (dp - (u * dp).sum(-1, keepdims=True) / l)
    eh = (keys[:, None] // wk == np.arange(hk)).astype(np.float32)  # 0/1 key-to-slot matrices
    ew = (keys[:, None] % wk == np.arange(wk)).astype(np.float32)
    dst = np.ascontiguousarray(ds.swapaxes(-1, -2))
    return (mm(ds, k, STEP) * np.float32(scale), mm(dst, q, STEP) * np.float32(scale),
            mm(np.ascontiguousarray(p.swapaxes(-1, -2)), g, STEP), mm(ds, eh, STEP), mm(ds, ew, STEP))


def _fwd_inputs(b, nh, grid, seed):
    rng = np.random.default_rng(seed)
    gh, gw = grid
    c = nh * 64
    f = lambda *shape, sc=1.0: (sc * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    qkv, bias, rph, rpw = f(b, gh * gw, 3, c), f(3, c, sc=0.1), f(2 * gh - 1, 64, sc=0.1), f(2 * gw - 1, 64, sc=0.1)
    rh, rw = (np.asarray(t) for t in jattn.rel_tables_padded(jnp.asarray(rph), jnp.asarray(rpw), grid, grid))
    return qkv, bias, rph, rpw, rh, rw


def _bwd_inputs(bh, hk, wk, d, seed):
    rng = np.random.default_rng(seed)
    s = hk * wk
    f = lambda *shape, sc=1.0: (sc * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    return f(bh, s, d), f(bh, s, d), f(bh, s, d), f(bh, s, hk, sc=0.5), f(bh, s, wk, sc=0.5), f(bh, s, d)


def test_round_tf32_is_rna():
    """Ten stored mantissa bits; ties away from zero; the carry runs into the exponent."""
    one = np.float32(1.0)
    half_ulp = np.float32(2.0**-11)
    assert round_tf32(np.array([one + half_ulp, -(one + half_ulp)])).tolist() == [1 + 2.0**-10, -(1 + 2.0**-10)]
    assert round_tf32(np.array([one + half_ulp / 2])).tolist() == [1.0]
    assert round_tf32(np.array([np.float32(2.0) - np.float32(2.0**-23)])).tolist() == [2.0]
    x = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    big, small = split(x)
    assert np.all((big.view(np.uint32) & 0x1FFF) == 0) and np.all((small.view(np.uint32) & 0x1FFF) == 0)
    assert np.abs(big - x).max() <= 2.0**-11 * np.abs(x).max()
    assert np.abs((big + small) - x).max() <= 2.0**-21 * np.abs(x).max()


@pytest.mark.parametrize("softmax", ["stable", "clamp", "fast"])
def test_fwd_emulation_matches_pallas_kernel(softmax):
    """Tiny grid (8×4, two heads of 64, nonzero qkv bias) against the Pallas
    kernel in interpret mode, every softmax mode: within 1e-5."""
    qkv, bias, _, _, rh, rw = _fwd_inputs(2, 2, (8, 4), seed=1)
    b, s, _, c = qkv.shape
    want = pallas_attn._pallas_attention_qkv_rel(
        jnp.asarray(qkv.reshape(b, s, 3 * c)), jnp.asarray(rh), jnp.asarray(rw), 0.125, 2,
        interpret=True, softmax=softmax, qkv_bias=jnp.asarray(bias),
    )
    got = fwd_emulated(qkv, bias, rh, rw, 0.125, 4, 2, softmax)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - np.asarray(want)).max() < 1e-5


def _vit_l_head_fwd():
    """One ViT-L head (S=1568) through the emulation (split and single TF32)
    and through attention_reference with the JAX package's rel terms."""
    qkv, bias, rph, rpw, rh, rw = _fwd_inputs(1, 1, VIT_L_GRID, seed=2)
    x = qkv + bias
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    jrh, jrw = jattn.rel_pos_terms(jnp.asarray(q), jnp.asarray(rph), jnp.asarray(rpw), VIT_L_GRID, VIT_L_GRID)
    want = np.asarray(jattn.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jrh, jrw, 0.125))
    got = {name: fwd_emulated(qkv, bias, rh, rw, 0.125, VIT_L_GRID[1], 1, mm=mm) for name, mm in (("tf32x3", mm3), ("tf32", mm1))}
    return got, want


@pytest.mark.parametrize("products,within", [("tf32x3", True), ("tf32", False)])
def test_fwd_emulation_at_vit_l_head(products, within):
    """S=1568 keys: split TF32 within 1e-5 of the fp32 reference; single
    TF32 (~2^-11 a product) misses it."""
    got, want = _vit_l_head_fwd()
    err = np.abs(got[products] - want).max()
    assert (err < 1e-5) == within, err


@pytest.mark.parametrize("bh,hk,wk,d", [(3, 4, 8, 64), (2, 5, 7, 80)])
def test_bwd_emulation_matches_pallas_kernel(bh, hk, wk, d):
    """Tiny grids at both head dims (S=35 not a multiple of 8) against the
    Pallas backward in interpret mode: each output within 1e-5 of its scale."""
    args = _bwd_inputs(bh, hk, wk, d, seed=3)
    want = pallas_attn._pallas_attention_bwd(*(jnp.asarray(a) for a in args), d**-0.5, interpret=True)
    for name, got, w in zip(("dq", "dk", "dv", "drh", "drw"), bwd_emulated(*args, d**-0.5), want):
        w = np.asarray(w)
        assert got.dtype == np.float32 and got.shape == w.shape, name
        assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), name


@pytest.mark.parametrize("products,within", [("tf32x3", True), ("tf32", False)])
def test_bwd_emulation_at_vit_l_head(products, within):
    """One ViT-L head (S=1568, head_dim 64) against the gradients of
    _reference_flat: split TF32 keeps every output within 1e-5 of its scale;
    single TF32 misses it."""
    q, k, v, rel_h, rel_w, g = _bwd_inputs(1, *VIT_L_GRID, 64, seed=4)
    fn = lambda *a: pallas_attn._reference_flat(*a, 0.125, *VIT_L_GRID)  # noqa: E731
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v, rel_h, rel_w)))
    want = vjp(jnp.asarray(g))
    got = bwd_emulated(q, k, v, rel_h, rel_w, g, 0.125, mm=mm3 if products == "tf32x3" else mm1)
    rel = max(np.abs(a - np.asarray(w)).max() / np.abs(np.asarray(w)).max() for a, w in zip(got, want))
    assert (rel <= 1e-5) == within, rel


def flash_fwd_emulated(q, k, v, rel_h, rel_w, scale, prescale, mm=mm3):
    """The fp32 flash forward (#3, #6, #7): q, k, v (BH, S, D), rel_h (BH, S,
    Hk), rel_w (BH, S, Wk) → (BH, S, D). PRESCALE (#3, #6): s =
    (round(q·scale)·k + rel_h) + rel_w; otherwise (#7) s = (q·k)·scale +
    (rel_h + rel_w); p = exp(s - max); out = (P·V in 64-key tiles, the tiles
    added in fp32) / Σp."""
    s, wk = q.shape[1], rel_w.shape[-1]
    keys = np.arange(s)
    rh, rw = rel_h[..., keys // wk], rel_w[..., keys % wk]
    if prescale:
        scores = (mm(q * np.float32(scale), k.swapaxes(-1, -2)) + rh) + rw
    else:
        scores = mm(q, k.swapaxes(-1, -2)) * np.float32(scale) + (rh + rw)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    return mm(p, v, BK) / p.sum(-1, keepdims=True)


def _merge(x, num_heads):
    """(B·H, S, D) → (B, S, H·D)."""
    bh, s, d = x.shape
    return x.reshape(bh // num_heads, num_heads, s, d).transpose(0, 2, 1, 3).reshape(bh // num_heads, s, num_heads * d)


@pytest.mark.parametrize("grid", [(8, 4), (5, 7)])  # S=35: one ragged block
@pytest.mark.parametrize("kernel,d", [("packed", 16), ("packed", 64), ("packed", 80), ("fused", 16), ("fused", 64),
                                      ("fused", 80), ("qkv", 64)])
def test_flash_fwd_emulation_matches_pallas_kernels(kernel, d, grid):
    """The split-TF32 flash forward against ``_kernel_packed`` (merged out),
    ``_kernel`` (head-split out, the scale on the fp32 scores; it normalizes
    p before PV where the port divides after) and ``_kernel_qkv`` (q, k, v
    and 64-slot rel terms read in place) in interpret mode, two heads, at
    every head dim each takes: within 1e-5."""
    gh, gw = grid
    s, nh, b = gh * gw, 2, 2
    rng = np.random.default_rng(5)
    f = lambda *shape, sc=1.0: (sc * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    scale = d**-0.5
    if kernel == "qkv":
        qkv, rph, rpw = f(b, s, 3 * nh * d), f(2 * gh - 1, d, sc=0.1), f(2 * gw - 1, d, sc=0.1)
        q4 = jnp.asarray(qkv[..., : nh * d].reshape(b, gh, gw, nh, d))
        rh64, rw64 = jattn.rel_pos_terms_split(q4, jnp.asarray(rph), jnp.asarray(rpw), grid, grid)
        want = pallas_attn._pallas_attention_qkv(jnp.asarray(qkv), rh64, rw64, scale, gh, gw, nh, interpret=True)
        heads = lambda x: x.reshape(b, s, nh, -1).transpose(0, 2, 1, 3).reshape(b * nh, s, -1)  # noqa: E731
        q, k, v = (heads(qkv[..., i * nh * d:(i + 1) * nh * d]) for i in range(3))
        rel_h, rel_w = heads(np.asarray(rh64))[..., :gh], heads(np.asarray(rw64))[..., :gw]
        got = _merge(flash_fwd_emulated(q, k, v, rel_h, rel_w, scale, True), nh)
    else:
        q, k, v, rel_h, rel_w = f(b * nh, s, d), f(b * nh, s, d), f(b * nh, s, d), f(b * nh, s, gh, sc=0.5), f(b * nh, s, gw, sc=0.5)
        args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(rel_h), jnp.asarray(rel_w), scale)
        if kernel == "packed":
            want = pallas_attn._pallas_attention_packed(*args, nh, interpret=True)
            got = _merge(flash_fwd_emulated(q, k, v, rel_h, rel_w, scale, True), nh)
        else:
            want = pallas_attn._pallas_attention(*args, interpret=True)
            got = flash_fwd_emulated(q, k, v, rel_h, rel_w, scale, False)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - np.asarray(want)).max() < 1e-5


@pytest.mark.parametrize("prescale", [True, False], ids=["prescaled", "post_scaled"])
@pytest.mark.parametrize("products,within", [("tf32x3", True), ("tf32", False)])
def test_flash_fwd_emulation_at_vit_h_head(products, within, prescale):
    """One ViT-H head (S=1568, head_dim 80), both score forms, against
    attention_reference: split TF32 within 1e-5; single TF32 misses it."""
    q, k, v, rel_h, rel_w, _ = _bwd_inputs(1, *VIT_L_GRID, 80, seed=6)
    scale = 80**-0.5
    got = flash_fwd_emulated(q, k, v, rel_h, rel_w, scale, prescale, mm=mm3 if products == "tf32x3" else mm1)
    want = np.asarray(jattn.attention_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                                jnp.asarray(rel_h.reshape(1, *VIT_L_GRID, VIT_L_GRID[0])),
                                                jnp.asarray(rel_w.reshape(1, *VIT_L_GRID, VIT_L_GRID[1])), scale))
    err = np.abs(got - want).max()
    assert (err < 1e-5) == within, err


def _fill_slots_bits(s, hk, wk):
    """``fill_slots`` (``csrc/wgmma.cuh``) transcribed: the bf16 bits of the
    key-to-slot matrix E, (S rounded up to 64, KX), 8 slots of a key at a
    time, 0x3F80 (1.0) where the slot is the key's row kh or its column
    HKP + kw (HKP = Hk and KX = HKP + Wk each rounded up to 16), zero rows
    past S."""
    hkp = -(-hk // 16) * 16
    kx = hkp + -(-wk // 16) * 16
    s_pad = -(-s // 64) * 64
    bits = np.zeros((s_pad, kx), np.uint16)
    for key in range(s_pad):
        kh = key // wk
        kw = hkp + key - kh * wk
        for c0 in range(0, kx, 8):
            for c in range(c0, c0 + 8):
                bits[key, c] = 0x3F80 if key < s and c in (kh, kw) else 0
    return bits


@pytest.mark.parametrize("grid", [(3, 5), (7, 4), (9, 64), (37, 27), (56, 28)])  # ragged; a 64-wide row; crossing chunks; ViT
def test_slot_rows_times_e_equal_the_lookup(grid):
    """The bf16 qkv-rel kernel's rel terms as slot rows (rel_h ‖ rel_w, each
    zero-padded to a multiple of 16) · Eᵀ (E as ``fill_slots`` writes it)
    equal ``attn_qkv_rel_plain``'s per-score lookup rel_h[r, k / gw] +
    rel_w[r, k % gw] exactly in fp32: each score gets two nonzero products,
    both exact."""
    gh, gw = grid
    s, nh, hd = gh * gw, 2, 64
    rng = np.random.default_rng(7)
    qkv4 = torch.from_numpy(rng.standard_normal((1, s, 3, nh * hd), dtype=np.float32)).bfloat16()
    bias = torch.from_numpy(0.1 * rng.standard_normal((3, nh * hd), dtype=np.float32)).bfloat16()
    rph, rpw = (torch.from_numpy(0.1 * rng.standard_normal((2 * g - 1, hd), dtype=np.float32)) for g in grid)
    rh_tab, rw_tab = (t.bfloat16() for t in rel_tables_padded(rph, rpw, grid, grid))
    # the rel terms as attn_qkv_rel_plain forms them: fp32 sums of the biased, unscaled q, rounded
    q5 = (qkv4 + bias)[:, :, 0].reshape(1, gh, gw, nh, hd).permute(0, 3, 1, 2, 4).float()
    rel_h = torch.einsum("bnyxc,ykc->bnyxk", q5, rh_tab.float()).bfloat16().float().reshape(1, nh, s, 64)[..., :gh]
    rel_w = torch.einsum("bnyxc,xkc->bnyxk", q5, rw_tab.float()).bfloat16().float().reshape(1, nh, s, 64)[..., :gw]

    e = torch.from_numpy(_fill_slots_bits(s, gh, gw).view(np.int16)).view(torch.bfloat16).float()
    slots = torch.cat([torch.nn.functional.pad(t, (0, -(-t.shape[-1] // 16) * 16 - t.shape[-1])) for t in (rel_h, rel_w)], -1)
    assert slots.shape[-1] == e.shape[1] and e[s:].abs().sum() == 0 and torch.equal(e[:s].sum(1), torch.full((s,), 2.0))
    via_slots = slots @ e[:s].T
    kidx = torch.arange(s)
    lookup = rel_h[..., kidx // gw] + rel_w[..., kidx % gw]
    assert via_slots.dtype == torch.float32 and torch.equal(via_slots, lookup)
