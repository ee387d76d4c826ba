"""The split-TF32 ("3xTF32") arithmetic of the port's fp32 attention kernels
(#1 ``csrc/attn_qkv_rel.cu`` and #4 ``csrc/attn_bwd.cu``, the split in
``csrc/tf32x3.cuh``), emulated in numpy and held against the JAX package's
fp32 attention on the same seeded inputs.

Each fp32 operand x is split into big = rna_tf32(x) (round to nearest, ties
away from zero, to 10 stored mantissa bits: ``cvt.rna.tf32.f32``) and small =
x - big, which the tensor cores read truncated to TF32; a product is
small·big + big·small + big·big with fp32 sums. The kernels sum a long
contraction (over keys or queries) in steps of 32 rows on the tensor cores
and add the steps in fp32; the emulation does the same. Built from those
products: the forward of #1 (q + bias, rel terms from the unscaled q on the
FP32 units, q·scale, the k bias as (q·scale)·bk on each row's scores, the
online softmax's function, division after PV, the v bias on the output) and
the five outputs of #4.
Against ``_pallas_attention_qkv_rel`` / ``_pallas_attention_bwd`` in
interpret mode at a tiny grid, and against ``attention_reference`` /
``_reference_flat`` at one ViT-L head (S=1568), where the sums are as long
as on the card: the forward within the 1e-5 the JAX suite holds its own
fp32 kernel to, the backward within 1e-5 of each output's scale. Single
TF32 products miss those bounds at the ViT-L head, so the test tells the
two apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from beach_seg_tpu.ops import attention as jattn
from beach_seg_tpu.ops import pallas_attn

STEP = 32  # rows of a contraction the kernels sum on the tensor cores before an fp32 add
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
