"""The library's attention entries, ``fused_attention`` (TPU kernel
``_kernel``) and ``fused_attention_qkv`` (``_kernel_qkv``), and the producers
of their rel-term layouts, against the JAX package on the same seeded inputs.
On the CPU the port runs the kernels' plain versions; the JAX side runs its
Pallas kernels in interpret mode, as ``tests/test_pallas_attn.py`` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beach_seg_tpu.ops as jops
import beach_seg_tpu_torch.ops as tops
from beach_seg_tpu.ops import attention as jattn
from beach_seg_tpu.ops import pallas_attn
from beach_seg_tpu_torch.ops import attention as tattn
from beach_seg_tpu_torch.ops import cuda_attn

BF16_EPS = 2.0**-8


def _qkv_geometry(seed=1):
    """``test_pallas_attn.qkv_inputs``' geometry: b=2, two heads of 64, an
    8×4 grid."""
    rng = np.random.default_rng(seed)
    b, nh, hd, gh, gw = 2, 2, 64, 8, 4
    qkv = rng.standard_normal((b, gh * gw, 3 * nh * hd)).astype(np.float32)
    rph = rng.standard_normal((2 * gh - 1, hd)).astype(np.float32)
    rpw = rng.standard_normal((2 * gw - 1, hd)).astype(np.float32)
    return qkv, rph, rpw, b, nh, hd, gh, gw


@pytest.mark.parametrize("which", ["heads", "split", "pack"])
def test_rel_term_layouts_match_jax(which):
    """(B, nH, S, Hk) from ``rel_pos_terms_heads``, the (B, S, nH·64) slots
    from ``rel_pos_terms_split``, and ``pack_rel_terms`` of the former equal
    JAX's within 1e-6 of the terms' scale: fp32 sums of 64 products taken in
    another order differ by a few ulps of the largest term (|terms| reach
    ~25 here, where one ulp is 1.9e-6)."""
    qkv, rph, rpw, b, nh, hd, gh, gw = _qkv_geometry()
    c = nh * hd
    q4 = qkv[..., :c].reshape(b, gh, gw, nh, hd)
    jq4, tq4 = jnp.asarray(q4), torch.from_numpy(q4)
    args_j = (jnp.asarray(rph), jnp.asarray(rpw), (gh, gw), (gh, gw))
    args_t = (torch.from_numpy(rph), torch.from_numpy(rpw), (gh, gw), (gh, gw))
    if which == "heads":
        want = jattn.rel_pos_terms_heads(jq4, *args_j)
        got = tattn.rel_pos_terms_heads(tq4, *args_t)
        assert got[0].shape == (b, nh, gh * gw, gh) and got[1].shape == (b, nh, gh * gw, gw)
    elif which == "split":
        want = jattn.rel_pos_terms_split(jq4, *args_j)
        got = tattn.rel_pos_terms_split(tq4, *args_t)
        assert got[0].shape == got[1].shape == (b, gh * gw, nh * 64)
    else:
        want = jattn.pack_rel_terms(*jattn.rel_pos_terms_heads(jq4, *args_j))
        got = tattn.pack_rel_terms(*tattn.rel_pos_terms_heads(tq4, *args_t))
        # the packed slots are the split layout
        split = tattn.rel_pos_terms_split(tq4, *args_t)
        for a, s in zip(got, split):
            np.testing.assert_array_equal(a.numpy(), s.numpy())
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), w, atol=1e-6 * np.abs(w).max(), rtol=0)


def _fused_inputs(seed=0):
    """``test_pallas_attn.attn_inputs``' geometry: bh=4, an 8×4 grid, d=32,
    the rel terms from ``rel_pos_terms``, and a seeded cotangent."""
    rng = np.random.default_rng(seed)
    bh, gh, gw, d = 4, 8, 4, 32
    s = gh * gw
    q, k, v, g = (rng.standard_normal((bh, s, d)).astype(np.float32) for _ in range(4))
    rph = rng.standard_normal((2 * gh - 1, d)).astype(np.float32)
    rpw = rng.standard_normal((2 * gw - 1, d)).astype(np.float32)
    rel_h, rel_w = jattn.rel_pos_terms(jnp.asarray(q), jnp.asarray(rph), jnp.asarray(rpw), (gh, gw), (gh, gw))
    rel_h = np.asarray(rel_h).reshape(bh, s, gh)
    rel_w = np.asarray(rel_w).reshape(bh, s, gw)
    return (q, k, v, rel_h, rel_w), g, gh, gw, d**-0.5


def _jax_and_port(j_fn, t_fn, inputs, g):
    """Forward output and the input gradients for cotangent g, through the
    JAX entry (jax.vjp) and the port's (torch.autograd.grad)."""
    j_out, vjp = jax.vjp(j_fn, *(jnp.asarray(x) for x in inputs))
    j_grads = vjp(jnp.asarray(g))
    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    t_out = t_fn(*leaves)
    t_grads = torch.autograd.grad(t_out, leaves, torch.from_numpy(g))
    want = [np.asarray(j_out)] + [np.asarray(x) for x in j_grads]
    got = [t_out.detach().numpy()] + [x.numpy() for x in t_grads]
    return want, got


@pytest.fixture(scope="module")
def fused_results():
    inputs, g, gh, gw, scale = _fused_inputs()
    return _jax_and_port(
        lambda *a: pallas_attn.fused_attention(*a, scale, gh, gw),
        lambda *a: cuda_attn.fused_attention(*a, scale, gh, gw),
        inputs, g,
    )


@pytest.mark.parametrize("i,name", enumerate(["out", "dq", "dk", "dv", "drh", "drw"]))
def test_fused_attention_matches_jax(fused_results, i, name):
    """fp32 forward within 1e-5 and each gradient within 1e-5 of its scale
    (``test_pallas_attn.py:35,54``)."""
    want, got = fused_results
    assert got[i].shape == want[i].shape and got[i].dtype == np.float32, name
    err = np.abs(got[i] - want[i]).max()
    tol = 1e-5 if name == "out" else 1e-5 * np.abs(want[i]).max()
    assert err <= tol, (name, err, tol)


@pytest.fixture(scope="module")
def qkv_results():
    qkv, rph, rpw, b, nh, hd, gh, gw = _qkv_geometry()
    q4 = jnp.asarray(qkv[..., : nh * hd].reshape(b, gh, gw, nh, hd))
    rel_h64, rel_w64 = (np.asarray(t) for t in jattn.rel_pos_terms_split(q4, jnp.asarray(rph), jnp.asarray(rpw), (gh, gw), (gh, gw)))
    g = np.random.default_rng(2).standard_normal((b, gh * gw, nh * hd)).astype(np.float32)
    scale = hd**-0.5
    return _jax_and_port(
        lambda *a: pallas_attn.fused_attention_qkv(*a, scale, gh, gw, nh),
        lambda *a: cuda_attn.fused_attention_qkv(*a, scale, gh, gw, nh),
        (qkv, rel_h64, rel_w64), g,
    )


@pytest.mark.parametrize("i,name", enumerate(["out", "dqkv", "drh64", "drw64"]))
def test_fused_attention_qkv_matches_jax(qkv_results, i, name):
    """fp32 forward and the gradients of qkv and both slot arrays within
    1e-5 of each output's scale (``test_pallas_attn.py:191``); the unused
    slots of drh64 / drw64 are zero on both sides."""
    want, got = qkv_results
    assert got[i].shape == want[i].shape and got[i].dtype == np.float32, name
    err = np.abs(got[i] - want[i]).max()
    assert err <= 1e-5 * np.abs(want[i]).max(), (name, err)


@pytest.mark.parametrize("entry", ["fused_attention", "fused_attention_qkv"])
def test_bf16_forward_matches_jax(entry):
    """bf16 inputs: within four bf16 steps of the output's scale (p and the
    output are rounded at the same points; fp32 sums in another order may
    round to the neighbour)."""
    to_j = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    to_t = lambda x: torch.tensor(x).to(torch.bfloat16)  # noqa: E731
    if entry == "fused_attention":
        inputs, _, gh, gw, scale = _fused_inputs(3)
        want = pallas_attn.fused_attention(*map(to_j, inputs), scale, gh, gw)
        got = cuda_attn.fused_attention(*map(to_t, inputs), scale, gh, gw)
    else:
        qkv, rph, rpw, b, nh, hd, gh, gw = _qkv_geometry(4)
        q4 = to_j(qkv)[..., : nh * hd].reshape(b, gh, gw, nh, hd)
        rel = [np.asarray(t.astype(jnp.float32)) for t in jattn.rel_pos_terms_split(q4, to_j(rph), to_j(rpw), (gh, gw), (gh, gw))]
        want = pallas_attn.fused_attention_qkv(to_j(qkv), *map(to_j, rel), hd**-0.5, gh, gw, nh)
        got = cuda_attn.fused_attention_qkv(to_t(qkv), *map(to_t, rel), hd**-0.5, gh, gw, nh)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= 4 * BF16_EPS * np.abs(want).max()


def test_ops_exports_match_jax():
    """The port's ``ops`` package exports the JAX package's ``ops`` names."""
    want = {n for n in vars(jops) if not n.startswith("_") and callable(getattr(jops, n))}
    assert want <= set(tops.__all__)
    assert all(callable(getattr(tops, n)) for n in tops.__all__)


# Pillow's own BICUBIC (uint8 RGB and gray), and the pass-by-pass emulation
# (another method, and a float image that Pillow's branch does not take)
@pytest.mark.parametrize("method,shape,dtype", [
    ("bicubic_pil", (37, 29, 3), np.uint8), ("bicubic_pil", (37, 29), np.uint8),
    ("bilinear_pil", (37, 29, 3), np.uint8), ("bicubic_pil", (37, 29, 3), np.float32),
])
def test_resize_pil_uint8_matches_jax(method, shape, dtype):
    """The exported host resize equals the JAX package's bit for bit: the
    same resize matrices, float64 passes and rounding, or Pillow itself."""
    img = np.random.default_rng(0).integers(0, 256, shape).astype(dtype)
    got = tops.resize_pil_uint8(img, (20, 45), method)
    want = jops.resize_pil_uint8(img, (20, 45), method)
    assert got.dtype == np.uint8 and got.shape == (20, 45, *shape[2:])
    np.testing.assert_array_equal(got, want)
