"""The fp32 linear products' split-TF32 kernel (``ops/cuda_gemm.py``,
``csrc/gemm_f32x3.cu``) on the CPU: its split transcribed in NumPy, its
tiles and tails transcribed and emulated, the dispatch rule that sends a
product to it, and the cache of the frozen weights' parts.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``); here
its arithmetic is held to an fp64 product, and the model's CPU path to the
plain ``x @ W`` it had, bit for bit."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from beach_seg_tpu_torch.models.seggpt import build_model, load_model_params, tiny_config
from beach_seg_tpu_torch.ops import cuda_gemm

BM, BN, BK, GROUP_M = 128, 128, 32, 8  # gemm_f32x3.cu: a block's tile, a stage's k, row tiles a group

TINY = np.finfo(np.float32).tiny  # the smallest normal


def round_tf32(x: np.ndarray) -> np.ndarray:
    """``tf32x3.cuh``'s ``round_tf32`` on the bit pattern: half a TF32 ulp
    added, the 13 low bits cleared (round to nearest, ties away)."""
    return (x.astype(np.float32).view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``gemm_f32x3.cu``'s ``split_finite``: big rounded to TF32, truncated
    where rounding would overflow; small = x − big in fp32."""
    x = x.astype(np.float32)
    u = x.view(np.uint32)
    r = round_tf32(x)
    overflow = ((r << np.uint32(1)) == np.uint32(0xFF000000)) & ((u << np.uint32(1)) < np.uint32(0xFF000000))
    big = np.where(overflow, u & np.uint32(0xFFFFE000), r).view(np.float32)
    return big, (x - big).astype(np.float32)


def trunc_tf32(x: np.ndarray) -> np.ndarray:
    """What the tensor cores read of a .tf32 operand: the top 19 bits."""
    return (x.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def edge_values() -> np.ndarray:
    """0, ±subnormals, the smallest normal, ±max and its neighbours, values on
    and beside TF32's rounding ties, powers of two."""
    subs = np.array([1, 2, 0x1FFF, 0x1000, 0x3FFFFF, 0x7FFFFF], np.uint32).view(np.float32)
    near_max = np.array([0x7F7FFFFF, 0x7F7FF000, 0x7F7FEFFF, 0x7F7FE000], np.uint32).view(np.float32)
    ties = np.array([0x3F801000, 0x3F800FFF, 0x3F803000, 0x3F802FFF, 0x3F7FF000], np.uint32).view(np.float32)
    vals = np.concatenate([[0.0, TINY, 1.0, 2.0**-60, 2.0**60], subs, near_max, ties]).astype(np.float32)
    return np.concatenate([vals, -vals])


def random_values(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * np.exp2(rng.integers(-40, 40, n))).astype(np.float32)


@pytest.mark.parametrize("which", ["random", "edge"])
def test_split_is_exact_and_matches_the_weights_split(which):
    """big + small == x exactly, for every finite x (±max too, where
    rounding to nearest would overflow); big is a TF32 value; the numpy
    transcription and ``cuda_gemm.split_tf32`` (the weights' parts) agree bit
    for bit."""
    x = random_values(4096) if which == "random" else edge_values()
    big, small = split(x)
    assert np.array_equal(big.astype(np.float64) + small.astype(np.float64), x.astype(np.float64))
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.isfinite(big).all() and np.isfinite(small).all()
    tb, ts = cuda_gemm.split_tf32(torch.from_numpy(x))
    assert np.array_equal(tb.numpy().view(np.uint32), big.view(np.uint32))
    assert np.array_equal(ts.numpy().view(np.uint32), small.view(np.uint32))


def term_errors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|error| of each part of a·b in split TF32, in fp64: small_a·small_b
    (left out), and the TF32 truncation of small in each big·small term
    (the tensor cores read small's top 19 bits); big·big is exact."""
    ba, sa = (p.astype(np.float64) for p in split(a))
    bb, sb = (p.astype(np.float64) for p in split(b))
    return np.stack([
        np.abs(sa * sb),
        np.abs(ba * (sb - trunc_tf32(sb.astype(np.float32)))),
        np.abs(bb * (sa - trunc_tf32(sa.astype(np.float32)))),
    ])


@pytest.mark.parametrize("which", ["random", "edge"])
def test_split_product_terms_within_two_to_minus_21(which):
    """Each part of the split product's error is at most 2^-21 of |a·b|, and
    the three together within 3·2^-21, for operands above 2^-115, whose
    small part (at most 2^-11 of the value) is normal too: random ones, and
    the edge values against random partners (±max, the smallest normal,
    rounding ties). Below that a small part lies among the subnormals, where
    TF32 keeps an absolute resolution of 2^-136 (13 bits above the
    subnormal step): the error stays within 2^-135·|b| there."""
    if which == "random":
        a, b = random_values(4096, 1), random_values(4096, 2)
    else:
        e = edge_values()
        rng = np.random.default_rng(3)
        a = np.repeat(e, 64)
        b = (rng.standard_normal(a.size) * 0.5).astype(np.float32)
    exact = np.abs(a.astype(np.float64) * b.astype(np.float64))
    err = term_errors(a, b)
    normal = np.abs(a) >= 2.0**-115
    bound = 2.0**-21 * exact
    assert (err[:, normal] <= bound[normal]).all()
    total = err.sum(0)
    assert (total[normal] <= 3 * bound[normal]).all()
    sub = ~normal
    assert (total[sub] <= bound[sub] + 2.0**-135 * np.abs(b[sub].astype(np.float64))).all()


def block_tile(pid: int, m: int, n: int) -> tuple[int, int]:
    """``gemm_f32x3_kernel``'s block → (first row, first column): GROUP_M row
    tiles, column tile by column tile."""
    m_tiles, n_tiles = -(-m // BM), -(-n // BN)
    per_group = GROUP_M * n_tiles
    group, in_group = divmod(pid, per_group)
    first = group * GROUP_M
    rows = min(m_tiles - first, GROUP_M)
    return (first + in_group % rows) * BM, (in_group // rows) * BN


def emulate(x: np.ndarray, big: np.ndarray, small: np.ndarray, bias=None) -> np.ndarray:
    """The kernel's product on its tiles: a grid of blocks, each forming its
    128 × 128 tile stage by stage (K in steps of 32, rows past M and k past K
    zeros, as TMA fills them), each stage's three TF32 products in fp64
    (each exact in fp32; the tensor cores' own sum is the one step not
    modelled) rounded into an fp32 stage sum, added on the FP32 units; the
    store masked at M and N."""
    m, k = x.shape
    n = big.shape[0]
    out = np.full((m, n), np.nan, np.float32)
    written = np.zeros((m, n), np.int32)
    kb = -(-k // BK)
    xp = np.zeros((-(-m // BM) * BM, kb * BK), np.float32)
    xp[:m, :k] = x
    bp, sp = (np.zeros((-(-n // BN) * BN, kb * BK), np.float32) for _ in range(2))
    bp[:n, :k], sp[:n, :k] = big, small
    xb, xs = split(xp)
    xb, xs = xb.astype(np.float64), trunc_tf32(xs).astype(np.float64)
    bb, bs = bp.astype(np.float64), trunc_tf32(sp).astype(np.float64)
    for pid in range(-(-m // BM) * -(-n // BN)):
        m0, n0 = block_tile(pid, m, n)
        rs, cs = slice(m0, m0 + BM), slice(n0, n0 + BN)
        acc = np.zeros((BM, BN), np.float32)
        for s in range(kb):
            ks = slice(s * BK, (s + 1) * BK)
            stage = xs[rs, ks] @ bb[cs, ks].T + xb[rs, ks] @ bs[cs, ks].T + xb[rs, ks] @ bb[cs, ks].T
            acc = (acc + stage.astype(np.float32)).astype(np.float32)
        if bias is not None:
            acc = (acc + np.pad(bias, (0, BN))[n0:n0 + BN]).astype(np.float32)
        rows, cols = min(BM, m - m0), min(BN, n - n0)
        out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
        written[m0:m0 + rows, n0:n0 + cols] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("m,k,n", [(300, 96, 200), (128, 32, 128), (77, 100, 260), (1100, 64, 136)],
                         ids=["ragged", "one_tile", "k_tail", "two_groups"])
def test_tiles_and_tails_cover_every_output_once(m, k, n):
    """Ragged M and N on the 128 × 128 block (and K past a stage, and more
    than one group of 8 row tiles): every output written by exactly one
    block, and the emulated product within 4e-6 of the output's scale of an
    fp64 product, the bias added after the sum."""
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    big, small = (p.numpy() for p in cuda_gemm.split_tf32(torch.from_numpy(w).t()))
    got = emulate(x, big, small, bias)
    want = x.astype(np.float64) @ w.astype(np.float64) + bias
    assert np.abs(got - want).max() <= 4e-6 * np.abs(want).max()


def test_dispatch_rule():
    """fp32 on the card with K and N multiples of 4: every ViT-L, ViT-H and
    Painter product takes the kernel; the CPU, bf16, and shapes TMA's rows
    cannot stride (the decoder head's N = 3) stay ``x @ W``."""
    f32, bf16 = torch.float32, torch.bfloat16
    for k, n in [(1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280), (1024, 3072), (4096, 1024), (768, 1280),
                 (5120, 16384), (4096, 16384), (3840, 1280), (512, 1536)]:
        assert cuda_gemm.takes("cuda", f32, k, n) and cuda_gemm.takes("cuda", f32, n, k)
        assert not cuda_gemm.takes("cuda", bf16, k, n)
        assert not cuda_gemm.takes("cpu", f32, k, n)
    for k, n in [(64, 3), (1282, 1280), (1280, 1283), (0, 128)]:
        assert not cuda_gemm.takes("cuda", f32, k, n)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    h, w = cfg.image_size[0] // 2, cfg.image_size[1]
    return [torch.from_numpy(rng.standard_normal((2, h, w, 3)).astype(np.float32)) for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cpu_model_never_reaches_the_wrapper(monkeypatch, dtype):
    """On the CPU (fp32 and bf16) the model's products never call the
    kernel's wrapper, and ``linear`` is ``x @ W (+ b)`` bit for bit."""
    calls = []
    monkeypatch.setattr(cuda_gemm, "linear_f32", lambda *a, **k: calls.append(a))
    cfg = tiny_config(hidden_size=128, num_attention_heads=2, num_hidden_layers=2, merge_index=0,
                      intermediate_hidden_state_indices=(1,))
    model = build_model(cfg, dtype, device="cpu", seed=1)
    x, px, pm, lab = _inputs(cfg)
    leaf = px.clone().requires_grad_(True)
    out = model(x, leaf, pm, labels=lab, decode_query_only=True)
    torch.autograd.grad(out["loss"], leaf)
    assert calls == []
    g = torch.Generator().manual_seed(0)
    a, w, b = torch.randn((2, 5, 64), generator=g), torch.randn((64, 96), generator=g), torch.randn(96, generator=g)
    a, w, b = a.to(dtype), w.to(dtype), b.to(dtype)
    assert torch.equal(cuda_gemm.linear(a, w, b), a @ w + b)
    assert torch.equal(cuda_gemm.linear(a, w), a @ w)


def test_autograd_function_forms_the_input_gradient(monkeypatch):
    """The autograd Function, made to run on the CPU (the wrapper then takes
    its plain version): the forward is ``x @ w + b``, the backward
    ``dy @ wᵀ`` and nothing for the frozen weight and bias; under a profiler
    each of the two calls opens a ``bst.kernel.linear_f32`` range."""
    monkeypatch.setattr(cuda_gemm, "takes", lambda *a: True)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 7, 64), generator=g, requires_grad=True)
    w, b, dy = torch.randn((64, 48), generator=g), torch.randn(48, generator=g), torch.randn((3, 7, 48), generator=g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = cuda_gemm.linear(x, w, b)
        (dx,) = torch.autograd.grad(y, x, dy)
    assert y.grad_fn is not None and "LinearF32" in type(y.grad_fn).__name__
    assert torch.equal(y, x @ w + b)
    assert torch.equal(dx, dy @ w.t())
    assert [e.name for e in prof.events() if e.name.startswith("bst.")] == ["bst.kernel.linear_f32"] * 2


def test_weight_parts_are_made_once_and_anew_after_a_write():
    """A weight's parts are made on first use and kept: a second use makes
    none; ``load_model_params`` (through ``load_state_dict``'s in-place
    copies) and an in-place ``copy_`` make them anew, from the new values;
    each orientation and each view of one base are kept apart."""
    cfg = tiny_config(hidden_size=128, num_attention_heads=2, num_hidden_layers=1, merge_index=0,
                      intermediate_hidden_state_indices=(0,))
    model = build_model(cfg, torch.float32, device="cpu", seed=3)
    att = model.encoder.layers_0.attention
    c = cfg.hidden_size

    def qkv():
        return att.qkv_kernel.reshape(c, 3 * c)

    def expect(parts, w):
        want = cuda_gemm.split_tf32(w)
        assert all(torch.equal(p, q) for p, q in zip(parts, want))

    n0 = cuda_gemm.linear_f32.cache_builds
    fwd = cuda_gemm.weight_parts(qkv(), transposed=True)
    bwd = cuda_gemm.weight_parts(qkv(), transposed=False)
    assert cuda_gemm.linear_f32.cache_builds == n0 + 2
    assert cuda_gemm.weight_parts(qkv(), transposed=True)[0] is fwd[0]
    assert cuda_gemm.weight_parts(qkv(), transposed=False)[0] is bwd[0]
    assert cuda_gemm.linear_f32.cache_builds == n0 + 2
    expect(fwd, qkv().t())
    expect(bwd, qkv())

    model.load_state_dict(load_model_params("random", cfg, device="cpu"))
    fwd2 = cuda_gemm.weight_parts(qkv(), transposed=True)
    assert cuda_gemm.linear_f32.cache_builds == n0 + 3
    assert not torch.equal(fwd2[0], fwd[0])
    expect(fwd2, qkv().t())

    with torch.no_grad():
        att.qkv_kernel.copy_(torch.full_like(att.qkv_kernel, 0.5))
    fwd3 = cuda_gemm.weight_parts(qkv(), transposed=True)
    assert cuda_gemm.linear_f32.cache_builds == n0 + 4
    expect(fwd3, qkv().t())
    assert (fwd3[0] == 0.5).all() and (fwd3[1] == 0).all()

    proj = att.proj_kernel
    cuda_gemm.weight_parts(proj, transposed=True)
    assert cuda_gemm.linear_f32.cache_builds == n0 + 5
    cuda_gemm.weight_parts(qkv(), transposed=True)
    assert cuda_gemm.linear_f32.cache_builds == n0 + 5
