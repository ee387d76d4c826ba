"""The LN→MLP kernels' stages on the CPU: the chain of stage plain versions
(``cuda_mlp.ln_rows`` → ``lin1_gelu`` → ``lin2``, and ``ln_rows`` →
``dual_dh`` → ``dln`` → ``ln_vjp``) equals the whole function written as
one expression with the TPU kernel's rounding points (the split adds no
rounding point), and agrees with the JAX package's
``pallas_mlp.fused_ln_mlp`` and its dx kernel (``_pallas_mlp_dx`` in
interpret mode). N=77 rows of C=256, M=1024, seeded with numpy.

"Equal" is held up to the last bits of a CPU matrix product, which can hang
on how the BLAS blocks the work (buffer alignment, threads) and so change
from run to run: fp32 within FP32_ULPS of max|out|; bf16 equal but for
one-bf16-step differences on at most BF16_SHARE_MAX of the elements. A
bf16 rounding point more than the TPU kernel has fails both limits
(``test_an_extra_rounding_point_fails_the_limits``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beach_seg_tpu.ops import pallas_mlp
from beach_seg_tpu_torch.ops import cuda_mlp

BF16_EPS = 2.0**-8
N, C, M = 77, 256, 1024
EPS = 1e-6
# chain against whole function: a few fp32 ulps of max|out| (fp32), or a
# one-bf16-step difference at no more than 1% of the elements (bf16); an
# extra bf16 rounding point reads ~3e4 ulps, or moves 29-59% of the elements
FP32_ULPS = 8 * 2.0**-24
BF16_SHARE_MAX = 1e-2


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(8)
    return (
        rng.standard_normal((7, N // 7, C)).astype(np.float32),
        (1 + 0.2 * rng.standard_normal(C)).astype(np.float32),
        (0.2 * rng.standard_normal(C)).astype(np.float32),
        (rng.standard_normal((C, M)) / C**0.5).astype(np.float32),
        (0.1 * rng.standard_normal(M)).astype(np.float32),
        (rng.standard_normal((M, C)) / M**0.5).astype(np.float32),
        (0.1 * rng.standard_normal(C)).astype(np.float32),
        rng.standard_normal((7, N // 7, C)).astype(np.float32),
    )


def _torch(inputs, dtype):
    """x, the weights and g in ``dtype``; the LN params in fp32."""
    x, ls, lb, w1, b1, w2, b2, g = (torch.from_numpy(a) for a in inputs)
    dt = getattr(torch, dtype)
    return x.to(dt), ls, lb, w1.to(dt), b1.to(dt), w2.to(dt), b2.to(dt), g.to(dt)


def _whole_fwd(x, ls, lb, w1, b1, w2, b2, approx):
    # pallas_mlp.py:38-50 as one expression
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    ln = ((xf - mean) * torch.rsqrt(var + EPS) * ls.float() + lb.float()).to(dt)
    h = cuda_mlp._gelu_f32(ln.float() @ w1.float() + b1.float(), approx).to(dt)
    return (h.float() @ w2.float() + b2.float()).to(dt)


def _whole_dx(x, ls, lb, w1, b1, w2, g, approx):
    # pallas_mlp.py:173-199 as one expression
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + EPS)
    xhat = (xf - mean) * rstd
    ln = (xhat * ls.float() + lb.float()).to(dt)
    hpre = ln.float() @ w1.float() + b1.float()
    dh = (g.float() @ w2.float().transpose(0, 1)) * cuda_mlp._gelu_grad_f32(hpre, approx)
    dln = dh.to(dt).float() @ w1.float().transpose(0, 1)
    dxhat = dln * ls.float()
    c = x.shape[-1]
    dx = (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).sum(-1, keepdim=True) / c) * rstd
    return dx.to(dt)


def _chain_fwd(x, ls, lb, w1, b1, w2, b2, approx):
    ln, _, _ = cuda_mlp.ln_rows(x, ls, lb, EPS)
    return cuda_mlp.lin2(cuda_mlp.lin1_gelu(ln, w1, b1, approx), w2, b2)


def _chain_dx(x, ls, lb, w1, b1, w2, g, approx):
    ln, mean, rstd = cuda_mlp.ln_rows(x, ls, lb, EPS)
    dh = cuda_mlp.dual_dh(ln, g, w1, b1, w2, approx)
    return cuda_mlp.ln_vjp(cuda_mlp.dln(dh, w1), x, ls, mean, rstd)


def _same_rounding_points(got: torch.Tensor, want: torch.Tensor) -> bool:
    """``got`` equals ``want`` up to the last bits of the products: fp32
    within FP32_ULPS of max|want|; bf16 within one bf16 step of each element
    (the spacing at the larger magnitude), differing at no more than
    BF16_SHARE_MAX of the elements."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if got.dtype == torch.float32:
        return d.max().item() <= FP32_ULPS * w.abs().max().item()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    step = torch.ldexp(torch.ones_like(g), e - 8)  # 2^(floor(log2 a) - 7)
    return bool((d <= step).all()) and (d > 0).float().mean().item() <= BF16_SHARE_MAX


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_chain_is_bitwise_the_whole_function(inputs, dtype, approx):
    x, ls, lb, w1, b1, w2, b2, _ = _torch(inputs, dtype)
    got = _chain_fwd(x, ls, lb, w1, b1, w2, b2, approx)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert _same_rounding_points(got, _whole_fwd(x, ls, lb, w1, b1, w2, b2, approx))
    assert _same_rounding_points(got, cuda_mlp.ln_mlp(x, ls, lb, w1, b1, w2, b2, EPS, approx))


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dx_chain_is_bitwise_the_whole_function(inputs, dtype, approx):
    x, ls, lb, w1, b1, w2, _, g = _torch(inputs, dtype)
    got = _chain_dx(x, ls, lb, w1, b1, w2, g, approx)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert _same_rounding_points(got, _whole_dx(x, ls, lb, w1, b1, w2, g, approx))
    assert _same_rounding_points(got, cuda_mlp.ln_mlp_dx(x, ls, lb, w1, b1, w2, g, EPS, approx))


def _extra_rounding_fwd(x, ls, lb, w1, b1, w2, b2, approx):
    # the chain with Lin1's fp32 output rounded to bf16 before the GELU
    ln, _, _ = cuda_mlp.ln_rows(x, ls, lb, EPS)
    hpre = (ln.float() @ w1.float() + b1.float()).to(torch.bfloat16).float()
    return cuda_mlp.lin2(cuda_mlp._gelu_f32(hpre, approx).to(x.dtype), w2, b2)


def _extra_rounding_dx(x, ls, lb, w1, b1, w2, g, approx):
    # the chain with the fp32 dln rounded to bf16 before the LN VJP
    ln, mean, rstd = cuda_mlp.ln_rows(x, ls, lb, EPS)
    dln = cuda_mlp.dln(cuda_mlp.dual_dh(ln, g, w1, b1, w2, approx), w1)
    return cuda_mlp.ln_vjp(dln.to(torch.bfloat16).float(), x, ls, mean, rstd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["forward", "dx"])
def test_an_extra_rounding_point_fails_the_limits(inputs, which, dtype):
    """The limits above are not blind to what they guard: one bf16 rounding
    point more than the TPU kernel has fails them."""
    x, ls, lb, w1, b1, w2, b2, g = _torch(inputs, dtype)
    if which == "forward":
        args = (x, ls, lb, w1, b1, w2, b2, True)
        got, want = _extra_rounding_fwd(*args), _whole_fwd(*args)
    else:
        args = (x, ls, lb, w1, b1, w2, g, True)
        got, want = _extra_rounding_dx(*args), _whole_dx(*args)
    assert not _same_rounding_points(got, want)


def test_stage_outputs_have_the_tpu_kernels_precisions(inputs):
    """ln, h, dh in x's dtype (bf16), mean / rstd / dln in fp32."""
    x, ls, lb, w1, b1, w2, b2, g = _torch(inputs, "bfloat16")
    ln, mean, rstd = cuda_mlp.ln_rows(x, ls, lb, EPS)
    assert ln.dtype == torch.bfloat16 and ln.shape == x.shape
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == rstd.shape == x.shape[:-1]
    h = cuda_mlp.lin1_gelu(ln, w1, b1, True)
    assert h.dtype == torch.bfloat16 and h.shape == (*x.shape[:-1], M)
    dh = cuda_mlp.dual_dh(ln, g, w1, b1, w2, True)
    assert dh.dtype == torch.bfloat16 and dh.shape == (*x.shape[:-1], M)
    dln = cuda_mlp.dln(dh, w1)
    assert dln.dtype == torch.float32 and dln.shape == x.shape


def _close(got, want, rel):
    got = got.float().numpy().reshape(want.shape)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_chain_matches_jax(inputs, dtype, approx):
    """fp32 within 1e-5 (the JAX suite's own kernel bar); bf16 within two
    bf16 steps of the output's scale (tests/test_torch_ops.py's limits)."""
    x, ls, lb, w1, b1, w2, b2, _ = inputs
    jdt = getattr(jnp, dtype)
    want = pallas_mlp.fused_ln_mlp(jnp.asarray(x, jdt), jnp.asarray(ls), jnp.asarray(lb),
                                   *(jnp.asarray(a, jdt) for a in (w1, b1, w2, b2)), EPS, approx)
    want = np.asarray(want.astype(jnp.float32))
    got = _chain_fwd(*_torch(inputs, dtype)[:7], approx)
    if dtype == "float32":
        assert np.abs(got.numpy() - want).max() < 1e-5
    else:
        _close(got, want, 2 * BF16_EPS)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dx_chain_matches_jax(inputs, dtype, approx):
    """Against ``_pallas_mlp_dx`` in interpret mode: fp32 within 1e-5 of the
    scale, bf16 within two bf16 steps (tests/test_torch_grad.py's limits)."""
    x, ls, lb, w1, b1, w2, _, g = inputs
    jdt = getattr(jnp, dtype)
    want = pallas_mlp._pallas_mlp_dx(
        jnp.asarray(x.reshape(-1, C), jdt), jnp.asarray(ls), jnp.asarray(lb), jnp.asarray(w1, jdt),
        jnp.asarray(b1, jdt), jnp.asarray(w2, jdt), jnp.asarray(g.reshape(-1, C), jdt), EPS, approx, interpret=True,
    )
    want = np.asarray(want.astype(jnp.float32))
    tx, ls_, lb_, tw1, tb1, tw2, _, tg = _torch(inputs, dtype)
    got = _chain_dx(tx, ls_, lb_, tw1, tb1, tw2, tg, approx)
    _close(got, want, 1e-5 if dtype == "float32" else 2 * BF16_EPS)


@pytest.mark.parametrize("stage", ["ln_rows", "lin1_gelu", "lin2", "dual_dh", "dln", "ln_vjp", "ln_mlp", "ln_mlp_dx"])
def test_stage_wrappers_refuse_other_devices(stage):
    """A wrapper runs its plain version only for CPU tensors and launches only
    for CUDA ones; any other device raises before either."""
    t = lambda *shape, dt=torch.bfloat16: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    x, ls, w1, b1, w2 = t(4, C), t(C, dt=torch.float32), t(C, M), t(M), t(M, C)
    args = {
        "ln_rows": (x, ls, ls, EPS), "lin1_gelu": (x, w1, b1, True), "lin2": (t(4, M), w2, t(C)),
        "dual_dh": (x, x, w1, b1, w2, True), "dln": (t(4, M), w1),
        "ln_vjp": (t(4, C, dt=torch.float32), x, ls, t(4, dt=torch.float32), t(4, dt=torch.float32)),
        "ln_mlp": (x, ls, ls, w1, b1, w2, t(C), EPS, True), "ln_mlp_dx": (x, ls, ls, w1, b1, w2, x, EPS, True),
    }[stage]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        getattr(cuda_mlp, stage)(*args)
