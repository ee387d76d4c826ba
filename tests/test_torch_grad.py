"""Gradients of the port's kernel entries against the JAX package's custom
VJPs, the plain versions of the two backward kernels against the Pallas
kernels (interpret mode on the CPU), and the port's AdamW and lr schedule
against optax."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from beach_seg_tpu.config import BeachSegConfig as JConf
from beach_seg_tpu.ops import attention as jattn
from beach_seg_tpu.ops import pallas_attn, pallas_mlp
from beach_seg_tpu.train import prompt_tuner as jtuner
from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.ops import attention as tattn
from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp
from beach_seg_tpu_torch.train import prompt_tuner as ttuner

BF16_EPS = 2.0**-8


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-9), (np.abs(got - want).max(), np.abs(want).max())


@pytest.fixture(scope="module")
def bwd_inputs():
    rng = np.random.default_rng(0)
    bh, hk, wk, d = 3, 4, 8, 16
    s = hk * wk
    shapes = [(bh, s, d)] * 3 + [(bh, s, hk), (bh, s, wk), (bh, s, d)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_plain_matches_pallas(bwd_inputs, dtype):
    """fp32 within 1e-5 of each output's scale. bf16 inputs: both compute in
    fp32 from the same bf16 values and round dq, drh, drw to bf16 at the
    end, so one bf16 step of the scale."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = pallas_attn._pallas_attention_bwd(*(jnp.asarray(a, jdt) for a in bwd_inputs), 0.25, interpret=True)
    got = tattn.attention_bwd_plain(*(torch.from_numpy(a).to(tdt) for a in bwd_inputs), 0.25)
    want_dtypes = (tdt, torch.float32, torch.float32, tdt, tdt)
    for g, w, dt in zip(got, want, want_dtypes):
        assert g.dtype == dt
        _close(g, w.astype(jnp.float32), 1e-5 if dtype == "float32" else BF16_EPS)


@pytest.fixture(scope="module")
def mlp_inputs():
    rng = np.random.default_rng(3)
    n, c, m = 48, 64, 256
    return (
        rng.standard_normal((2, n // 2, c)).astype(np.float32),
        (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
        (0.2 * rng.standard_normal(c)).astype(np.float32),
        (0.1 * rng.standard_normal((c, m))).astype(np.float32),
        (0.1 * rng.standard_normal(m)).astype(np.float32),
        (0.1 * rng.standard_normal((m, c))).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
        rng.standard_normal((2, n // 2, c)).astype(np.float32),
    )


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_mlp_dx_plain_matches_pallas(mlp_inputs, dtype, approx):
    """fp32 within 1e-5 of the scale; bf16 within two bf16 steps (LN and dh
    are rounded at the same points, fp32 sums in another order may round
    to the neighbour)."""
    x, ls, lb, w1, b1, w2, _, g = mlp_inputs
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    c = x.shape[-1]
    want = pallas_mlp._pallas_mlp_dx(
        jnp.asarray(x.reshape(-1, c), jdt), jnp.asarray(ls), jnp.asarray(lb), jnp.asarray(w1, jdt),
        jnp.asarray(b1, jdt), jnp.asarray(w2, jdt), jnp.asarray(g.reshape(-1, c), jdt), 1e-6, approx, interpret=True,
    )
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    got = cuda_mlp.ln_mlp_dx(t(x), torch.from_numpy(ls), torch.from_numpy(lb), t(w1), t(b1), t(w2), t(g), 1e-6, approx)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    _close(got.reshape(-1, c), want.astype(jnp.float32), 1e-5 if dtype == "float32" else 2 * BF16_EPS)


def test_ln_mlp_autograd_matches_jax_grad(mlp_inputs):
    """Every cotangent of the port's fused_ln_mlp (dx from the dx kernel's
    plain version, the rest by autograd of the plain forward) against
    jax.grad of fused_ln_mlp's custom VJP, fp32 within 1e-5."""
    x, ls, lb, w1, b1, w2, b2, g = mlp_inputs
    args = (x, ls, lb, w1, b1, w2, b2)

    def jloss(*a):
        return jnp.sum(pallas_mlp.fused_ln_mlp(*a, 1e-6, False) * g)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = cuda_mlp.fused_ln_mlp(*leaves, 1e-6, False)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for gg, w in zip(got, want):
        _close(gg, w, 1e-5)
    # only dx asked for: the weight cotangents are not computed
    xx = torch.from_numpy(x).requires_grad_(True)
    (dx,) = torch.autograd.grad((cuda_mlp.fused_ln_mlp(xx, *map(torch.from_numpy, args[1:]), 1e-6, False) * torch.from_numpy(g)).sum(), xx)
    _close(dx, want[0], 1e-5)


@pytest.fixture(scope="module")
def qkv_inputs():
    rng = np.random.default_rng(1)
    b, nh, hd, gh, gw = 2, 2, 64, 8, 4
    c = nh * hd
    return (
        rng.standard_normal((b, gh * gw, 3, c)).astype(np.float32),
        rng.standard_normal((3, c)).astype(np.float32),
        rng.standard_normal((2 * gh - 1, hd)).astype(np.float32),
        rng.standard_normal((2 * gw - 1, hd)).astype(np.float32),
        nh, hd, gh, gw,
    )


def test_qkv_rel_attention_grads_match_jax(qkv_inputs):
    """Gradients w.r.t. qkv, the bias and both rel-pos tables (through the
    padded-table lookup) of the port's qkv_rel_attention against jax.grad of
    fused_attention_qkv_rel, as test_pallas_attn.py:213-236 holds the JAX
    kernel to its reference: fp32 within 1e-5 of each gradient's scale."""
    qkv, bias, rph, rpw, nh, hd, gh, gw = qkv_inputs
    wts = np.random.default_rng(9).standard_normal((qkv.shape[0], gh * gw, nh * hd)).astype(np.float32)

    def jloss(qkv, bias, rph, rpw):
        rh, rw = jattn.rel_tables_padded(rph, rpw, (gh, gw), (gh, gw))
        return jnp.sum(pallas_attn.fused_attention_qkv_rel(qkv, bias, rh, rw, hd**-0.5, gw, nh) * wts)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (qkv, bias, rph, rpw)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (qkv, bias, rph, rpw)]
    rh, rw = tattn.rel_tables_padded(leaves[2], leaves[3], (gh, gw), (gh, gw))
    out = cuda_attn.qkv_rel_attention(leaves[0], leaves[1], rh, rw, hd**-0.5, gw, nh)
    got = torch.autograd.grad((out * torch.from_numpy(wts)).sum(), leaves)
    for gg, w in zip(got, want):
        _close(gg, w, 1e-5)


def test_qkv_rel_attention_bf16_grad_matches_jax(qkv_inputs):
    """bf16 qkv gradient (frozen bias and tables, as in prompt tuning):
    dq/dk/dv rounded at the same points, the rel-term folds in bf16; eight
    bf16 steps of the scale."""
    qkv, bias, rph, rpw, nh, hd, gh, gw = qkv_inputs
    bf = jnp.bfloat16
    rh, rw = jattn.rel_tables_padded(jnp.asarray(rph, bf), jnp.asarray(rpw, bf), (gh, gw), (gh, gw))
    wts = np.random.default_rng(9).standard_normal((qkv.shape[0], gh * gw, nh * hd)).astype(np.float32)

    def jloss(q):
        out = pallas_attn.fused_attention_qkv_rel(q, jnp.asarray(bias, bf), rh, rw, hd**-0.5, gw, nh)
        return jnp.sum(out.astype(jnp.float32) * wts)

    want = jax.grad(jloss)(jnp.asarray(qkv, bf)).astype(jnp.float32)
    trh, trw = tattn.rel_tables_padded(torch.from_numpy(rph).bfloat16(), torch.from_numpy(rpw).bfloat16(), (gh, gw), (gh, gw))
    leaf = torch.from_numpy(qkv).bfloat16().requires_grad_(True)
    out = cuda_attn.qkv_rel_attention(leaf, torch.from_numpy(bias).bfloat16(), trh, trw, hd**-0.5, gw, nh)
    (got,) = torch.autograd.grad((out.float() * torch.from_numpy(wts)).sum(), leaf)
    assert got.dtype == torch.bfloat16
    _close(got, want, 8 * BF16_EPS)


def test_packed_attention_grads_match_jax(qkv_inputs):
    """cuda_attn.packed_attention (head_dim ≠ 64 in the model; on CPU tensors
    the plain versions of the packed and backward kernels) against jax.grad
    of fused_attention_merged, whose backward is the same Pallas
    _bwd_kernel."""
    qkv, _, rph, rpw, nh, hd, gh, gw = qkv_inputs
    b, s = qkv.shape[:2]
    split = qkv.reshape(b, s, 3, nh, hd).transpose(2, 0, 3, 1, 4).reshape(3, b * nh, s, hd)
    q, k, v = split
    jrh, jrw = jattn.rel_pos_terms(jnp.asarray(q), jnp.asarray(rph), jnp.asarray(rpw), (gh, gw), (gh, gw))
    rel_h, rel_w = np.asarray(jrh).reshape(b * nh, s, gh), np.asarray(jrw).reshape(b * nh, s, gw)
    wts = np.random.default_rng(2).standard_normal((b, s, nh * hd)).astype(np.float32)
    args = (q, k, v, rel_h, rel_w)

    def jloss(*a):
        return jnp.sum(pallas_attn.fused_attention_merged(*a, hd**-0.5, gh, gw, nh) * wts)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    out = cuda_attn.packed_attention(*leaves, hd**-0.5, nh)
    got = torch.autograd.grad((out * torch.from_numpy(wts)).sum(), leaves)
    for gg, w in zip(got, want):
        _close(gg, w, 1e-5)


@pytest.mark.parametrize("warmup", [0, 2])
def test_lr_schedule_matches_jax(warmup):
    kw = dict(epochs=6, warmup_epochs=warmup, lr=1e-3, init_lr=5e-4, min_lr=1e-4, batch_size=4)
    want = jtuner.lr_schedule(JConf(**kw), steps_per_epoch=3)
    got = ttuner.lr_schedule(BeachSegConfig(**kw), steps_per_epoch=3)
    for n in range(30):
        assert got(n) == pytest.approx(float(want(n)), rel=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_matches_optax(accum):
    """Three updates (six gradients under grad_accum_steps=2) against
    optax.adamw(schedule) (wrapped in MultiSteps), on gradients well above
    eps: moments within 1e-6 of their scale, updates and params within
    3e-5: optax's update runs as one fused XLA program whose vectorized
    sqrt and division differ from the same ops run one by one (IEEE, as
    here) by up to 1e-5 of the update, measured."""
    conf_kw = dict(epochs=3, lr=1e-2, init_lr=1e-2, min_lr=1e-3, batch_size=2, grad_accum_steps=accum)
    jopt = jtuner.make_optimizer(JConf(**conf_kw), steps_per_epoch=1)
    topt = ttuner.make_optimizer(BeachSegConfig(**conf_kw), steps_per_epoch=1)
    rng = np.random.default_rng(0)
    p0 = rng.random((4, 5)).astype(np.float32)
    jp, tp = jnp.asarray(p0), torch.from_numpy(p0.copy())
    jst, tst = jopt.init(jp), topt.init(tp)
    for _ in range(3 * accum):
        g = (rng.standard_normal((4, 5)) * 1e-2).astype(np.float32)
        ju, jst = jopt.update(jnp.asarray(g), jst, jp)
        tu, tst = topt.update(torch.from_numpy(g), tst, tp)
        if np.abs(np.asarray(ju)).max() > 0:
            _close(tu, ju, 3e-5)
        else:  # a MultiSteps step between updates
            np.testing.assert_array_equal(tu.numpy(), 0.0)
        jp, tp = optax.apply_updates(jp, ju), tp + tu
    _close(tp, jp, 3e-5)
    inner = jst.inner_opt_state if accum > 1 else jst
    _close(tst["mu"], inner[0].mu, 1e-6)
    _close(tst["nu"], inner[0].nu, 1e-6)
    assert tst["count"] == int(inner[0].count) == 3
