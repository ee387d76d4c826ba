"""The ViT-H slice of the port against the JAX package at head_dim 80, on
seeded numpy inputs: the plain versions and the CPU wrappers of the packed
attention (TPU kernel ``_kernel_packed``) and of the attention backward
(``_bwd_kernel``) against the Pallas kernels in interpret mode, the packed
attention's gradients against ``jax.grad`` of ``fused_attention_merged``, a
3-layer head_dim-80 SegGPT (C=160, 2 heads; JAX takes ``_kernel_packed``,
the port ``cuda_attn.packed_attention``) forward in fp32 and bf16, and
``model_for_config``'s topology for every backbone."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beach_seg_tpu.config import BeachSegConfig as JConf
from beach_seg_tpu.models.seggpt.config import tiny_config as jtiny_config
from beach_seg_tpu.models.seggpt.model import SegGPT as JSegGPT
from beach_seg_tpu.ops import attention as jattn
from beach_seg_tpu.ops import pallas_attn
from beach_seg_tpu.train import loop as jloop
from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt import build_model, from_jax_params, tiny_config
from beach_seg_tpu_torch.ops import attention as tattn
from beach_seg_tpu_torch.ops import cuda_attn
from beach_seg_tpu_torch.train.loop import model_for_config
from tests.torch_train_common import as_jax_fields

BF16_EPS = 2.0**-8
# head_dim 80 as ViT-H has it, at a tiny width and depth
HD80 = dict(hidden_size=160, num_attention_heads=2, num_hidden_layers=3, merge_index=1, intermediate_hidden_state_indices=(1, 2))
FNS = {"plain": (tattn.attention_packed_plain, tattn.attention_bwd_plain), "wrapper": (cuda_attn.attn_packed, cuda_attn.attn_bwd)}


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-9), (np.abs(got - want).max(), np.abs(want).max())


@pytest.fixture(scope="module")
def attn_inputs():
    """q, k, v (B·H, S, 80) from a random qkv, and the rel terms JAX's
    rel_pos_terms makes of q on a 4×8 grid (B=2, 2 heads)."""
    rng = np.random.default_rng(4)
    b, nh, hd, gh, gw = 2, 2, 80, 4, 8
    s = gh * gw
    qkv = rng.standard_normal((b, s, 3, nh * hd)).astype(np.float32)
    q, k, v = qkv.reshape(b, s, 3, nh, hd).transpose(2, 0, 3, 1, 4).reshape(3, b * nh, s, hd)
    rph = rng.standard_normal((2 * gh - 1, hd)).astype(np.float32)
    rpw = rng.standard_normal((2 * gw - 1, hd)).astype(np.float32)
    rh, rw = jattn.rel_pos_terms(jnp.asarray(q), jnp.asarray(rph), jnp.asarray(rpw), (gh, gw), (gh, gw))
    return q, k, v, np.asarray(rh).reshape(b * nh, s, gh), np.asarray(rw).reshape(b * nh, s, gw), nh, hd**-0.5


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_attention_matches_pallas(attn_inputs, dtype, fn):
    """The plain version of _kernel_packed, and attn_packed on CPU tensors,
    against the Pallas kernel: fp32 within 1e-5, the level test_torch_ops
    holds head_dim 64 to; bf16 within two bf16 steps of the output's scale
    (the same rounding points, but fp32 sums in another order can round p
    or the output to the neighbouring bf16)."""
    q, k, v, rh, rw, nh, scale = attn_inputs
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = pallas_attn._pallas_attention_packed(*(jnp.asarray(a, jdt) for a in (q, k, v, rh, rw)), scale, nh, interpret=True)
    got = FNS[fn][0](*(torch.from_numpy(np.array(a)).to(tdt) for a in (q, k, v, rh, rw)), scale, nh)
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (2, 32, 160)
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= (1e-5 if dtype == "float32" else 2 * BF16_EPS * np.abs(want).max()), err


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_matches_pallas(dtype, fn):
    """attention_bwd_plain, and attn_bwd on CPU tensors, against the Pallas
    _bwd_kernel at head_dim 80 (3 heads, 4×8 grid): fp32 within 1e-5 of each
    output's scale; bf16 inputs within one bf16 step (both compute in fp32
    from the same bf16 values and round dq, drh, drw at the end)."""
    rng = np.random.default_rng(5)
    bh, hk, wk, d = 3, 4, 8, 80
    s = hk * wk
    args = [rng.standard_normal(sh).astype(np.float32) for sh in [(bh, s, d)] * 3 + [(bh, s, hk), (bh, s, wk), (bh, s, d)]]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = pallas_attn._pallas_attention_bwd(*(jnp.asarray(a, jdt) for a in args), 0.25, interpret=True)
    got = FNS[fn][1](*(torch.from_numpy(a).to(tdt) for a in args), 0.25)
    for name, g, w, dt in zip(("dq", "dk", "dv", "drh", "drw"), got, want, (tdt, torch.float32, torch.float32, tdt, tdt)):
        assert g.dtype == dt, name
        _close(g, w.astype(jnp.float32), 1e-5 if dtype == "float32" else BF16_EPS)


def test_packed_attention_grads_match_jax_hd80(attn_inputs):
    """Every input's gradient through cuda_attn.packed_attention (on CPU
    tensors: the plain packed forward, the plain backward) against jax.grad
    of fused_attention_merged at head_dim 80: fp32 within 1e-5 of each
    gradient's scale."""
    q, k, v, rh, rw, nh, scale = attn_inputs
    gh, gw = rh.shape[-1], rw.shape[-1]
    wts = np.random.default_rng(6).standard_normal((q.shape[0] // nh, q.shape[1], nh * q.shape[2])).astype(np.float32)
    args = (q, k, v, rh, rw)

    def jloss(*a):
        return jnp.sum(pallas_attn.fused_attention_merged(*a, scale, gh, gw, nh) * wts)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    out = cuda_attn.packed_attention(*leaves, scale, nh)
    got = torch.autograd.grad((out * torch.from_numpy(wts)).sum(), leaves)
    for gg, w in zip(got, want):
        assert gg.dtype == torch.float32
        _close(gg, w, 1e-5)


@pytest.fixture(scope="module")
def model_setup():
    # initializer_range=0.2: at the default 0.02 a random tiny ViT is nearly
    # input-independent, which would make the comparison weak
    over = dict(HD80, initializer_range=0.2)
    jcfg = jtiny_config(**over)
    assert jcfg.head_dim == 80
    h, w = jcfg.image_size[0] // 2, jcfg.image_size[1]
    rng = np.random.default_rng(0)
    inputs = tuple(rng.standard_normal((2, h, w, 3)).astype(np.float32) for _ in range(3))
    params = jax.jit(JSegGPT(jcfg).init)(jax.random.PRNGKey(0), *(a[:1] for a in inputs))["params"]
    return over, jcfg, params, inputs


def _jax_pred(jcfg, dtype, params, inputs, dq):
    model = JSegGPT(jcfg, dtype=dtype)
    fn = jax.jit(lambda p, a, b, c: model.apply({"params": p}, a, b, c, decode_query_only=dq)["pred_masks"])
    return np.asarray(fn(params, *inputs).astype(jnp.float32))


def _port_pred(over, dtype, params, inputs, dq):
    model = build_model(tiny_config(**over), dtype, device="cpu", state=from_jax_params(params, device="cpu"))
    with torch.inference_mode():
        return model(*(torch.from_numpy(a) for a in inputs), decode_query_only=dq)["pred_masks"].numpy()


@pytest.mark.parametrize(
    "dtype,decode_query_only", [("float32", False), ("float32", True), ("bfloat16", True)], ids=["fp32-full", "fp32-query", "bf16-query"]
)
def test_model_hd80_matches_jax(model_setup, dtype, decode_query_only):
    """fp32 within 2e-4, the HF parity level (test_seggpt_parity.py:77);
    bf16 within four bf16 steps of the output's scale, as
    test_torch_model.py holds head_dim 8 and 64 (XLA keeps fused bf16 chains
    in fp32 where PyTorch rounds after each op)."""
    over, jcfg, params, inputs = model_setup
    want = _jax_pred(jcfg, getattr(jnp, dtype), params, inputs, decode_query_only)
    got = _port_pred(over, getattr(torch, dtype), params, inputs, decode_query_only)
    assert got.shape == want.shape == (2, 64, 32, 3)
    assert np.isfinite(got).all()
    tol = 2e-4 if dtype == "float32" else 4 * BF16_EPS * np.abs(want).max()
    assert np.abs(got - want).max() <= tol


def test_kernel_routing_hd80(model_setup, monkeypatch):
    """head_dim 80 takes the packed attention once per layer, never the
    qkv-rel kernel."""
    over, jcfg, params, inputs = model_setup
    calls = {"packed": 0, "qkv_rel": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(cuda_attn, "attn_packed", counted("packed", cuda_attn.attn_packed))
    monkeypatch.setattr(cuda_attn, "attn_qkv_rel", counted("qkv_rel", cuda_attn.attn_qkv_rel))
    _port_pred(over, torch.bfloat16, params, inputs, True)
    assert calls == {"packed": jcfg.num_hidden_layers, "qkv_rel": 0}


@pytest.mark.parametrize(
    "kw,device",
    [(dict(backbone="large"), "meta"), (dict(backbone="huge", compute_dtype="bfloat16"), "meta"),
     (dict(debug=True, inpt_size=64), "cpu")],
    ids=["large", "huge", "debug"],
)
def test_model_for_config_matches_jax(kw, device):
    """The port's model_for_config builds the topology the JAX package's
    does, field by field (full sizes on the meta device: shapes, no
    weights), in the compute dtype the config names."""
    _, want = jloop.model_for_config(JConf(**kw))
    model, got = model_for_config(BeachSegConfig(**kw), device=device)
    assert as_jax_fields(got) == dataclasses.asdict(want)
    assert model.config == got
    assert model.compute_dtype == (torch.bfloat16 if kw.get("compute_dtype") == "bfloat16" else torch.float32)
    assert next(model.parameters()).device.type == device
    n_layers = sum(1 for name, _ in model.encoder.named_children() if name.startswith("layers_"))
    assert n_layers == want.num_hidden_layers


def test_model_for_config_rejects_unknown_backbone():
    """An unknown backbone is not an error: it builds ViT-L, as the JAX
    package's model_for_config does (beach_seg_tpu/train/loop.py:74-75)."""
    _, want = jloop.model_for_config(JConf(backbone="giant"))
    _, got = model_for_config(BeachSegConfig(backbone="giant"), device="meta")
    assert as_jax_fields(got) == dataclasses.asdict(want)
    assert got.hidden_size == 1024 and got.num_hidden_layers == 24
