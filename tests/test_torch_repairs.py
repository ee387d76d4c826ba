"""Repairs of the port against the JAX package: model_for_config's fallback
to ViT-L for an unknown backbone, the qkv-rel attention's softmax mode from
BEACH_SEG_TPU_ATTN_SOFTMAX / BEACH_SEG_TPU_ATTN_NO_MAX, and the zero padding
that runs head_dim 8 through the head_dim-16 kernel instances (exact on the
plain versions)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beach_seg_tpu.config import BeachSegConfig as JConf
from beach_seg_tpu.models.seggpt.config import tiny_config as jtiny_config
from beach_seg_tpu.models.seggpt.model import SegGPT as JSegGPT
from beach_seg_tpu.ops import pallas_attn
from beach_seg_tpu.train import loop as jloop
from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt import build_model, from_jax_params, tiny_config
from beach_seg_tpu_torch.ops import cuda_attn
from beach_seg_tpu_torch.ops.attention import attention_bwd_plain, attention_fused_plain, attention_packed_plain
from beach_seg_tpu_torch.train.loop import model_for_config
from tests.torch_train_common import as_jax_fields


@pytest.mark.parametrize("backbone", ["base", "large", ""])
def test_unknown_backbone_builds_vit_l(backbone):
    """Any backbone but "huge" is ViT-L in both packages, field by field."""
    _, want = jloop.model_for_config(JConf(backbone=backbone))
    model, got = model_for_config(BeachSegConfig(backbone=backbone), device="meta")
    assert as_jax_fields(got) == dataclasses.asdict(want)
    assert (got.hidden_size, got.num_hidden_layers, got.head_dim) == (1024, 24, 64)
    assert model.config == got


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("no_max", [None, "0", "1"])
@pytest.mark.parametrize("mode", [None, "stable", "clamp", "fast", "other"])
def test_resolve_softmax_matches_jax(monkeypatch, mode, no_max, dtype):
    """The JAX priority: a valid BEACH_SEG_TPU_ATTN_SOFTMAX, then
    BEACH_SEG_TPU_ATTN_NO_MAX (→ fast), then the dtype."""
    for name, value in (("BEACH_SEG_TPU_ATTN_SOFTMAX", mode), ("BEACH_SEG_TPU_ATTN_NO_MAX", no_max)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    want = pallas_attn._resolve_softmax(getattr(jnp, dtype))
    assert cuda_attn.resolve_softmax(getattr(torch, dtype)) == want


# one layer, head_dim 64 (the qkv-rel attention's path in both packages)
_HD64_ONE_LAYER = dict(
    hidden_size=128, num_attention_heads=2, num_hidden_layers=1, merge_index=0, intermediate_hidden_state_indices=(0,),
    initializer_range=0.2,
)


@pytest.mark.parametrize("mode", ["fast", "stable"])
def test_softmax_override_predict_matches_jax(monkeypatch, mode):
    """Under BEACH_SEG_TPU_ATTN_SOFTMAX a 1-layer head_dim-64 fp32 model's
    pred_masks equal JAX's (its Pallas kernels in interpret mode) within
    1e-5: both packages take the mode the variable names."""
    monkeypatch.setenv("BEACH_SEG_TPU_ATTN_SOFTMAX", mode)
    monkeypatch.delenv("BEACH_SEG_TPU_ATTN_NO_MAX", raising=False)
    jcfg = jtiny_config(**_HD64_ONE_LAYER)
    h, w = jcfg.image_size[0] // 2, jcfg.image_size[1]
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal((2, h, w, 3)).astype(np.float32) for _ in range(3)]
    params = jax.jit(JSegGPT(jcfg).init)(jax.random.PRNGKey(0), *(a[:1] for a in inputs))["params"]
    jmodel = JSegGPT(jcfg, dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda p, a, b, c: jmodel.apply({"params": p}, a, b, c)["pred_masks"])(params, *inputs))
    seen = []
    plain = cuda_attn.attn_qkv_rel_plain

    def spy(*args):
        seen.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(cuda_attn, "attn_qkv_rel_plain", spy)
    model = build_model(tiny_config(**_HD64_ONE_LAYER), torch.float32, device="cpu", state=from_jax_params(params, device="cpu"))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in inputs))["pred_masks"].numpy()
    assert seen == [mode]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


def _padded(fn, d, *args):
    """fn on q, k, v (and g) zero-padded from head_dim d to 16, as the
    wrappers pad head_dim 8 for the head_dim-16 kernel instances."""
    return fn(*(cuda_attn.pad_head_dim(t, 16) if i in (0, 1, 2, 5) and isinstance(t, torch.Tensor) else t
                for i, t in enumerate(args)))


@pytest.mark.parametrize("hk,wk", [(3, 5), (7, 4)])
def test_head_dim_8_padding_is_exact_on_plain_versions(hk, wk):
    """Zero columns change no score and add zeros to every sum: #3, #7 and
    #4 on head_dim 8 and on the same inputs padded to 16 (the extra columns
    dropped) agree bit for bit in fp32."""
    rng = np.random.default_rng(3)
    bh, s, d, nh = 6, hk * wk, 8, 3
    q, k, v, g = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(np.float32)) for _ in range(4))
    rh = torch.from_numpy(0.5 * rng.standard_normal((bh, s, hk)).astype(np.float32))
    rw = torch.from_numpy(0.5 * rng.standard_normal((bh, s, wk)).astype(np.float32))
    scale = d**-0.5

    want = attention_packed_plain(q, k, v, rh, rw, scale, nh)
    got = _padded(attention_packed_plain, d, q, k, v, rh, rw, scale, nh)
    got = got.reshape(bh // nh, s, nh, 16)[..., :d].reshape(bh // nh, s, nh * d)
    assert torch.equal(got, want)

    want = attention_fused_plain(q, k, v, rh, rw, scale)
    got = _padded(attention_fused_plain, d, q, k, v, rh, rw, scale)[..., :d]
    assert torch.equal(got, want)

    want = attention_bwd_plain(q, k, v, rh, rw, g, scale)
    got = _padded(attention_bwd_plain, d, q, k, v, rh, rw, g, scale)
    for name, a, w in zip(("dq", "dk", "dv", "drh", "drw"), got, want):
        assert torch.equal(a[..., :w.shape[-1]], w), name
        if name in ("dq", "dk", "dv"):
            assert not a[..., d:].any(), name
