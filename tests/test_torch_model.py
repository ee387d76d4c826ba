"""The port's SegGPT against the JAX package's on the same flax-initialized
weights and seeded inputs, and the weights bridge (from_jax_params, load_npz).

Two tiny geometries: ``tiny_config()`` (head_dim 8: JAX takes the Pallas
``_kernel_packed``, the port its plain version) and
``tiny_config(hidden_size=128, num_attention_heads=2)`` (head_dim 64: JAX
takes ``_kernel_qkv_rel``, the port ``cuda_attn.attn_qkv_rel``, on CPU
tensors its plain version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beach_seg_tpu.models.seggpt import convert as jconvert
from beach_seg_tpu.models.seggpt.config import tiny_config as jtiny_config
from beach_seg_tpu.models.seggpt.model import SegGPT as JSegGPT
from beach_seg_tpu_torch.models.seggpt import build_model, from_jax_params, load_npz, tiny_config
from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp

GEOMETRIES = {"hd8": {}, "hd64": dict(hidden_size=128, num_attention_heads=2)}
BF16_EPS = 2.0**-8


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def setup(request):
    # initializer_range=0.2: at the default 0.02 a random tiny ViT is nearly
    # input-independent, which would make the comparison weak
    over = dict(GEOMETRIES[request.param], initializer_range=0.2)
    jcfg = jtiny_config(**over)
    h, w = jcfg.image_size[0] // 2, jcfg.image_size[1]
    rng = np.random.default_rng(0)
    x, px, pm = (rng.standard_normal((2, h, w, 3)).astype(np.float32) for _ in range(3))
    params = jax.jit(JSegGPT(jcfg).init)(jax.random.PRNGKey(0), x[:1], x[:1], x[:1])["params"]
    return request.param, over, jcfg, params, (x, px, pm)


def _jax_pred(jcfg, dtype, params, inputs, dq):
    model = JSegGPT(jcfg, dtype=dtype)
    fn = jax.jit(lambda p, a, b, c: model.apply({"params": p}, a, b, c, decode_query_only=dq)["pred_masks"])
    return np.asarray(fn(params, *inputs))


def _port_pred(over, dtype, params, inputs, dq):
    model = build_model(tiny_config(**over), dtype, device="cpu", state=from_jax_params(params, device="cpu"))
    with torch.inference_mode():
        return model(*(torch.from_numpy(a) for a in inputs), decode_query_only=dq)["pred_masks"].numpy()


@pytest.mark.parametrize("decode_query_only", [False, True])
def test_model_fp32_matches_jax(setup, decode_query_only):
    """fp32 within 2e-4, the HF parity level (test_seggpt_parity.py:77)."""
    _, over, jcfg, params, inputs = setup
    want = _jax_pred(jcfg, jnp.float32, params, inputs, decode_query_only)
    got = _port_pred(over, torch.float32, params, inputs, decode_query_only)
    assert got.shape == want.shape == (2, 64, 32, 3)
    assert np.abs(got - want).max() < 2e-4


def test_model_bf16_matches_jax(setup):
    """bf16 (query-only decode, as the predict step runs it): the ops round
    at the same points, but XLA may keep fused elementwise chains in fp32
    where PyTorch rounds after each op, and fp32 sums in another order flip
    single bf16 roundings; allow four bf16 steps of the output's scale."""
    _, over, jcfg, params, inputs = setup
    want = _jax_pred(jcfg, jnp.bfloat16, params, inputs, True)
    got = _port_pred(over, torch.bfloat16, params, inputs, True)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 4 * BF16_EPS * np.abs(want).max()


def test_kernel_routing(setup, monkeypatch):
    """The Block takes the qkv-rel attention entry exactly when head_dim is
    64 and the fused LN→MLP entry exactly under bf16, once per layer."""
    name, over, jcfg, params, inputs = setup
    calls = {"attn": 0, "mlp": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(cuda_attn, "attn_qkv_rel", counted("attn", cuda_attn.attn_qkv_rel))
    monkeypatch.setattr(cuda_mlp, "ln_mlp", counted("mlp", cuda_mlp.ln_mlp))
    layers = jcfg.num_hidden_layers
    for dtype, mlp_calls in ((torch.float32, 0), (torch.bfloat16, layers)):
        calls.update(attn=0, mlp=0)
        _port_pred(over, dtype, params, inputs, True)
        assert calls == {"attn": layers if name == "hd64" else 0, "mlp": mlp_calls}


def test_unported_options_raise(setup):
    """Drop-path needs its keep masks passed in (the feature ensemble is
    tested in tests/test_torch_ensemble.py)."""
    _, over, _, params, inputs = setup
    model = build_model(tiny_config(**over), device="cpu", state=from_jax_params(params, device="cpu"))
    args = [torch.from_numpy(a) for a in inputs]
    with pytest.raises(ValueError, match="drop_masks"):
        model(*args, deterministic=False)


def test_labels_loss_matches_jax(setup):
    """With labels the mask canvas is [prompt_masks ‖ labels] and the model
    returns seggpt_loss; fp32 pred within 2e-4, loss within 1e-5 relative.
    The full decode with head_dim 8, the query-only decode (the train
    step's) with head_dim 64."""
    name, over, jcfg, params, (x, px, pm) = setup
    decode_query_only = name == "hd64"
    labels = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    jout = JSegGPT(jcfg).apply({"params": params}, x, px, pm, labels=labels, decode_query_only=decode_query_only)
    model = build_model(tiny_config(**over), device="cpu", state=from_jax_params(params, device="cpu"))
    with torch.inference_mode():
        out = model(*(torch.from_numpy(a) for a in (x, px, pm)), labels=torch.from_numpy(labels), decode_query_only=decode_query_only)
    assert np.abs(out["pred_masks"].numpy() - np.asarray(jout["pred_masks"])).max() < 2e-4
    want = float(jout["loss"])
    assert abs(float(out["loss"]) - want) <= 1e-5 * abs(want)
    assert model(*(torch.from_numpy(a) for a in (x, px, pm)))["loss"] is None


def test_drop_path_function_matches_jax():
    """drop_path as a function of its mask: x / keep * mask, with the mask
    JAX's _drop_path draws from its key."""
    from beach_seg_tpu.models.seggpt.model import _drop_path as jdrop
    from beach_seg_tpu_torch.models.seggpt.model import drop_path

    x = np.random.default_rng(0).standard_normal((6, 4, 4, 8)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    for rate in (0.0, 0.3, 0.9):
        want = np.asarray(jdrop(jnp.asarray(x), rate, False, key))
        mask = np.array(jax.random.bernoulli(key, 1.0 - rate, (6, 1, 1, 1))).reshape(6)
        got = drop_path(torch.from_numpy(x), rate, torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(got, want)


def test_drop_path_model_matches_jax(setup, monkeypatch):
    """The whole model with drop-path on, both sides on the same keep masks:
    JAX's _drop_path is swapped (in this test process) for one that takes
    the masks in call order, as the port's Encoder takes them (attention
    branch, then MLP branch, layer by layer, 2B rows up to merge_index)."""
    import beach_seg_tpu.models.seggpt.model as jmodel_mod
    from beach_seg_tpu_torch.models.seggpt.model import drop_path_rates

    _, over, jcfg, params, (x, px, pm) = setup
    over = dict(over, drop_path_rate=0.4)
    jcfg = jtiny_config(**over)
    model = build_model(tiny_config(**over), device="cpu", state=from_jax_params(params, device="cpu"))
    rng = np.random.default_rng(7)
    b = x.shape[0]
    masks = []
    for i, rate in enumerate(drop_path_rates(model.config)):
        n = 2 * b if jcfg.merge_index >= i else b
        masks.append(tuple(rng.random(n) < 1.0 - rate for _ in range(2)) if rate > 0 else (None, None))
    order = iter([m for pair in masks for m in pair if m is not None])

    def fixed_drop(xx, rate, deterministic, rng_key):
        if deterministic or rate == 0.0:
            return xx
        m = jnp.asarray(next(order)).astype(xx.dtype).reshape((xx.shape[0],) + (1,) * (xx.ndim - 1))
        return xx / (1.0 - rate) * m

    monkeypatch.setattr(jmodel_mod, "_drop_path", fixed_drop)
    want = JSegGPT(jcfg).apply(
        {"params": params}, x, px, pm, deterministic=False, rngs={"droppath": jax.random.PRNGKey(0)}, decode_query_only=True
    )["pred_masks"]
    tmasks = [tuple(None if m is None else torch.from_numpy(m) for m in pair) for pair in masks]
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in (x, px, pm)), deterministic=False, drop_masks=tmasks, decode_query_only=True)
        plain = model(*(torch.from_numpy(a) for a in (x, px, pm)), decode_query_only=True)
    assert np.abs(got["pred_masks"].numpy() - np.asarray(want)).max() < 2e-4
    assert np.abs(got["pred_masks"].numpy() - plain["pred_masks"].numpy()).max() > 1e-3  # the masks did something


def test_load_npz_equals_from_jax_params(setup, tmp_path):
    """The port's npz reader gives the state the bridge gives, for the
    current (C, 3, C) layout and the legacy (C, 3C) one."""
    _, over, jcfg, params, _ = setup
    want = from_jax_params(params, device="cpu")
    path = tmp_path / "params.npz"
    jconvert.save_params(params, path, jcfg)
    got = load_npz(path, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)

    legacy = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a).reshape(a.shape[0], -1) if p[-1].key == "qkv_kernel"
        else (np.asarray(a).reshape(-1) if p[-1].key == "qkv_bias" else np.asarray(a)),
        params,
    )
    jconvert.save_params(legacy, tmp_path / "legacy.npz")
    got = load_npz(tmp_path / "legacy.npz", device="cpu")
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
