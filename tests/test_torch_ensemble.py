"""The port's feature ensemble (``SegGPT.forward(feature_ensemble=True,
ensemble_groups=G)``, ``model.ensemble_mean``) against the JAX package's
model and HF's ``SegGpt``, on the same weights and seeded numpy inputs.

``tiny_config`` has ``merge_index`` 1 of 6 layers, so every forward runs all
three branches: the pre-merge per-stream mean (layer 0), HF's both-stream
mean at ``merge_index`` (layer 1) and the post-merge mean (layers 2-5).
Queries repeat within each of the G groups of P prompts, as the zero-shot
engine lays them out (rows group-major).

Tolerances: fp32 within 1e-5 of the output's scale (readings ≤ 1.4e-6); bf16
within test_torch_model.py's four bf16 steps of the output's scale on
``tiny_config`` (head_dim 8; readings ≤ 3.6 steps). At head_dim 64 with 4-6
rows the bf16 difference reaches ~4.4 steps whether the ensemble is on or
off: the model's bf16 rounding order (XLA keeps fused chains in fp32), not
the ensemble, so the head_dim-64 geometry is held to JAX in fp32 only (one
case: each (G, P) is a JAX compile of its own)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beach_seg_tpu.models.seggpt.config import tiny_config as jtiny_config
from beach_seg_tpu.models.seggpt.model import SegGPT as JSegGPT
from beach_seg_tpu_torch.models.seggpt import build_model, from_jax_params, tiny_config
from beach_seg_tpu_torch.models.seggpt import model as pmodel
from beach_seg_tpu_torch.models.seggpt.convert import config_from_hf, convert_torch_state_dict
from tests.test_seggpt_parity import make_torch_model

BF16_EPS = 2.0**-8
FP32_REL = 1e-5
GEOMETRIES = {"hd8": {}, "hd64": dict(hidden_size=128, num_attention_heads=2)}


@functools.lru_cache(maxsize=None)
def _geometry(name: str):
    over = dict(GEOMETRIES[name], initializer_range=0.2)
    jcfg = jtiny_config(**over)
    x = np.zeros((1, jcfg.image_size[0] // 2, jcfg.image_size[1], 3), np.float32)
    params = jax.jit(JSegGPT(jcfg).init)(jax.random.PRNGKey(0), x, x, x)["params"]
    return name, over, jcfg, params


@pytest.fixture(params=sorted(GEOMETRIES))
def setup(request):
    return _geometry(request.param)


def _inputs(jcfg, g: int, p: int, seed: int):
    """G queries each repeated over its P prompts, group-major: (G·P, h, w, 3) ×3."""
    rng = np.random.default_rng(seed)
    h, w = jcfg.image_size[0] // 2, jcfg.image_size[1]
    q = np.repeat(rng.standard_normal((g, h, w, 3)).astype(np.float32), p, axis=0)
    pi, pm = (rng.standard_normal((g * p, h, w, 3)).astype(np.float32) for _ in range(2))
    return q, pi, pm


def _port(over, dtype, params, inputs, **kw):
    model = build_model(tiny_config(**over), dtype, device="cpu", state=from_jax_params(params, device="cpu"))
    with torch.inference_mode():
        return model(*(torch.from_numpy(a) for a in inputs), **kw)["pred_masks"].numpy()


@pytest.mark.parametrize("geometry, dtype, g, p", [
    *(("hd8", dtype, g, p) for dtype in ("float32", "bfloat16") for g in (1, 2) for p in (2, 3)),
    ("hd64", "float32", 2, 3),  # the qkv-rel attention's plain version under the ensemble
])
def test_ensemble_matches_jax(geometry, dtype, g, p):
    _, over, jcfg, params = _geometry(geometry)
    inputs = _inputs(jcfg, g, p, seed=10 * g + p)
    jmodel = JSegGPT(jcfg, dtype=getattr(jnp, dtype))
    fn = jax.jit(lambda prm, a, b, c: jmodel.apply({"params": prm}, a, b, c, feature_ensemble=True,
                                                   decode_query_only=True, ensemble_groups=g)["pred_masks"])
    want = np.asarray(fn(params, *inputs))
    got = _port(over, getattr(torch, dtype), params, inputs, feature_ensemble=True, decode_query_only=True,
                ensemble_groups=g)
    off = _port(over, getattr(torch, dtype), params, inputs, decode_query_only=True)
    assert np.isfinite(got).all() and got.shape == want.shape
    scale = np.abs(want).max()
    tol = FP32_REL if dtype == "float32" else 4 * BF16_EPS
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale
    assert np.abs(off - got).max() > 2 * tol * scale  # the ensemble moves the output beyond the limit


@pytest.mark.parametrize("p", [2, 3])
def test_ensemble_matches_hf_seggpt(p):
    """HF ``SegGpt`` with ``feature_ensemble=True`` (one group: HF's only
    layout), its weights converted as the loaders convert them; the limit is
    the JAX package's HF parity level (test_seggpt_parity.py)."""
    tmodel, hf_cfg = make_torch_model(jtiny_config())
    cfg = config_from_hf(hf_cfg)
    state = from_jax_params(convert_torch_state_dict(tmodel.state_dict(), cfg), device="cpu")
    q, pi, pm = _inputs(cfg, 1, p, seed=p)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    with torch.no_grad():
        want = tmodel(pixel_values=nchw(q), prompt_pixel_values=nchw(pi), prompt_masks=nchw(pm),
                      feature_ensemble=True).pred_masks.numpy().transpose(0, 2, 3, 1)
    model = build_model(tiny_config(), device="cpu", state=state)
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in (q, pi, pm)), feature_ensemble=True)["pred_masks"].numpy()
    assert np.abs(got - want).max() < 2e-4, np.abs(got - want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ensemble_equals_the_per_group_runs(setup, dtype):
    """G=3 groups of P=2 in one batch equal three G=1 runs: the means stay
    within each group. The batch sizes differ, so the CPU BLAS blocks the
    products differently: fp32 within FP32_REL of the scale (readings ≤
    1.0e-6), bf16 within one step."""
    _, over, jcfg, params = setup
    g, p = 3, 2
    q, pi, pm = _inputs(jcfg, g, p, seed=4)
    dt = getattr(torch, dtype)
    got = _port(over, dt, params, (q, pi, pm), feature_ensemble=True, ensemble_groups=g, decode_query_only=True)
    want = np.concatenate([
        _port(over, dt, params, (q[i * p:(i + 1) * p], pi[i * p:(i + 1) * p], pm[i * p:(i + 1) * p]),
              feature_ensemble=True, decode_query_only=True)
        for i in range(g)
    ])
    tol = FP32_REL if dtype == "float32" else BF16_EPS
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max() / np.abs(want).max()


def test_ensemble_off_runs_the_plain_block(setup, monkeypatch):
    """With ``feature_ensemble=False`` the ensemble code never runs and the
    output is bitwise the default forward's, whatever ``ensemble_groups``."""
    _, over, jcfg, params = setup
    inputs = _inputs(jcfg, 2, 2, seed=5)
    want = _port(over, torch.bfloat16, params, inputs, decode_query_only=True)

    def never(*a, **k):
        raise AssertionError("ensemble_mean ran with the ensemble off")

    monkeypatch.setattr(pmodel, "ensemble_mean", never)
    for groups in (1, 2):
        got = _port(over, torch.bfloat16, params, inputs, decode_query_only=True, feature_ensemble=False,
                    ensemble_groups=groups)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("branch, cond, streams", [("pre_merge", 2, 2), ("at_merge", 1, 2), ("post_merge", 1, 1)])
def test_ensemble_mean_branches(branch, cond, streams):
    """Each branch's means against a loop over the rows they span; a group
    too small for its cond passes through unchanged."""
    rng = np.random.default_rng(6)
    g, p, h = 2, 3, 4
    x = torch.from_numpy(rng.standard_normal((streams * g * p, h, 3, 5)).astype(np.float32))
    got = pmodel.ensemble_mean(x, cond, g, streams)
    want = x.clone()
    rows = x.reshape(streams, g, p, h, 3, 5)
    for s in range(streams):
        for i in range(g):
            if branch == "at_merge":
                mean = rows[:, i, :, h // 2:].mean(dim=(0, 1))
            else:
                mean = rows[s, i, :, h // 2:].mean(dim=0)
            for j in range(p):
                want[(s * g + i) * p + j, h // 2:] = mean
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(got[:, : h // 2], x[:, : h // 2])
    single = x[: streams * g].contiguous()  # one prompt a group
    if cond == 2 or streams == 1:
        assert torch.equal(pmodel.ensemble_mean(single, cond, g, streams), single)
