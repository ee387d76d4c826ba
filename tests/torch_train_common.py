"""Shared set-up of the train-step parity tests (tests/test_torch_train_*.py):
a tiny SegGPT (3 layers) with flax-initialized weights in both packages, seeded
prompts and batches with exact 0.0/1.0 pixels, and the palette and prompt
indices the JAX train step draws from its key, handed to the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from beach_seg_tpu.config import BeachSegConfig as JConf
from beach_seg_tpu.models.seggpt.config import tiny_config as jtiny_config
from beach_seg_tpu.models.seggpt.model import SegGPT as JSegGPT
from beach_seg_tpu.train.prompt_tuner import PromptTuner as JTuner
from beach_seg_tpu.transforms.palette import random_palette as jrandom_palette
from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt import build_model, from_jax_params, tiny_config
from beach_seg_tpu_torch.train import PromptTuner

def as_jax_fields(cfg) -> dict:
    """A port SegGPTConfig as the JAX package's fields: the port-only
    Painter fields (``convert.PORT_ONLY``) are checked to be at their
    defaults, SegGPT's topology, and left out."""
    from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig
    from beach_seg_tpu_torch.models.seggpt.convert import PORT_ONLY

    raw = dataclasses.asdict(cfg)
    for name in PORT_ONLY:
        assert raw.pop(name) == SegGPTConfig.__dataclass_fields__[name].default, name
    return raw


# head_dim 8, 64 (ViT-L's) and 80 (ViT-H's)
GEOMETRIES = {"hd8": {}, "hd64": dict(hidden_size=128, num_attention_heads=2), "hd80": dict(hidden_size=160, num_attention_heads=2)}
# three layers keep the JAX compile (Pallas in interpret mode) to a few seconds
LAYERS = dict(num_hidden_layers=3, merge_index=1, intermediate_hidden_state_indices=(1, 2))
IDENTITY_AUG = dict(
    vertical_flip=0.0, horizontal_flip=0.0, hue=0.0, saturation=0.0, contrast=0.0, brightness=0.0,
    sharpness_p=0.0, erasing_p=0.0, gauss_p=0.0, channel_shift_p=0.0,
)
TRAIN = dict(epochs=2, batch_size=4, lr=1e-2, init_lr=1e-2, min_lr=1e-3, warmup_epochs=0, **IDENTITY_AUG)
LOSS_VARIANTS = ("nodata", "nodata_ref", "hf", "dice_bce")
PADDED = [True, True, True, False]  # batch["valid"]: the last row is padding
# (loss variant, valid) per geometry: each geometry runs every loss, and each
# loss runs with and without padded rows across the two geometries (one JAX
# compile per case, a few seconds each)
CASES = {
    "hd8": [(v, PADDED if i % 2 else None) for i, v in enumerate(LOSS_VARIANTS)],
    "hd64": [(v, None if i % 2 else PADDED) for i, v in enumerate(LOSS_VARIANTS)],
    "hd80": [(v, PADDED if i % 2 else None) for i, v in enumerate(LOSS_VARIANTS)],
}
# the gradient's bar per loss, (max error / scale, 1 - cosine): dice_bce
# takes log(1 - p) of a softmax at tau = 0.05, saturated here (p ≈ 0.9999),
# so ulp-level differences between the two frameworks' softmax grow by
# 1/(1 - p) ≈ 1e4 in its gradient (measured up to 3.4e-2 and 1.6e-4 on
# these inputs); the loss itself agrees to 1e-6
GRAD_TOL = {"dice_bce": (5e-2, 1e-3)}
GRAD_TOL_DEFAULT = (1e-5, 1e-6)
N_PROMPTS, B, H = 4, 4, 32


def build(geometry: str):
    """(model overrides, flax params, numpy data) for one geometry."""
    # initializer_range=0.2: at the default 0.02 a random tiny ViT is nearly
    # input-independent and the prompt gradients nearly vanish
    over = dict(GEOMETRIES[geometry], initializer_range=0.2, drop_path_rate=0.0, **LAYERS)
    jcfg = jtiny_config(**over)
    assert jcfg.image_size == (2 * H, H)
    z = jnp.zeros((1, H, H, 3))
    params = jax.jit(JSegGPT(jcfg).init)(random.PRNGKey(0), z, z, z)["params"]
    rng = np.random.default_rng(0)
    pixels = rng.random((N_PROMPTS, H, H, 3)).astype(np.float32)
    pixels[:, :4] = 0.0  # exact bounds, as uint8 imagery gives
    pixels[:, -4:] = 1.0
    data = {
        "pixels": pixels,
        "masks": rng.integers(0, 4, (N_PROMPTS, H, H)).astype(np.int32),
        "nodata": rng.random((N_PROMPTS, H, H)) < 0.1,
        "batches": [
            {
                "image": rng.random((B, H, H, 3)).astype(np.float32),
                "mask": rng.integers(0, 4, (B, H, H)).astype(np.int32),
                "nodata": rng.random((B, H, H)) < 0.1,
                "crop_idx": rng.integers(0, N_PROMPTS, (B,)).astype(np.int32),
            }
            for _ in range(2)
        ],
    }
    return over, params, data


def tuners(over, params, conf_kw, jdtype=jnp.float32, tdtype=torch.float32):
    jconf = JConf(crop_size=H, inpt_size=H, **conf_kw)
    jtuner = JTuner(model=JSegGPT(jtiny_config(**over), dtype=jdtype), conf=jconf, num_prompts=N_PROMPTS, steps_per_epoch=2)
    model = build_model(tiny_config(**over), tdtype, device="cpu", state=from_jax_params(params, device="cpu"))
    tuner = PromptTuner(model, BeachSegConfig(crop_size=H, inpt_size=H, **conf_kw), device="cpu", steps_per_epoch=2)
    return jtuner, tuner


def step_draws(key, num_classes: int, b: int = B, n_prompts: int = N_PROMPTS) -> dict:
    """The palette and prompt indices JAX's train_step draws from ``key``
    (prompt_tuner.py:232-248) for a batch of ``b`` and ``n_prompts`` prompts."""
    k_pal, k_idx, _, _, _, _ = random.split(key, 6)
    return {
        "palette": torch.from_numpy(np.array(jrandom_palette(k_pal, num_classes, b))),
        "prompt_idx": torch.from_numpy(np.array(random.randint(k_idx, (b,), 0, n_prompts))),
    }


def with_valid(batch: dict, valid) -> dict:
    out = dict(batch)
    if valid is not None:
        out["valid"] = np.asarray(valid)
    return out


def run_both(jtuner, tuner, params, data, valid, n_steps: int):
    """n_steps train steps on each side from the same pixels; returns the
    two final states and per-step metrics (JAX's with its prompt gradient,
    recovered from Adam's first moment)."""
    jstate = jtuner.init_state(jnp.asarray(data["pixels"]))
    state = tuner.init_state(data["pixels"])
    jm, tm = [], []
    mu_prev = np.zeros_like(data["pixels"])
    tmu_prev = np.zeros_like(data["pixels"])
    for i in range(n_steps):
        key = random.PRNGKey(100 + i)
        batch = with_valid(data["batches"][i % 2], valid)
        jstate, m = jtuner.train_step(
            jstate, params, jnp.asarray(data["masks"]), jnp.asarray(data["nodata"]),
            {k: jnp.asarray(v) for k, v in batch.items()}, key,
        )
        jm.append({k: np.asarray(v) for k, v in m.items()})
        mu = np.asarray(jstate.opt_state[0].mu)
        jm[-1]["grad"] = (mu - 0.9 * mu_prev) / 0.1
        mu_prev = mu
        state, m = tuner.train_step(
            state, data["masks"], data["nodata"], batch,
            generator=torch.Generator().manual_seed(i), draws=step_draws(key, tuner.num_classes),
        )
        tm.append({k: v.numpy() for k, v in m.items()})
        tmu = state.opt_state["mu"].numpy()
        tm[-1]["grad"] = (tmu - 0.9 * tmu_prev) / 0.1
        tmu_prev = tmu
    return jstate, state, jm, tm


def assert_grads_close(jm: list, tm: list, rel: float, cos_gap: float) -> None:
    """Each step's prompt gradient within ``rel`` of its scale, and at a
    cosine of at least 1 - ``cos_gap`` to JAX's."""
    for j, t in zip(jm, tm):
        scale = np.abs(j["grad"]).max()
        assert scale > 0
        assert np.abs(t["grad"] - j["grad"]).max() <= rel * scale
        cos = (t["grad"] * j["grad"]).sum() / (np.linalg.norm(t["grad"]) * np.linalg.norm(j["grad"]))
        assert cos >= 1 - cos_gap, cos


def assert_states_close(jstate, state, rel: float, jm: list, lr: float) -> None:
    """Adam's moments (the gradients) within ``rel`` of their scale. The
    pixels and their EMA get in addition what Adam's update can make of a
    gradient error of ``rel`` of the gradient's scale: its slope in g,
    eps / (|g| + eps)², is up to 1/eps = 1e8 where |g| is near 0, and these
    tiny models' gradients reach down there. So the pixel bound is
    rel·scale + Σ_steps lr · rel·max|g| / eps."""
    adam_slack = sum(lr * rel * np.abs(m["grad"]).max() / 1e-8 for m in jm)
    pairs = (
        ("prompt_pixels", np.asarray(jstate.prompt_pixels), state.prompt_pixels, adam_slack),
        ("ema_pixels", np.asarray(jstate.ema_pixels), state.ema_pixels, adam_slack),
        ("mu", np.asarray(jstate.opt_state[0].mu), state.opt_state["mu"], 0.0),
        ("nu", np.asarray(jstate.opt_state[0].nu), state.opt_state["nu"], 0.0),
    )
    for name, want, got, slack in pairs:
        err = np.abs(got.numpy() - want).max()
        assert err <= rel * np.abs(want).max() + slack, (name, err, np.abs(want).max(), slack)
    assert int(jstate.step) == state.step


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tiny CPU models on one torch thread, then restore the
    count: many small ops on 8 spinning threads slow to a crawl where
    several test processes share the host's cores (measured: a 1 s run
    took 88 s there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
