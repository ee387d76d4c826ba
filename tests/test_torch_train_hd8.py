"""The port's PromptTuner.train_step against the JAX package's on a tiny
fp32 SegGPT with head_dim 8 (JAX: the Pallas _kernel_packed and its custom
VJP; the port: their plain versions), and eval_step.
Identity augmentation and no drop-path; the palette and prompt indices come
from JAX's key; the loss variants and padded rows as CASES pairs them.
Two steps each; loss within 1e-5 relative, the prompt gradient and Adam's
moments within 1e-5 of their scale at a cosine ≥ 1 - 1e-6 (dice_bce:
see GRAD_TOL), pixels and EMA within that plus what Adam's update makes
of it (see assert_states_close), confusion matrices equal."""

import numpy as np
import pytest

from tests.torch_train_common import (
    CASES,
    GRAD_TOL,
    GRAD_TOL_DEFAULT,
    TRAIN,
    assert_grads_close,
    assert_states_close,
    build,
    run_both,
    tuners,
)


@pytest.fixture(scope="module")
def setup():
    return build("hd8")


@pytest.mark.parametrize(
    "variant,valid", CASES["hd8"], ids=[f"{v}-{'padded' if m else 'no_valid'}" for v, m in CASES["hd8"]]
)
def test_train_step_matches_jax(setup, variant, valid):
    over, params, data = setup
    jtuner, tuner = tuners(over, params, dict(TRAIN, loss_variant=variant))
    jstate, state, jm, tm = run_both(jtuner, tuner, params, data, valid, n_steps=2)
    for j, t in zip(jm, tm):
        assert np.isfinite(t["loss"])
        assert abs(t["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"])
        np.testing.assert_array_equal(t["confusion"], j["confusion"])
    rel, cos_gap = GRAD_TOL.get(variant, GRAD_TOL_DEFAULT)
    assert_grads_close(jm, tm, rel, cos_gap)
    assert_states_close(jstate, state, rel, jm, TRAIN["lr"])
    assert not np.allclose(state.prompt_pixels.numpy(), data["pixels"])


@pytest.mark.parametrize("valid", [None, [True, False, True, True]], ids=["no_valid", "padded"])
def test_eval_step_matches_jax(setup, valid):
    """eval_step on the palette JAX draws from its key: loss within 1e-5
    relative, ids and confusion equal."""
    import jax.numpy as jnp
    import torch
    from jax import random

    from beach_seg_tpu.transforms.palette import random_palette as jrandom_palette
    from tests.torch_train_common import B, with_valid

    over, params, data = setup
    jtuner, tuner = tuners(over, params, TRAIN)
    key = random.PRNGKey(5)
    batch = with_valid(data["batches"][0], valid)
    want = jtuner.eval_step(
        jnp.asarray(data["pixels"]), params, jnp.asarray(data["masks"]), jnp.asarray(data["nodata"]),
        {k: jnp.asarray(v) for k, v in batch.items()}, key,
    )
    palette = torch.from_numpy(np.array(jrandom_palette(key, tuner.num_classes, B)))
    got = tuner.eval_step(data["pixels"], data["masks"], data["nodata"], batch, palette=palette)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(want["pred"]))
    np.testing.assert_array_equal(got["confusion"].numpy(), np.asarray(want["confusion"]))
