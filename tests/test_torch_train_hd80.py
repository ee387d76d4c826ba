"""The port's PromptTuner.train_step against the JAX package's on a tiny
fp32 SegGPT with head_dim 80, ViT-H's (JAX: the Pallas _kernel_packed and
_bwd_kernel through fused_attention_merged's custom VJP; the port:
cuda_attn.packed_attention on the plain versions of the two CUDA kernels),
and one bf16 step. Identity augmentation and no drop-path; the palette and
prompt indices come from JAX's key; the loss variants and padded rows as
CASES pairs them. Two steps each, with the head_dim-8 tolerances: loss
within 1e-5 relative, the prompt gradient and Adam's moments within 1e-5 of
their scale at a cosine ≥ 1 - 1e-6 (dice_bce: see GRAD_TOL), pixels and EMA
within that plus what Adam's update makes of it (see assert_states_close),
confusion matrices equal."""

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
    return build("hd80")


@pytest.mark.parametrize(
    "variant,valid", CASES["hd80"], ids=[f"{v}-{'padded' if m else 'no_valid'}" for v, m in CASES["hd80"]]
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


def test_train_step_bf16_matches_jax(setup):
    """One bf16 step, held as test_torch_train_hd64.py holds head_dim 64:
    both round at the same points, but XLA keeps fused bf16 chains in fp32
    where PyTorch rounds op by op, and fp32 sums in other orders flip single
    bf16 roundings through three layers forward and back: loss within 1e-2
    relative, the prompt gradient at a cosine ≥ 0.99 with JAX's and within
    0.1 of its scale."""
    import jax.numpy as jnp
    import torch

    over, params, data = setup
    jtuner, tuner = tuners(over, params, dict(TRAIN, loss_variant="nodata"), jnp.bfloat16, torch.bfloat16)
    _, _, jm, tm = run_both(jtuner, tuner, params, data, None, n_steps=1)
    j, t = jm[0], tm[0]
    assert np.isfinite(t["loss"]) and abs(t["loss"] - j["loss"]) <= 1e-2 * abs(j["loss"])
    cos = (t["grad"] * j["grad"]).sum() / (np.linalg.norm(t["grad"]) * np.linalg.norm(j["grad"]))
    assert cos >= 0.99, cos
    assert np.abs(t["grad"] - j["grad"]).max() <= 0.1 * np.abs(j["grad"]).max()
