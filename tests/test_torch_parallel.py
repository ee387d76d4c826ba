"""The port's data parallelism on the CPU: 2 gloo processes, each passing
only its own rows of every batch, against the same steps in one process and
against the JAX package on an 8-device data mesh, on the same seeded inputs
(tests/test_multihost.py's problem: 8 rows, 3 prompts, masks in 1..3, here
on a 3-layer tiny SegGPT with identity augmentation and JAX's palettes and
prompt indices). Limits as the JAX package holds its own multi-host run:
loss within 1e-5 relative, confusion matrices equal, the sum of |pixels|
within 1e-6 relative, and the pixels within test_tp_equivalence.py's
rtol 1e-5, atol 1e-6 plus Adam's slope where |g| nears its eps
(assert_same_run); the prompt gradients within the train-step parity
limits. Also: a batch whose two halves hold different
numbers of valid pixels, under each loss variant (a mean of the ranks'
means would differ there), a ragged batch through data_sharded_call, the
(data=2, model=2) mesh on 4 processes, and the tensor-parallel shard
cutter against JAX's param_sharding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from beach_seg_tpu.config import BeachSegConfig as JConf
from beach_seg_tpu.models.seggpt.config import tiny_config as jtiny_config
from beach_seg_tpu.models.seggpt.model import SegGPT as JSegGPT
from beach_seg_tpu.parallel.mesh import batch_sharding as jbatch_sharding
from beach_seg_tpu.parallel.mesh import make_mesh as jmake_mesh
from beach_seg_tpu.parallel.mesh import param_sharding as jparam_sharding
from beach_seg_tpu.parallel.mesh import replicated as jreplicated
from beach_seg_tpu.train.prompt_tuner import PromptTuner as JTuner
from beach_seg_tpu_torch.models.seggpt import from_jax_params
from beach_seg_tpu_torch.parallel.mesh import tp_shard
from tests.torch_parallel_common import mesh_task, predict, spawn, train, tuner_on
from tests.torch_train_common import GEOMETRIES, GRAD_TOL, GRAD_TOL_DEFAULT, IDENTITY_AUG, LAYERS, assert_grads_close, step_draws

H, B, P = 32, 8, 3
CONF = dict(crop_size=H, inpt_size=H, batch_size=B, epochs=1, warmup_epochs=0, **IDENTITY_AUG)
VARIANTS = ("nodata", "nodata_ref", "hf", "dice_bce")
STEPS = 2


def problem(geometry: str = "hd8") -> dict:
    """Flax weights (and the port's state from them), prompts, and two
    batches of B rows each for one geometry."""
    over = dict(GEOMETRIES[geometry], initializer_range=0.2, drop_path_rate=0.0, **LAYERS)
    z = jnp.zeros((1, H, H, 3))
    params = jax.jit(JSegGPT(jtiny_config(**over)).init)(random.PRNGKey(0), z, z, z)["params"]
    rng = np.random.default_rng(0)
    prompts = {
        "pixels": rng.random((P, H, H, 3)).astype(np.float32),
        "masks": rng.integers(0, 4, (P, H, H)).astype(np.int32),
        "nodata": np.zeros((P, H, H), bool),
    }
    batches = [
        {
            "image": rng.random((B, H, H, 3)).astype(np.float32),
            "mask": rng.integers(1, 4, (B, H, H)).astype(np.int32),
            "nodata": np.zeros((B, H, H), bool),
            "crop_idx": rng.integers(0, P, (B,)).astype(np.int32),
        }
        for _ in range(STEPS)
    ]
    state = {k: v.numpy() for k, v in from_jax_params(params, device="cpu").items()}
    return {"over": over, "params": params, "state": state, "prompts": prompts, "batches": batches}


def uneven(batches: list) -> list:
    """The batches with class 0 (out of every loss) on 70% of the first
    half's pixels and 10% of the second half's: the two data ranks hold
    different numbers of valid pixels."""
    rng = np.random.default_rng(5)
    out = []
    for b in batches:
        mask = b["mask"].copy()
        share = np.where(np.arange(B) < B // 2, 0.7, 0.1)[:, None, None]
        mask[rng.random(mask.shape) < share] = 0
        out.append(dict(b, mask=mask))
    return out


def draws(n_prompts: int = P) -> list:
    return [step_draws(random.PRNGKey(7 + i), 4, b=B, n_prompts=n_prompts) for i in range(STEPS)]


def jax_train(pb: dict, batches: list, mesh_shape: tuple[int, int], conf_kw: dict):
    """JAX's train steps on a (data, model) mesh of the 8 CPU devices →
    per-step losses, confusions and prompt gradients, the final pixels."""
    jtuner = JTuner(model=JSegGPT(jtiny_config(**pb["over"])), conf=JConf(**conf_kw), num_prompts=P, steps_per_epoch=2)
    mesh = jmake_mesh(*mesh_shape)
    params = jax.device_put(pb["params"], jparam_sharding(mesh, pb["params"]))
    pm = jax.device_put(jnp.asarray(pb["prompts"]["masks"]), jreplicated(mesh))
    pn = jax.device_put(jnp.asarray(pb["prompts"]["nodata"]), jreplicated(mesh))
    out = {"loss": [], "confusion": [], "grad": []}
    mu_prev = np.zeros_like(pb["prompts"]["pixels"])
    with jax.sharding.set_mesh(mesh):
        state = jax.device_put(jtuner.init_state(jnp.asarray(pb["prompts"]["pixels"])), jreplicated(mesh))
        for i, batch in enumerate(batches):
            jb = {k: jax.device_put(jnp.asarray(v), jbatch_sharding(mesh)) for k, v in batch.items()}
            state, m = jtuner.train_step(state, params, pm, pn, jb, random.PRNGKey(7 + i))
            out["loss"].append(float(m["loss"]))
            out["confusion"].append(np.asarray(m["confusion"]))
            mu = np.asarray(state.opt_state[0].mu)
            out["grad"].append((mu - 0.9 * mu_prev) / 0.1)
            mu_prev = mu
    out["pixels"] = np.asarray(state.prompt_pixels)
    return out


@pytest.fixture(scope="module")
def world():
    pb = problem()
    cases = {}
    for variant in VARIANTS:
        conf = dict(CONF, loss_variant=variant)
        cases[f"dp_{variant}"] = {"kind": "train", "mesh": (2, 1), "over": pb["over"], "state": pb["state"],
                                  "conf": conf, "prompts": pb["prompts"], "batches": uneven(pb["batches"]),
                                  "draws": draws()}
    # padded rows (valid=False) in both halves: the sample-weighted sums
    padded = [dict(b, valid=np.arange(B) % 4 != 3) for b in uneven(pb["batches"])]
    cases["dp_hf_padded"] = dict(cases["dp_hf"], batches=padded)
    cases["dp_even"] = dict(cases["dp_nodata"], batches=pb["batches"])
    rng = np.random.default_rng(3)
    cases["ragged_unit1"] = {"kind": "ragged", "mesh": (2, 1), "unit": 1, "x": rng.random((5, 4)).astype(np.float32)}
    cases["ragged_unit3"] = {"kind": "ragged", "mesh": (2, 1), "unit": 3, "x": rng.random((5 * 3, 4)).astype(np.float32)}
    ranks = spawn(mesh_task, 2, {"cases": cases})

    # the same cases in this process, on one device
    one = {}
    for name, case in cases.items():
        if case["kind"] == "train":
            tuner = tuner_on(None, case["over"], case["state"], case["conf"])
            one[name] = train(tuner, case["prompts"], case["batches"], case["draws"])
        else:
            one[name] = case["x"] * 2.0 + 1.0
    return {"pb": pb, "cases": cases, "ranks": ranks, "one": one}


def assert_same_run(got: dict, want: dict) -> None:
    """Loss within 1e-5 relative, confusions equal, each step's prompt
    gradient within 1e-5 of its scale at a cosine ≥ 1 - 1e-6, the sum of
    |pixels| within 1e-6 relative, and each pixel within rtol 1e-5, atol
    1e-6 plus what Adam's update can make of the gradient's error there:
    its slope in g is eps / (|g| + eps)² ≤ 1 / (|g| + eps), so a gradient
    error of 1e-5·max|g| moves the pixel by up to
    Σ_steps lr · 1e-5·max|g| / (|g| + eps). That term matters only where
    |g| nears eps = 1e-8 (measured: one element of 9216, |g| = 1.1e-9, moved
    2.0e-6 under tensor parallelism, where the sums over ranks reorder the
    fp32 additions)."""
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.train.prompt_tuner import lr_schedule

    for gl, wl in zip(got["loss"], want["loss"]):
        assert gl == pytest.approx(wl, rel=1e-5)
    for gc, wc in zip(got["confusion"], want["confusion"]):
        np.testing.assert_array_equal(gc, wc)
    assert_grads_close([{"grad": g} for g in want["grad"]], [{"grad": g} for g in got["grad"]], *GRAD_TOL_DEFAULT)
    assert np.abs(got["pixels"]).sum() == pytest.approx(np.abs(want["pixels"]).sum(), rel=1e-6)
    lr = lr_schedule(BeachSegConfig(**CONF), 2)
    slack = sum(lr(i) * 1e-5 * np.abs(g).max() / (np.abs(g) + 1e-8) for i, g in enumerate(want["grad"]))
    assert np.all(np.abs(got["pixels"] - want["pixels"]) <= 1e-6 + 1e-5 * np.abs(want["pixels"]) + slack)


@pytest.mark.parametrize("case", [f"dp_{v}" for v in VARIANTS] + ["dp_hf_padded", "dp_even"])
def test_data_parallel_train_steps_equal_one_process(world, case):
    want = world["one"][case]
    r0, r1 = (r[case] for r in world["ranks"])
    # every rank holds the same state, bit for bit
    np.testing.assert_array_equal(r0["pixels"], r1["pixels"])
    assert r0["loss"] == r1["loss"]
    assert_same_run(r0, want)
    assert want["confusion"][0].sum() > 0


def test_uneven_halves_are_what_a_mean_of_rank_means_gets_wrong(world):
    """The nodata loss of the uneven batch: the global masked mean (what the
    ranks report) is not the mean of the two halves' masked means."""
    from beach_seg_tpu_torch.train.prompt_tuner import prompt_tune_loss

    batch = world["cases"]["dp_nodata"]["batches"][0]
    keep = batch["mask"] != 0
    assert keep[: B // 2].sum() < 0.5 * keep[B // 2 :].sum()
    rng = np.random.default_rng(0)
    pred = torch.from_numpy(rng.random((B, 2 * H, H, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.random((B, H, H, 3)).astype(np.float32))
    k = torch.from_numpy(keep)
    whole = float(prompt_tune_loss(pred, labels, k, 0.01))
    halves = [float(prompt_tune_loss(pred[s], labels[s], k[s], 0.01)) for s in (slice(0, B // 2), slice(B // 2, B))]
    assert abs(whole - sum(halves) / 2) > 1e-3 * whole


def test_data_parallel_matches_jax_data_mesh(world):
    """The 2-rank run of the uneven batch against JAX's train steps on an
    8-device data mesh, with the train-step parity tests' limits."""
    pb, case = world["pb"], world["cases"]["dp_nodata"]
    want = jax_train(pb, case["batches"], (8, 1), case["conf"])
    got = world["ranks"][0]["dp_nodata"]
    for gl, wl in zip(got["loss"], want["loss"]):
        assert gl == pytest.approx(wl, rel=1e-5)
    for gc, wc in zip(got["confusion"], want["confusion"]):
        np.testing.assert_array_equal(gc, wc)
    rel, cos_gap = GRAD_TOL.get("nodata", GRAD_TOL_DEFAULT)
    assert_grads_close([{"grad": g} for g in want["grad"]], [{"grad": g} for g in got["grad"]], rel, cos_gap)


@pytest.mark.parametrize("case", ["ragged_unit1", "ragged_unit3"])
def test_ragged_batch_pads_and_slices_back(world, case):
    """5 batch elements over 2 data ranks (the second case in units of 3
    rows, as (B·heads, …) operands come): padded to 6, each rank runs 3,
    the gathered output sliced back to the 1-rank one (JAX:
    test_sharding_pad.py)."""
    for r in world["ranks"]:
        np.testing.assert_array_equal(r[case], world["one"][case])


def test_data_and_model_mesh_on_four_processes(world):
    """A (data=2, model=2) mesh over 4 ranks: one predict step, its ids
    equal to the 1-process run's on every rank."""
    pb = world["pb"]
    rng = np.random.default_rng(9)
    batch = {"image_u8": rng.integers(0, 256, (B, H, H, 3), dtype=np.uint8),
             "crop_idx": rng.integers(0, P, (B,)).astype(np.int32)}
    case = {"kind": "predict", "mesh": (2, 2), "over": pb["over"], "state": pb["state"], "conf": CONF,
            "prompts": pb["prompts"], "batch": batch}
    ranks = spawn(mesh_task, 4, {"cases": {"predict": case}})
    want = predict(tuner_on(None, pb["over"], pb["state"], CONF), pb["prompts"], batch)
    assert len(np.unique(want)) > 1
    for r in ranks:
        np.testing.assert_array_equal(r["predict"], want)


def test_shard_cutter_matches_jax_param_sharding(world):
    """tp_shard on the converted JAX weights gives model rank m what JAX's
    param_sharding puts on the devices of model coordinate m of an 8-device
    (data=4, model=2) mesh (read with addressable_shards), for every
    parameter, sharded or replicated."""
    pb = world["pb"]
    mesh = jmake_mesh(data=4, model=2)
    sharded = jax.device_put(pb["params"], jparam_sharding(mesh, pb["params"]))
    full = from_jax_params(pb["params"], device="cpu")
    coord = {d: int(np.argwhere(mesh.devices == d)[0][1]) for d in mesh.devices.flat}
    ours = [tp_shard(full, 2, m) for m in range(2)]
    n_split = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(sharded)[0]:
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        assert len(leaf.addressable_shards) == 8
        for shard in leaf.addressable_shards:
            np.testing.assert_array_equal(ours[coord[shard.device]][name].numpy(), np.asarray(shard.data), err_msg=name)
        n_split += leaf.addressable_shards[0].data.shape != leaf.shape
    # qkv kernel and bias, lin1 kernel and bias, proj and lin2 kernels a layer; the decoder embed's two
    assert n_split == 6 * LAYERS["num_hidden_layers"] + 2
