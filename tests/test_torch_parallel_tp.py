"""The port's tensor parallelism on the CPU: a (data=1, model=2) mesh over 2
gloo processes, each holding whole heads of qkv and the rows of proj, a
column block of lin1 and the rows of lin2, a column block of the decoder
embed, against the same steps in one process and against the JAX package
on an 8-device (data=4, model=2) mesh, on the same seeded inputs: a
head_dim-8 model (4 heads, the packed attention, 2 heads a rank) and a
head_dim-64 one (2 heads, the qkv-rel attention, 1 head a rank; also
against JAX) and a head_dim-80 one (ViT-H's head dim, which
BASELINE.json config #5 shards under mesh_model > 1: 2 heads, the packed
attention, 1 head a rank) and a tiny Painter (the head_dim-64 widths, blocks
0 and 2 in 4×4 windows of the 8×4 grid, block 1 global, no type tokens; the
head_dim-64 model's weights cut to Painter's tables, since the JAX package
has no Painter). Limits as
tests/test_tp_equivalence.py holds the JAX package's own: predict ids
equal, loss within 1e-5 relative, confusion matrices equal, pixels within
rtol 1e-5, atol 1e-6 plus Adam's slope where |g| nears its eps
(test_torch_parallel.assert_same_run); the gradients, and against JAX, the
train-step parity tests' gradient limits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beach_seg_tpu.config import BeachSegConfig as JConf
from beach_seg_tpu.models.seggpt.config import tiny_config as jtiny_config
from beach_seg_tpu.models.seggpt.model import SegGPT as JSegGPT
from beach_seg_tpu.parallel.mesh import batch_sharding as jbatch_sharding
from beach_seg_tpu.parallel.mesh import make_mesh as jmake_mesh
from beach_seg_tpu.parallel.mesh import param_sharding as jparam_sharding
from beach_seg_tpu.parallel.mesh import replicated as jreplicated
from beach_seg_tpu.train.prompt_tuner import PromptTuner as JTuner
from beach_seg_tpu_torch.models.seggpt import tiny_config
from beach_seg_tpu_torch.parallel.mesh import tp_shard
from tests.test_torch_parallel import B, CONF, H, P, assert_same_run, draws, jax_train, problem
from tests.torch_parallel_common import mesh_task, predict, spawn, train, tuner_on
from tests.torch_train_common import GRAD_TOL, GRAD_TOL_DEFAULT, assert_grads_close

GEOMS = ("hd8", "hd64", "hd80", "painter")


def painter_problem() -> dict:
    """``problem("hd64")`` as a tiny Painter: its flax-initialized weights
    without the type tokens, each windowed block's 7-row rel-pos tables the
    central rows (offsets −3…3) of its global ones."""
    pb = problem("hd64")
    over = dict(pb["over"], window_size=4, global_attn_indexes=(1,), type_tokens=False)
    cfg = tiny_config(**over)
    state = {k: v for k, v in pb["state"].items() if "type_token" not in k}
    for i in range(cfg.num_hidden_layers):
        win = cfg.block_window(i)
        for axis in ("h", "w") if win else ():
            table = state[f"encoder.layers_{i}.attention.rel_pos_{axis}"]
            mid = table.shape[0] // 2
            state[f"encoder.layers_{i}.attention.rel_pos_{axis}"] = table[mid - win + 1: mid + win].copy()
    return dict(pb, over=over, params=None, state=state)


def predict_batch() -> dict:
    rng = np.random.default_rng(9)
    return {"image_u8": rng.integers(0, 256, (B, H, H, 3), dtype=np.uint8),
            "crop_idx": rng.integers(0, P, (B,)).astype(np.int32)}


@pytest.fixture(scope="module")
def world():
    pbs = {g: painter_problem() if g == "painter" else problem(g) for g in GEOMS}
    cases = {}
    for g, pb in pbs.items():
        base = {"mesh": (1, 2), "over": pb["over"], "state": pb["state"], "conf": CONF, "prompts": pb["prompts"]}
        cases[f"train_{g}"] = dict(base, kind="train", batches=pb["batches"], draws=draws())
        cases[f"predict_{g}"] = dict(base, kind="predict", batch=predict_batch())
        cases[f"shards_{g}"] = {"kind": "shards", "mesh": (1, 2), "state": pb["state"]}
    ranks = spawn(mesh_task, 2, {"cases": cases})
    one = {}
    for g, pb in pbs.items():
        tuner = tuner_on(None, pb["over"], pb["state"], CONF)
        one[f"train_{g}"] = train(tuner, pb["prompts"], pb["batches"], draws())
        one[f"predict_{g}"] = predict(tuner, pb["prompts"], predict_batch())
    return {"pbs": pbs, "ranks": ranks, "one": one}


@pytest.mark.parametrize("geometry", GEOMS)
def test_each_rank_holds_its_shards(world, geometry):
    """param_sharding on rank m is tp_shard's block m: qkv (C, 3, C/2)."""
    state = world["pbs"][geometry]["state"]
    full = {k: torch.from_numpy(v) for k, v in state.items()}
    for m, r in enumerate(world["ranks"]):
        want = tp_shard(full, 2, m)
        assert set(r[f"shards_{geometry}"]) == set(want)
        for k, v in r[f"shards_{geometry}"].items():
            np.testing.assert_array_equal(v, want[k].numpy(), err_msg=k)
        c = state["encoder.layers_0.attention.qkv_kernel"].shape[0]
        assert r[f"shards_{geometry}"]["encoder.layers_0.attention.qkv_kernel"].shape == (c, 3, c // 2)


@pytest.mark.parametrize("geometry", GEOMS)
def test_tensor_parallel_predict_ids_equal_one_process(world, geometry):
    """Ids equal, as JAX's own tests/test_tp_equivalence.py holds its TP.
    Equality is a property of these inputs: the sums over ranks reorder
    fp32 additions, so a pixel at a palette-distance near-tie can flip (one
    of 8192 did with the port's own seeded random weights in place of these
    flax-initialized ones)."""
    want = world["one"][f"predict_{geometry}"]
    assert len(np.unique(want)) > 1
    for r in world["ranks"]:
        np.testing.assert_array_equal(r[f"predict_{geometry}"], want)


@pytest.mark.parametrize("geometry", GEOMS)
def test_tensor_parallel_train_steps_equal_one_process(world, geometry):
    want = world["one"][f"train_{geometry}"]
    r0, r1 = (r[f"train_{geometry}"] for r in world["ranks"])
    np.testing.assert_array_equal(r0["pixels"], r1["pixels"])
    assert_same_run(r0, want)


def test_tensor_parallel_predict_matches_jax_model_mesh(world):
    """JAX's predict_step on the (data=4, model=2) mesh: the same ids, for
    the head_dim-64 model (ViT-L's attention path, the qkv-rel kernel's
    plain version; the head_dim-8 model's equals the 1-process run's,
    which tests/test_torch_predict.py holds to JAX's)."""
    geometry = "hd64"
    pb = world["pbs"][geometry]
    jtuner = JTuner(model=JSegGPT(jtiny_config(**pb["over"])), conf=JConf(**CONF), num_prompts=P, steps_per_epoch=1)
    mesh = jmake_mesh(data=4, model=2)
    params = jax.device_put(pb["params"], jparam_sharding(mesh, pb["params"]))
    rep = lambda x: jax.device_put(jnp.asarray(x), jreplicated(mesh))  # noqa: E731
    batch = {k: jax.device_put(jnp.asarray(v), jbatch_sharding(mesh)) for k, v in predict_batch().items()}
    with jax.sharding.set_mesh(mesh):
        want = np.asarray(jtuner.predict_step(rep(pb["prompts"]["pixels"]), params, rep(pb["prompts"]["masks"]),
                                              rep(pb["prompts"]["nodata"]), batch))
    np.testing.assert_array_equal(world["ranks"][0][f"predict_{geometry}"], want)


def test_tensor_parallel_train_matches_jax_model_mesh(world):
    """JAX's train steps on the (data=4, model=2) mesh, head_dim 64: loss
    within 1e-5 relative, confusions equal, the prompt gradients within the
    train-step parity limits."""
    geometry = "hd64"
    pb = world["pbs"][geometry]
    want = jax_train(pb, pb["batches"], (4, 2), CONF)
    got = world["ranks"][0][f"train_{geometry}"]
    for gl, wl in zip(got["loss"], want["loss"]):
        assert gl == pytest.approx(wl, rel=1e-5)
    for gc, wc in zip(got["confusion"], want["confusion"]):
        np.testing.assert_array_equal(gc, wc)
    rel, cos_gap = GRAD_TOL.get("nodata", GRAD_TOL_DEFAULT)
    assert_grads_close([{"grad": g} for g in want["grad"]], [{"grad": g} for g in got["grad"]], rel, cos_gap)
