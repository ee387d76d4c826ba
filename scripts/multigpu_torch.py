"""The torch port on several cards: its data and tensor parallel steps over
NCCL, one process a card, held against one process, then its CLIs under
torchrun.

    python3 scripts/multigpu_torch.py [--cards 4] [--debug]

Steps: one process (card 0) runs a ViT-L bf16 predict_step and train_step at
B=8 on chip_smoke.py's inputs and draws; then ``--cards`` ranks, one a card,
started through ``parallel.distributed.maybe_initialize`` (the launcher's
variables set here; NCCL), run the same on the meshes (cards, 1), (1, cards)
and (2, cards/2): ids equal to one process's (or ID_AGREEMENT_MIN of them
with pred_masks within chip_smoke's limit), the prompt gradient within
chip_smoke's limits, every rank's gradient equal, 24 launches of each kernel
a step, warm seconds, and the collectives' time (replayed alone).

CLIs: chip_smoke's scene; ``python -m torch.distributed.run --standalone``
of ``cli.train`` on (2, cards/2) for 1 epoch and of ``cli.predict`` on
(cards, 1) from its run dir on one date, beside the same predict in one
process; ``cli.compare`` of the two predictions (pixel_agreement).

``--debug``: the debug backbone in fp32 on the CPU over gloo ranks, crops of
32 at 64: a rehearsal of the control flow, no card needed. Prints the
card's name and power limit beside the numbers and one JSON line; exits
non-zero where a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

STEP_KERNELS = ("attn_qkv_rel", "ln_mlp", "attn_bwd", "ln_mlp_dx")


def setup(debug: bool):
    """(conf, device) of the run: ViT-L bf16 on the card, or the debug
    backbone in fp32 on the CPU."""
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.utils import resolve_device

    if debug:
        return BeachSegConfig(batch_size=cs.B, debug=True, crop_size=32, inpt_size=64), resolve_device("cpu")
    return BeachSegConfig(batch_size=cs.B, compute_dtype="bfloat16"), resolve_device("cuda")


def meshes(world: int) -> list[tuple[int, int]]:
    out = [(world, 1), (1, world)]
    if world >= 4 and world % 2 == 0:
        out.append((2, world // 2))
    return out


def steps(conf, device, draws: dict, mesh=None) -> dict:
    """A predict call and a train step (each run twice; the second timed,
    its collectives recorded) on ``mesh`` (None: one process)."""
    from beach_seg_tpu_torch.ops.sharding import DATA_AXIS, axis_size, data_sharded_call
    from beach_seg_tpu_torch.parallel.mesh import shard_batch, shard_model
    from beach_seg_tpu_torch.train import PromptTuner
    from beach_seg_tpu_torch.train.loop import model_for_config

    model, _ = model_for_config(conf, device, seed=0)
    if mesh is not None:
        shard_model(model, mesh)
    tuner = PromptTuner(model, conf, device=device)
    prompts, batches = cs.main_path_inputs(conf, 4, 1)
    tprompts, tbatches = cs.train_path_inputs(conf, 4, 1)
    rows = {k: torch.as_tensor(v).to(device) for k, v in batches[0].items()}

    def predict(image_u8, crop_idx):
        batch = {"image_u8": image_u8, "crop_idx": crop_idx}
        return tuner.predict_step(*prompts, batch, out_size=conf.crop_size), tuner.predict_masks(*prompts, batch)[0]

    r = {}
    for warm in (False, True):
        cs.reset_counts()
        sync(device)
        t = time.perf_counter()
        with cs.recording_collectives() if warm else contextlib.nullcontext() as calls:
            ids, pred = data_sharded_call(predict, (rows["image_u8"], rows["crop_idx"]), (True, True), mesh)
            sync(device)
        r["predict_s"] = time.perf_counter() - t
        r["predict_launches"] = {k: v for k, v in cs.read_counts().items() if v}
    r["ids"], r["pred"] = ids.cpu(), pred.cpu()
    r["predict_collectives"] = len(calls)
    r["predict_collective_ms"] = cs.collective_ms(calls)[0] if device.type == "cuda" and calls else None
    local = shard_batch(mesh, tbatches[0]) if mesh is not None and axis_size(mesh, DATA_AXIS) > 1 else tbatches[0]
    for warm in (False, True):
        cs.reset_counts()
        sync(device)
        t = time.perf_counter()
        with cs.recording_collectives() if warm else contextlib.nullcontext() as calls:
            state, metrics = tuner.train_step(tuner.init_state(tprompts[0]), tprompts[1], tprompts[2], local, draws=draws)
            loss = metrics["loss"].item()
            sync(device)
        r["train_s"] = time.perf_counter() - t
        r["train_launches"] = {k: v for k, v in cs.read_counts().items() if v}
    r["loss"], r["mu"] = loss, state.opt_state["mu"].cpu()
    r["train_collectives"] = len(calls)
    r["train_collective_ms"] = cs.collective_ms(calls)[0] if device.type == "cuda" and calls else None
    return r


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def rank_main(rank: int, world: int, port: int, out_dir: str, draws_path: str, debug: bool) -> None:
    """One rank: torch.distributed through the port's own start (the
    launcher's variables set here), the steps on every mesh, the results to
    ``out_dir/rank<r>.pt``."""
    import torch.distributed as dist

    from beach_seg_tpu_torch.parallel.distributed import maybe_initialize
    from beach_seg_tpu_torch.parallel.mesh import make_mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    if debug:
        torch.set_num_threads(1)
    maybe_initialize(world, "cpu" if debug else "")
    conf, device = setup(debug)
    draws = torch.load(draws_path, weights_only=False)
    try:
        res = {"backend": dist.get_backend(), "device": str(device)}
        for shape in meshes(world):
            res[shape] = steps(conf, device, draws, make_mesh(*shape))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def run_ranks(world: int, draws: dict, debug: bool) -> list:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="multigpu_") as tmp:
        torch.save(cs.to_cpu(draws), Path(tmp) / "draws.pt")
        mp.spawn(rank_main, args=(world, cs.free_port(), tmp, str(Path(tmp) / "draws.pt"), debug), nprocs=world,
                 join=True)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def hold(tag: str, got: dict, want: dict, card: str) -> dict:
    """One mesh's rank-0 results against one process's."""
    agree = (got["ids"] == want["ids"]).float().mean().item()
    err = (got["pred"] - want["pred"]).abs().max().item()
    scale = want["pred"].abs().max().item()
    gap, gerr, gscale = cs.grad_agreement(got["mu"], want["mu"])
    row = {"mesh": tag, "predict_s": got["predict_s"], "train_s": got["train_s"], "ids_agreement": agree,
           "pred_err": err, "grad_1mcos": gap, "grad_err": gerr, "loss": got["loss"],
           "predict_collectives": got["predict_collectives"], "predict_collective_ms": got["predict_collective_ms"],
           "train_collectives": got["train_collectives"], "train_collective_ms": got["train_collective_ms"],
           "train_launches": {k: got["train_launches"].get(k, 0) for k in STEP_KERNELS}}
    cs.log(f"{tag}: predict {got['predict_s']:.4f} s, train {got['train_s']:.4f} s warm; ids {agree:.6f} equal, "
           f"pred_masks max_abs_err {err:.4e} (tol {cs.PRED_REL_TOL * scale:.4e}); gradient 1 - cosine {gap:.4e}, "
           f"max_abs_err {gerr:.4e} (tol {cs.GRAD_REL_TOL * gscale:.4e}); collectives {got['train_collectives']} a step "
           f"({got['train_collective_ms']} ms replayed), {got['predict_collectives']} a call "
           f"({got['predict_collective_ms']} ms); loss {got['loss']} (one process {want['loss']}) ({card})")
    cs.check(agree == 1.0 or (agree >= cs.ID_AGREEMENT_MIN and err <= cs.PRED_REL_TOL * scale), f"{tag}: ids agree on {agree}")
    cs.check(gscale > 0 and gap <= cs.GRAD_1MCOS_MAX and gerr <= cs.GRAD_REL_TOL * gscale, f"{tag}: gradient disagrees")
    return row


def cli(args: list[str], world: int) -> tuple[str, float]:
    """A CLI from the repository root, in one process or under torchrun →
    (its standard output, seconds)."""
    launcher = [] if world == 1 else ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={world}"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    t = time.perf_counter()
    res = subprocess.run([sys.executable, *launcher, "-m", *args], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=900)
    seconds = time.perf_counter() - t
    cs.check(res.returncode == 0, f"{args[0]} on {world} exited {res.returncode}: {res.stderr[-4000:]}")
    return res.stdout, seconds


def clis(world: int, conf, debug: bool, card: str) -> dict:
    """cli.train on (2, world/2) (or (1, world)), then cli.predict on
    (world, 1) and in one process from its run dir, then cli.compare."""
    mesh_model = world // 2 if world >= 4 else world
    common = ["checkpoint=random", f"batch_size={cs.B}",
              *(["debug=true", "crop_size=32", "inpt_size=64", "platform=cpu"] if debug else ["compute_dtype=bfloat16"])]
    with tempfile.TemporaryDirectory(prefix="multigpu_scene_") as tmp:
        root = Path(tmp)
        dates = cs.write_scene(root / "all" / "scene")
        out, train_s = cli(["beach_seg_tpu_torch.cli.train", f"data={root / 'all' / 'scene'}",
                            f"model_training_root={root / 'train'}", "epochs=1", "num_viz_images=0",
                            f"mesh_model={mesh_model}", *([] if debug else ["crop_size=112", "inpt_size=448"]),
                            *common], world)
        run_dir = Path(out.strip().splitlines()[-1])
        view = cs.scene_view(root / "all" / "scene", root / "view" / "scene", dates[:2])
        predict = ["beach_seg_tpu_torch.cli.predict", f"data={view}", f"train_run_dir={run_dir}", *common]
        out, many_s = cli([*predict, f"model_training_root={root / 'many'}", f"mesh_data={world}"], world)
        many = Path(out.strip().splitlines()[-1])
        out, one_s = cli([*predict, f"model_training_root={root / 'one'}"], 1)
        one = Path(out.strip().splitlines()[-1])
        out, _ = cli(["beach_seg_tpu_torch.cli.compare", str(many / "tif"), str(one / "tif")], 1)
        report = json.loads(out)
        files = sorted(p.name for p in run_dir.iterdir())
    agree = report["pixel_agreement"]
    cs.log(f"CLIs: cli.train on (2, {mesh_model}) {train_s:.3f} s, cli.predict on ({world}, 1) {many_s:.3f} s, in one "
           f"process {one_s:.3f} s; pixel_agreement {agree}; the train run dir {files} ({card})")
    cs.check(agree >= cs.ID_AGREEMENT_MIN, f"cli.predict on {world} ranks agrees with one process on {agree}")
    return {"train_s": train_s, "predict_many_s": many_s, "predict_one_s": one_s, "pixel_agreement": agree,
            "train_mesh": [world // mesh_model, mesh_model]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--debug", action="store_true")
    args = ap.parse_args()
    if not args.debug and torch.cuda.device_count() < args.cards:
        print(f"multigpu_torch: {args.cards} CUDA devices needed, {torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    card = "cpu (debug rehearsal)" if args.debug else cs.card_line()
    cs.log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, {args.cards} ranks")
    if not args.debug:
        from beach_seg_tpu_torch.ops import build

        build.build(*build.KERNELS)
    conf, device = setup(args.debug)
    from beach_seg_tpu_torch.train import PromptTuner
    from beach_seg_tpu_torch.train.loop import model_for_config

    model, _ = model_for_config(conf, device, seed=0)
    _, tbatches = cs.train_path_inputs(conf, 4, 1)
    draws = PromptTuner(model, conf, device=device).step_draws(tbatches[0], 4, torch.Generator(device=device).manual_seed(7))
    del model
    want = steps(conf, device, draws)
    cs.log(f"one process: predict {want['predict_s']:.4f} s, train {want['train_s']:.4f} s warm ({card})")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = run_ranks(args.cards, draws, args.debug)
    spawn_s = time.perf_counter() - t
    rows = []
    for shape in meshes(args.cards):
        tag = f"data={shape[0]} model={shape[1]}"
        for rank, r in enumerate(ranks):
            cs.check(torch.equal(r[shape]["mu"], ranks[0][shape]["mu"]), f"{tag}: rank {rank}'s gradient differs")
            cs.check(torch.equal(r[shape]["ids"], ranks[0][shape]["ids"]), f"{tag}: rank {rank}'s ids differ")
            if not args.debug:
                got = {k: r[shape]["train_launches"].get(k, 0) for k in STEP_KERNELS}
                cs.check(got == dict.fromkeys(STEP_KERNELS, 24), f"{tag}: rank {rank}'s launches a step {got}")
        rows.append(hold(tag, ranks[0][shape], want, card))
    res = clis(args.cards, conf, args.debug, card)
    print(json.dumps({"card": card, "backend": ranks[0]["backend"], "ranks": args.cards, "spawn_s": spawn_s,
                      "one_process": {"predict_s": want["predict_s"], "train_s": want["train_s"]},
                      "meshes": rows, "clis": res}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
