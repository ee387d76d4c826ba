"""Readings that set the EVA-02 cell's correctness limit: the program's on
many seeds, and the controls' and planted faults', in one process
(``calibrate_painter.py``'s readings for the ``eva02_predict_step`` driver).

    python3 portbench/calibrate_eva02.py --workload eva02_vit_l_bf16.predict_b8 --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--seconds 2]

Each seed builds the cell as a run does, runs a short window and prints one
JSON line with ``id_gap_max``. On the control seeds it adds:

- ``control_fp8``: the EVA-02 reference with fp8 operands (one step below
  the configuration's bf16), its first-placed class judged by the float32
  reference's gap, as a served id is;
- ``fault_ids_altered``: every served id moved to the next class;
- the program with one fault planted (the attention's or the MLP's kernel
  swapped for its plain version with the fault in it, or the kernel fed the
  fault's operands):
  - ``fault_half_split_rope``: q and k rotated on the (j, j + 32) pairs of
    NeoX-style code in place of EVA's interleaved (2j, 2j + 1);
  - ``fault_rope_q_only``: k left unrotated;
  - ``fault_no_sub_ln``: the inner LayerNorm and the one over the hidden
    width both left out;
  - ``fault_k_bias``: the q bias added to k as well (a (3, C) bias read
    where EVA has none on k). It reads as the program does: under RoPE a k
    bias of the biases' std is a score term q·R(t)·b of a few hundredths,
    below what the served ids can show (PERF.md §2);
  - ``fault_gate_value_swapped``: silu on x·W2 + b2, times x·W1 + b1.

Each set carries ``correct``, the run's own verdict under the cell's
limits: the program's has to read true, every control's and fault's but
``fault_k_bias``'s false.
Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]


def half_split(x, tables, sign=1.0):
    """RoPE on the pairs (j, j + hd/2), the half-split pairing."""
    import torch

    cos, sin = tables[0], sign * tables[1]
    a, b = x.float().chunk(2, dim=-1)
    return torch.cat((a * cos - b * sin, b * cos + a * sin), dim=-1).to(x.dtype)


@contextlib.contextmanager
def plain_attention(**patches):
    """The RoPE attention through its plain version on the card, with
    ``patches`` on ``ops.cuda_attn``."""
    from beach_seg_tpu_torch.ops import cuda_attn

    with mock.patch.object(cuda_attn, "attn_qkv_rope", cuda_attn.attn_qkv_rope_plain), \
            mock.patch.multiple(cuda_attn, **patches):
        yield


def half_split_rope():
    return plain_attention(rope_rotate=half_split)


def _rope_qkv_with(rotate_k: bool, k_bias: bool):
    from beach_seg_tpu_torch.ops.attention import rope_rotate

    def rope_qkv(qkv4, qv_bias, tables, num_heads):
        b, s, _, c = qkv4.shape
        dt = qkv4.dtype
        heads = lambda t: t.reshape(b, s, num_heads, c // num_heads).transpose(1, 2)  # noqa: E731
        k = heads(qkv4[:, :, 1] + qv_bias[0].to(dt) if k_bias else qkv4[:, :, 1])
        return (rope_rotate(heads(qkv4[:, :, 0] + qv_bias[0].to(dt)), tables),
                rope_rotate(k, tables) if rotate_k else k, heads(qkv4[:, :, 2] + qv_bias[1].to(dt)))

    return rope_qkv


def rope_q_only():
    return plain_attention(_rope_qkv=_rope_qkv_with(rotate_k=False, k_bias=False))


def k_bias():
    return plain_attention(_rope_qkv=_rope_qkv_with(rotate_k=True, k_bias=True))


@contextlib.contextmanager
def no_sub_ln():
    """Every model built inside runs its blocks without the inner LayerNorm
    and the MLP without the one over the hidden width."""
    from torch import nn

    from beach_seg_tpu_torch.models.seggpt import model
    from beach_seg_tpu_torch.ops import cuda_mlp

    real = model.build_model

    def build(config, *args, **kwargs):
        built = real(config, *args, **kwargs)
        for att in built.modules():
            if isinstance(att, model.Attention) and hasattr(att, "inner_layernorm"):
                att.inner_layernorm = nn.Identity()
        return built

    def mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, ffn_scale, ffn_bias, w3, b3, eps):
        w1, b1, w2, b2, w3, b3 = (t.to(x.dtype) for t in (w1, b1, w2, b2, w3, b3))  # as the kernels round them
        ln, _, _ = cuda_mlp.ln_rows_plain(x, ln_scale, ln_bias, eps)
        return cuda_mlp.lin2_plain(cuda_mlp.swiglu_dual_plain(ln, w1, b1, w2, b2), w3, b3)

    with mock.patch.object(model, "build_model", build), mock.patch.object(cuda_mlp, "swiglu_mlp", mlp):
        yield


@contextlib.contextmanager
def gate_value_swapped():
    from beach_seg_tpu_torch.ops import cuda_mlp

    real = cuda_mlp.swiglu_mlp

    def swapped(x, ln_scale, ln_bias, w1, b1, w2, b2, *rest):
        return real(x, ln_scale, ln_bias, w2, b2, w1, b1, *rest)

    # the wrapper counts its launches and operand copies on the module's
    # name: the stand-in carries the counts while it is in place
    swapped.launches, swapped.operand_builds = real.launches, real.operand_builds
    try:
        with mock.patch.object(cuda_mlp, "swiglu_mlp", swapped):
            yield
    finally:
        real.launches, real.operand_builds = swapped.launches, swapped.operand_builds


FAULTS = {"fault_half_split_rope": half_split_rope, "fault_rope_q_only": rope_q_only, "fault_no_sub_ln": no_sub_ln,
          "fault_k_bias": k_bias, "fault_gate_value_swapped": gate_value_swapped}


def program_run(cell) -> tuple[dict, dict, list]:
    """Set-up, a window of ``cell.seconds`` and the check, as a run makes
    them (the program's objects released before the reference runs)."""
    from portbench import harness
    from portbench.drivers import eva02_predict_step as drv

    st = drv.setup(cell)
    res = drv.window(cell, st, cell.seconds)
    st.pop("tuner"), st.pop("call")
    harness.release(cell)
    return st, res, drv.check(cell, st, res)


def eva02_seed(cell, control: bool) -> dict:
    import numpy as np
    import torch

    from portbench.calibrate import judged, program
    from portbench.reference import eva02 as ref_eva02
    from portbench.reference import predict as ref_predict
    from portbench.traffic.eva02_weights import make_weights

    st, res, checks = program_run(cell)
    out = {"program": program(checks), "calls": len(res["ids"])}
    if not control:
        return out
    run, limits = cell.config["run"], cell.traffic["limits"]
    rng = np.random.default_rng([cell.seed, 4])
    n = len(res["ids"])
    picks = sorted(rng.choice(n, size=min(cell.traffic["check_calls"], n), replace=False).tolist())
    w = make_weights(cell.model, cell.config["weights"], cell.seed, cell.device)
    widest = altered = 0.0
    for i in picks:
        batch = st["pool"][i % len(st["pool"])]
        ref = ref_eva02.scores(w, cell.model, run, batch, st["prompts"], cell.device)
        low = ref_eva02.scores(w, cell.model, run, batch, st["prompts"], cell.device, ref_eva02.Precision("fp8"))
        widest = max(widest, ref_predict.widest_gap(ref, low.argmax(-1).cpu().numpy()))
        ids = (res["ids"][i].astype(np.int64) + 1) % len(run["classes"])
        altered = max(altered, ref_predict.widest_gap(ref, ids))
    del w
    out["control_fp8"] = judged({"id_gap_max": widest}, limits)
    out["fault_ids_altered"] = judged({"id_gap_max": altered}, limits)
    for name, fault in FAULTS.items():
        with fault():
            checks = program_run(cell)[2]
        out[name] = judged({k: v for k, v, _ in checks}, limits)
        if cell.on_card:
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate_eva02: no CUDA device", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        cell = harness.load_cell(args.workload, seed, args.seconds, False, torch.device("cuda"))
        out = eva02_seed(cell, seed in controls)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
