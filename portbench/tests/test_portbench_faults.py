"""A run, its look for a card skipped, with the timed path broken under it:
``correct`` has to come out false for each fault the cells can have (an
answer altered where it is produced; a step that returns its state
unchanged; half of the batch left out, the mean taken over the rest). The
cells run on one card, so no exchange between chips can be left out. And
the controls, at a size a test holds: the reference one precision step
below the configuration's reads far above the program."""

from __future__ import annotations

import numpy as np
import torch

from portbench.tests.conftest import tiny_cell


def alter_ids(monkeypatch):
    from beach_seg_tpu_torch.train import PromptTuner

    real = PromptTuner.predict_step

    def altered(self, *args, **kwargs):
        ids = real(self, *args, **kwargs).clone()
        ids[:, ::7] = (ids[:, ::7] + 1) % len(self.conf.classes)
        return ids

    monkeypatch.setattr(PromptTuner, "predict_step", altered)


def test_ids_altered_where_produced(monkeypatch):
    from portbench.drivers import predict_step

    alter_ids(monkeypatch)
    assert not predict_step.run(tiny_cell("vit_l_bf16.predict_b8")).correct


def test_step_returns_state_unchanged(monkeypatch):
    from beach_seg_tpu_torch.train import PromptTuner

    from portbench.drivers import train_step

    real = PromptTuner.train_step

    def frozen(self, state, *args, **kwargs):
        before = (state.prompt_pixels.clone(), {k: (v.clone() if torch.is_tensor(v) else v)
                                                for k, v in state.opt_state.items()})
        state, out = real(self, state, *args, **kwargs)
        state.prompt_pixels, state.opt_state = before
        return state, out

    monkeypatch.setattr(PromptTuner, "train_step", frozen)
    out = train_step.run(tiny_cell("vit_h_fp32.tune_b8"))
    assert not out.correct
    assert dict((n, v) for n, v, _ in out.checks)["delta_leaf"] > 0.9


def test_half_the_batch_left_out(monkeypatch):
    from beach_seg_tpu_torch.train import PromptTuner

    from portbench.drivers import train_step

    real = PromptTuner.train_step

    def half(self, state, masks, nodata, batch, **kwargs):
        batch = dict(batch, valid=np.asarray(batch["valid"]) & (np.arange(len(batch["valid"])) < len(batch["valid"]) // 2))
        return real(self, state, masks, nodata, batch, **kwargs)

    monkeypatch.setattr(PromptTuner, "train_step", half)
    assert not train_step.run(tiny_cell("vit_h_fp32.tune_b8")).correct


def test_fp8_control_reads_far_above_the_program():
    """At these widths the scores span less than at the cell's, so the fp8
    control's verdict under the cell's limit is read at the cell's own size
    on the card (``test_portbench_gpu.py``); here it reads far above the
    program, and the altered ids fail the limit."""
    from portbench import calibrate

    out = calibrate.predict_seed(tiny_cell("vit_l_bf16.predict_b8", seconds=0.5), True)
    assert out["program"]["correct"] and not out["fault_ids_altered"]["correct"]
    assert out["control_fp8"]["id_gap_max"] > 3 * out["program"]["id_gap_max"]
    assert out["fault_ids_altered"]["id_gap_max"] > 3 * out["program"]["id_gap_max"]


def test_train_faults_in_the_reference_are_not_correct():
    """TF32 rounds only on the card, so the TF32 control's verdict is read
    there; the faults' verdicts hold anywhere."""
    from portbench import calibrate

    out = calibrate.train_seed(tiny_cell("vit_h_fp32.tune_b8", seconds=0.5), True)
    assert out["program"]["correct"]
    assert not out["fault_half_batch"]["correct"] and not out["fault_state_unchanged"]["correct"]
