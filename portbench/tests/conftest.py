"""Shared pieces of the harness's own tests (run with
``python -m pytest portbench/tests``; the card-only ones with ``-m gpu`` on
the card)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA device; skips the test without one (decided here, never at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_cell(name: str, dtype: str | None = None, seconds: float = 0.5, trace: bool = False, seed: int = 2**33 + 5):
    """``name``'s cell on the CPU at a size a test holds: the debug
    backbone's widths (64, 4 heads) on a 128×64 canvas, crops of 32 at 64."""
    from portbench import harness

    cell = harness.load_cell(name, seed, seconds, trace, torch.device("cpu"))
    m = dict(cell.config["model"], hidden_size=64, num_hidden_layers=2, num_attention_heads=4, mlp_dim=256,
             image_size=[128, 64], pretrain_image_size=64, decoder_hidden_size=16, merge_index=0,
             intermediate_hidden_state_indices=[0, 1])
    cell.config = dict(cell.config, model=m, compute_dtype=dtype or cell.config["compute_dtype"],
                       run=dict(cell.config["run"], crop_size=32, inpt_size=64))
    cell.traffic = dict(cell.traffic, trace_seconds=seconds, pool=4)
    return cell

