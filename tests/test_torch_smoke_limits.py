"""chip_smoke.py's limits for a bf16 forward attention kernel against its
plain version, on the CPU: outputs that differ from the plain ones by a bf16
neighbour at a few elements pass them, and the errors that a kernel with a
missing part would make (rel terms left out, a slot chunk dropped, the
padded keys past S left in every row's sum) fail them."""

import numpy as np
import pytest
import torch

import chip_smoke
from beach_seg_tpu_torch.ops.attention import attention_packed_plain

GRID = chip_smoke.GRID_CROSS
HEADS, HD = 2, 64


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    gh, gw = GRID
    s = gh * gw
    r = lambda *shape, sc=1.0: torch.from_numpy(sc * rng.standard_normal(shape, dtype=np.float32)).bfloat16()  # noqa: E731
    return r(HEADS, s, HD), r(HEADS, s, HD), r(HEADS, s, HD), r(HEADS, s, gh, sc=0.5), r(HEADS, s, gw, sc=0.5)


def _neighbours(out):
    # every 100th element moved to its bf16 neighbour away from zero
    flat = out.flatten().clone()
    bits = flat[::100].view(torch.int16)
    flat[::100] = (bits + 1).view(torch.bfloat16)
    return flat.reshape(out.shape)


def _no_rel_terms(q, k, v, rh, rw):
    return attention_packed_plain(q, k, v, torch.zeros_like(rh), torch.zeros_like(rw), HD**-0.5, HEADS)


def _dropped_chunk(q, k, v, rh, rw):
    rh = rh.clone()
    rh[..., 16:32] = 0  # rel_h slot chunk 1 of every key
    return attention_packed_plain(q, k, v, rh, rw, HD**-0.5, HEADS)


def _padded_keys_in_sums(q, k, v, rh, rw):
    # 25 keys of score 0 and v 0 (999 = 15·64 + 39) in every row's sum
    s = q.shape[1]
    kidx = torch.arange(s)
    scores = (q.float() * HD**-0.5) @ k.float().transpose(-1, -2) + rh.float()[..., kidx // GRID[1]] + rw.float()[..., kidx % GRID[1]]
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    out = (p.bfloat16().float() @ v.float()) / (p.sum(-1, keepdim=True) + 25 * torch.exp(-m))
    return out.bfloat16().reshape(1, HEADS, s, HD).transpose(1, 2).reshape(1, s, HEADS * HD)


@pytest.mark.parametrize(
    "case,passes",
    [("neighbours", True), ("no_rel_terms", False), ("dropped_chunk", False), ("padded_keys_in_sums", False)],
)
def test_bf16_forward_limits(case, passes):
    args = _inputs()
    want = attention_packed_plain(*args, HD**-0.5, HEADS)
    if case == "neighbours":
        got = _neighbours(want)
    else:
        got = {"no_rel_terms": _no_rel_terms, "dropped_chunk": _dropped_chunk, "padded_keys_in_sums": _padded_keys_in_sums}[case](*args)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    assert chip_smoke.attn_within(chip_smoke.attn_errors(got, want), torch.bfloat16) is passes
