"""chip_smoke.py's limits for a bf16 forward attention kernel and for the
LN→MLP kernels against their plain versions, on the CPU: outputs that differ
from the plain ones by a bf16 neighbour at a few elements pass them, and the
errors that a kernel with a missing part would make (rel terms left out, a
slot chunk dropped, the padded keys past S left in every row's sum; for the
qkv-rel attention, the v bias left out; for the MLP, a K tile of W1 or a
hidden tile of W2 dropped, gelu' or the LN VJP's xhat term left out; for
the MLP stages' fp32 outputs, an LN statistic off by 1% or dln rounded to
bf16) fail them."""

import numpy as np
import pytest
import torch

import chip_smoke
from beach_seg_tpu_torch.ops.attention import attention_packed_plain, rel_tables_padded
from beach_seg_tpu_torch.ops.cuda_attn import attn_qkv_rel_plain
from beach_seg_tpu_torch.ops.cuda_mlp import (
    dln_plain,
    dual_dh_plain,
    ln_mlp_dx_plain,
    ln_mlp_plain,
    ln_rows_plain,
    ln_vjp_plain,
)

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


def _qkv_rel_inputs(seed=1):
    rng = np.random.default_rng(seed)
    gh, gw = GRID
    r = lambda *shape, sc=1.0: torch.from_numpy(sc * rng.standard_normal(shape, dtype=np.float32))  # noqa: E731
    qkv4, bias = r(1, gh * gw, 3, HEADS * HD).bfloat16(), r(3, HEADS * HD, sc=0.1).bfloat16()
    rh, rw = rel_tables_padded(r(2 * gh - 1, HD, sc=0.1), r(2 * gw - 1, HD, sc=0.1), GRID, GRID)
    return qkv4, bias, rh.bfloat16(), rw.bfloat16()


@pytest.mark.parametrize(
    "case,passes", [("neighbours", True), ("no_v_bias", False), ("no_rel_terms", False), ("dropped_chunk", False)]
)
def test_qkv_rel_bf16_limits(case, passes):
    """The faults of the bf16 qkv-rel kernel that `scripts/ablate_torch_kernels.py
    check` builds, made in its plain version (clamp softmax, the default):
    the v bias left out, the rel terms left out, rel_h's slot chunk 1 dropped."""
    qkv4, bias, rh, rw = _qkv_rel_inputs()
    call = lambda qkv4, bias, rh, rw: attn_qkv_rel_plain(qkv4, bias, rh, rw, HD**-0.5, GRID[1], HEADS, "clamp")  # noqa: E731
    want = call(qkv4, bias, rh, rw)
    if case == "neighbours":
        got = _neighbours(want)
    elif case == "no_v_bias":
        got = call(qkv4, torch.cat([bias[:2], torch.zeros_like(bias[2:])]), rh, rw)
    elif case == "no_rel_terms":
        got = call(qkv4, bias, torch.zeros_like(rh), torch.zeros_like(rw))
    else:
        rh = rh.clone()
        rh[:, 16:32] = 0
        got = call(qkv4, bias, rh, rw)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    assert chip_smoke.attn_within(chip_smoke.attn_errors(got, want), torch.bfloat16) is passes


def _mlp_inputs(seed=2, n=77, c=1024):
    rng = np.random.default_rng(seed)
    m = 4 * c
    r = lambda *shape, sc=1.0: torch.from_numpy(sc * rng.standard_normal(shape, dtype=np.float32))  # noqa: E731
    return (r(n, c).bfloat16(), 1 + r(c, sc=0.1), r(c, sc=0.1), r(c, m, sc=c**-0.5).bfloat16(), r(m, sc=0.1).bfloat16(),
            r(m, c, sc=m**-0.5).bfloat16(), r(c, sc=0.1).bfloat16(), r(n, c).bfloat16())


def _mlp_passes(got, want):
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    return chip_smoke.mlp_within(chip_smoke.attn_errors(got, want), chip_smoke.MLP_BF16_REL_TOL)


@pytest.mark.parametrize("case,passes", [("neighbours", True), ("drop_w1_k_tile", False), ("drop_w2_hidden_tile", False)])
def test_mlp_forward_limits(case, passes):
    """The faults of the LN→MLP forward that `scripts/ablate_torch_kernels.py
    check` builds, made in its plain version: the last 64-channel K tile of
    W1 left out of ln·W1, the last 128-unit hidden tile of W2 left out of
    h·W2."""
    x, ls, lb, w1, b1, w2, b2, _ = _mlp_inputs()
    want = ln_mlp_plain(x, ls, lb, w1, b1, w2, b2, 1e-6, True)
    if case == "neighbours":
        got = _neighbours(want)
    elif case == "drop_w1_k_tile":
        w1 = w1.clone()
        w1[-64:] = 0
        got = ln_mlp_plain(x, ls, lb, w1, b1, w2, b2, 1e-6, True)
    else:
        w2 = w2.clone()
        w2[-128:] = 0
        got = ln_mlp_plain(x, ls, lb, w1, b1, w2, b2, 1e-6, True)
    assert _mlp_passes(got, want) is passes


@pytest.mark.parametrize("case,passes", [("neighbours", True), ("no_gelu_grad", False), ("no_xhat_term", False)])
def test_mlp_dx_limits(case, passes):
    """The faults of the LN→MLP dx that the `check` mode builds, made in its
    stage plain versions: gelu' left out of dh, the xhat term left out of the
    LN VJP."""
    x, ls, lb, w1, b1, w2, _, g = _mlp_inputs()
    want = ln_mlp_dx_plain(x, ls, lb, w1, b1, w2, g, 1e-6, True)
    ln, mean, rstd = ln_rows_plain(x, ls, lb, 1e-6)
    if case == "neighbours":
        got = _neighbours(want)
    elif case == "no_gelu_grad":
        got = ln_vjp_plain(dln_plain((g.float() @ w2.float().T).bfloat16(), w1), x, ls, mean, rstd)
    else:
        dxh = dln_plain(dual_dh_plain(ln, g, w1, b1, w2, True), w1) * ls
        got = ((dxh - dxh.mean(-1, keepdim=True)) * rstd[:, None]).bfloat16()
    assert _mlp_passes(got, want) is passes


@pytest.mark.parametrize("output,case,passes", [
    ("mean", "exact", True), ("mean", "off_1pct", False),
    ("rstd", "exact", True), ("rstd", "off_1pct", False),
    ("dln", "exact", True), ("dln", "rounded_to_bf16", False),
])
def test_mlp_fp32_stage_limits(output, case, passes):
    """chip_smoke.py's limits for the MLP stages' fp32 outputs (the LN
    statistics, MLP_STATS_TOL; dln, MLP_DLN_TOL), made in the plain versions:
    the same output summed in float64 and rounded once to fp32 (an fp32 sum
    in another order, as the kernels' are) passes; an LN statistic off by 1%
    or a dln rounded to bf16 fails."""
    x, ls, lb, w1, b1, w2, _, g = _mlp_inputs()
    _, mean, rstd = ln_rows_plain(x, ls, lb, 1e-6)
    if output == "dln":
        dh = dual_dh_plain(ln_rows_plain(x, ls, lb, 1e-6)[0], g, w1, b1, w2, True)
        want, tol = dln_plain(dh, w1), chip_smoke.MLP_DLN_TOL
        exact = (dh.double() @ w1.double().T).float()
    else:
        xd = x.double()
        exact_mean = xd.mean(-1)
        exact_rstd = torch.rsqrt(((xd - exact_mean[:, None]) ** 2).mean(-1) + 1e-6)
        want, exact = (mean, exact_mean.float()) if output == "mean" else (rstd, exact_rstd.float())
        tol = chip_smoke.MLP_STATS_TOL
    if case == "exact":
        got = exact
    elif case == "off_1pct":
        got = want * 1.01
    else:
        got = want.bfloat16().float()
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    assert chip_smoke.mlp_within(chip_smoke.attn_errors(got, want), tol, tol) is passes
