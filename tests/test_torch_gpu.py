"""The port's CUDA kernels against their plain versions on the card, at one
ViT-L layer's shapes (#1 bf16 at every shape its paths run, and the body
its entry takes), at ViT-H's widths (head_dim 80, C=1280) and at ragged
small ones, the packed attention at ViT-H's widths and the scene engines'
batch rows, tiny bf16 and fp32 models (head_dim 64, and C=1280 with 16 heads
of 80) through the kernels forward and backward, the library's attention
entries, the shapes the kernels refuse, the scene engine (run_predict) and
the training runtime (run_training) against their own runs through the
plain versions, the grouped feature
ensemble at an odd batch, the device votes against the CPU's, a warm
forward that never waits on the card, and the fp32 linear products'
split-TF32 kernel (linear_f32) and its input gradient against an fp64
product at ViT-H's and ViT-L's shapes, with its launches and weight parts
a step.
Marked ``gpu``: they skip where no CUDA device is present (run them on the
card with ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt import build_model, tiny_config
from beach_seg_tpu_torch.ops import cuda_attn, cuda_gemm, cuda_mlp
from beach_seg_tpu_torch.ops.attention import (
    attention_bwd_plain,
    attention_fused_plain,
    attention_packed_plain,
    attention_qkv_plain,
    rel_tables_padded,
)
from beach_seg_tpu_torch.train import PromptTuner

pytestmark = pytest.mark.gpu

S_GRID = (56, 28)  # ViT-L: 896×448 canvas, 16-pixel patches
C, HEADS, MLP = 1024, 16, 4096
BF16_EPS = 2.0**-8
# a grid whose 64-key tiles cross rel_h slot chunks (16 rows of 27 keys), with
# a ragged last tile (999 = 15·64 + 39)
CROSS_GRID = (37, 27)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_attn_close(got, want):
    """A forward attention kernel against its plain version, with
    chip_smoke.py's limits: fp32 1e-4; bf16 3e-2 and two bf16 steps of
    max|plain|, and the error's norm within one rounding step of the
    output's (a kernel that drops a key tile, a slot chunk or the tail mask
    moves every row it reaches)."""
    d = got.float() - want.float()
    if got.dtype == torch.float32:
        assert d.abs().max().item() <= 1e-4
        return
    assert d.abs().max().item() <= min(3e-2, 4 * BF16_EPS * want.float().abs().max().item())
    assert (d.norm() / want.float().norm()).item() <= BF16_EPS


def _attn_inputs(dtype, device, batch=1, seed=0, grid=S_GRID, heads=HEADS):
    g = torch.Generator(device="cpu").manual_seed(seed)
    gh, gw = grid
    hd = C // HEADS
    c = heads * hd
    qkv = torch.randn((batch, gh * gw, 3, c), generator=g)
    bias = 0.1 * torch.randn((3, c), generator=g)
    rph = 0.1 * torch.randn((2 * gh - 1, hd), generator=g)
    rpw = 0.1 * torch.randn((2 * gw - 1, hd), generator=g)
    rh, rw = rel_tables_padded(rph, rpw, grid, grid)
    return [t.to(device=device, dtype=dtype).contiguous() for t in (qkv, bias, rh, rw)]


# bf16 (wgmma) and fp32 (split-TF32 products) in every softmax mode, B=2
# with 3 heads, on ragged grids (S not a multiple of the 64-key tile or the
# 8-key mma tile, a 64-wide row), a grid whose key tiles cross rel_h slot
# chunks, and ViT-L's (bf16 there at one layer: B=1, 16 heads)
_ATTN_CASES = [
    (dtype, softmax, grid)
    for dtype in (torch.bfloat16, torch.float32)
    for softmax in ("stable", "clamp", "fast")
    for grid in ((3, 5), (7, 4), (9, 64), CROSS_GRID, S_GRID)
]


@pytest.mark.parametrize("dtype,softmax,grid", _ATTN_CASES)
def test_attn_kernel_matches_plain(cuda, dtype, softmax, grid):
    """The qkv-rel attention (#1) against its plain version
    (``_assert_attn_close``)."""
    batch, heads = (1, HEADS) if dtype == torch.bfloat16 and grid == S_GRID else (2, 3)
    qkv, bias, rh, rw = _attn_inputs(dtype, cuda, batch=batch, grid=grid, heads=heads)
    args = (qkv, bias, rh, rw, 0.125, grid[1], heads, softmax)
    before = cuda_attn.attn_qkv_rel.launches
    got = cuda_attn.attn_qkv_rel(*args)
    torch.cuda.synchronize()
    assert cuda_attn.attn_qkv_rel.launches == before + 1
    want = cuda_attn.attn_qkv_rel_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape == (batch, grid[0] * grid[1], heads * (C // HEADS))
    _assert_attn_close(got, want)


# #1 bf16 at the shapes its paths run: the ViT-L grid at B = 1, 8 and 32 (a
# layer, the predict batch, the large predict batch), the crossing grid, 8
# heads (a rank of the two-rank model split), Painter's 14×14 windows at 64
# and 128 rows, and ragged small grids (a tile of 15 or 28 keys, a 64-wide
# row)
_WS_CASES = [(1, HEADS, S_GRID), (8, HEADS, S_GRID), (32, HEADS, S_GRID), (2, 3, CROSS_GRID), (8, 8, S_GRID),
             (64, HEADS, (14, 14)), (128, HEADS, (14, 14)), (2, 3, (3, 5)), (2, 3, (7, 4)), (2, 3, (9, 64))]


@pytest.mark.parametrize("softmax", ["stable", "clamp", "fast"])
@pytest.mark.parametrize("batch,heads,grid", _WS_CASES, ids=lambda x: str(x))
def test_attn_qkv_rel_ws_matches_plain(cuda, batch, heads, grid, softmax):
    """#1 bf16 (attn_ws.cuh's body) against the plain version at every shape
    of ``_WS_CASES`` in every softmax mode (``_assert_attn_close``)."""
    qkv, bias, rh, rw = _attn_inputs(torch.bfloat16, cuda, batch=batch, grid=grid, heads=heads)
    args = (qkv, bias, rh, rw, 0.125, grid[1], heads, softmax)
    got = cuda_attn.attn_qkv_rel(*args)
    torch.cuda.synchronize()
    want = cuda_attn.attn_qkv_rel_plain(*args)
    assert got.shape == want.shape == (batch, grid[0] * grid[1], heads * (C // HEADS))
    _assert_attn_close(got, want)


def test_attn_qkv_rel_takes_its_body_by_dtype(cuda):
    """The entry launches its kernel once a call in each dtype: bf16 (ws) at
    every shape of ``_WS_CASES``, fp32 at the ViT-L grid."""
    cases = [(torch.bfloat16, *case) for case in _WS_CASES] + [(torch.float32, 1, HEADS, S_GRID)]
    for dtype, batch, heads, grid in cases:
        args = (*_attn_inputs(dtype, cuda, batch=batch, grid=grid, heads=heads), 0.125, grid[1], heads)
        before = cuda_attn.attn_qkv_rel.launches
        out = cuda_attn.attn_qkv_rel(*args)
        assert cuda_attn.attn_qkv_rel.launches == before + 1, (dtype, batch, heads, grid)
        assert out.dtype == dtype
    torch.cuda.synchronize()


def test_ws_body_never_waits_on_the_card(cuda):
    """#1's ws body (three launches, its scratch from the caching allocator)
    under sync-debug mode ``"error"`` once its library is loaded."""
    args = (*_attn_inputs(torch.bfloat16, cuda, batch=2, grid=S_GRID), 0.125, S_GRID[1], HEADS)
    cuda_attn.attn_qkv_rel(*args)
    torch.cuda.synchronize()
    before = cuda_attn.attn_qkv_rel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = cuda_attn.attn_qkv_rel(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cuda_attn.attn_qkv_rel.launches == before + 1
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("c", [64, 256, C])  # the debug backbone's narrow width, the smallest stage-kernel width, ViT-L's
def test_mlp_kernel_matches_plain(cuda, c):
    g = torch.Generator(device="cpu").manual_seed(0)
    n, m = S_GRID[0] * S_GRID[1], 4 * c
    x = torch.randn((1, n, c), generator=g)
    ls, lb = 1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    w1, b1 = torch.randn((c, m), generator=g) / c**0.5, 0.1 * torch.randn(m, generator=g)
    w2, b2 = torch.randn((m, c), generator=g) / m**0.5, 0.1 * torch.randn(c, generator=g)
    bf = lambda t: t.to(device=cuda, dtype=torch.bfloat16)  # noqa: E731
    args = (bf(x), ls.to(cuda), lb.to(cuda), bf(w1), bf(b1), bf(w2), bf(b2), 1e-6, True)
    before = cuda_mlp.ln_mlp.launches
    got = cuda_mlp.ln_mlp(*args)
    torch.cuda.synchronize()
    assert cuda_mlp.ln_mlp.launches == before + 1
    want = cuda_mlp.ln_mlp_plain(*args)
    assert (got.float() - want.float()).abs().max().item() <= 4 * BF16_EPS * want.float().abs().max().item()


def test_tiny_bf16_model_on_card_matches_cpu(cuda):
    """head_dim 64, C=256: both kernels run, once per layer each; the card's
    pred_masks agree with the CPU plain path within bf16 rounding (at the
    default init range: larger random weights amplify rounding differences
    layer over layer)."""
    cfg = tiny_config(hidden_size=256, num_attention_heads=4)
    rng = np.random.default_rng(0)
    h, w = cfg.image_size[0] // 2, cfg.image_size[1]
    inputs = [torch.from_numpy(rng.standard_normal((2, h, w, 3)).astype(np.float32)) for _ in range(3)]
    cpu = build_model(cfg, torch.bfloat16, device="cpu", seed=1)
    gpu = build_model(cfg, torch.bfloat16, device=cuda, seed=1)
    a0, m0 = cuda_attn.attn_qkv_rel.launches, cuda_mlp.ln_mlp.launches
    with torch.inference_mode():
        want = cpu(*inputs, decode_query_only=True)["pred_masks"]
        got = gpu(*(t.to(cuda) for t in inputs), decode_query_only=True)["pred_masks"].cpu()
    assert cuda_attn.attn_qkv_rel.launches - a0 == cfg.num_hidden_layers
    assert cuda_mlp.ln_mlp.launches - m0 == cfg.num_hidden_layers
    assert (got - want).abs().max().item() <= 8 * BF16_EPS * want.abs().max().item()


def _packed_inputs(device, dtype, bh, hk, wk, d, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = hk * wk
    r = lambda *sh, sc=1.0: (sc * torch.randn(sh, generator=g)).to(device=device, dtype=dtype)  # noqa: E731
    return r(bh, s, d), r(bh, s, d), r(bh, s, d), r(bh, s, hk, sc=0.5), r(bh, s, wk, sc=0.5)


@pytest.mark.parametrize("hk,wk", [(3, 5), (7, 4), (56, 28), CROSS_GRID])  # ragged tiles; the ViT-L/H grid; crossing chunks
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_attn_packed_kernel_matches_plain(cuda, dtype, d, hk, wk):
    """The packed attention (B=2, 3 heads) against its plain version
    (``_assert_attn_close``)."""
    args = (*_packed_inputs(cuda, dtype, 6, hk, wk, d), d**-0.5, 3)
    before = cuda_attn.attn_packed.launches
    got = cuda_attn.attn_packed(*args)
    torch.cuda.synchronize()
    assert cuda_attn.attn_packed.launches == before + 1
    want = attention_packed_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape == (2, hk * wk, 3 * d)
    _assert_attn_close(got, want)


@pytest.mark.parametrize("rows", [8, 3])  # run_predict's batch; the odd tail of chip_smoke.py's scene (19 crops)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_attn_packed_at_vit_h_engine_rows(cuda, dtype, rows):
    """The packed attention at ViT-H's widths (16 heads of 80 on the 56×28
    grid) at the rows of a scene engine's batch, against its plain version
    (``_assert_attn_close``)."""
    args = (*_packed_inputs(cuda, dtype, rows * HEADS, *S_GRID, 80, seed=rows), 80**-0.5, HEADS)
    before = cuda_attn.attn_packed.launches
    got = cuda_attn.attn_packed(*args)
    torch.cuda.synchronize()
    assert cuda_attn.attn_packed.launches == before + 1
    want = attention_packed_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape == (rows, S_GRID[0] * S_GRID[1], HEADS * 80)
    _assert_attn_close(got, want)


def _bwd_inputs(device, bh, hk, wk, seed=0, d=64):
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = hk * wk
    r = lambda *sh, sc=1.0: (sc * torch.randn(sh, generator=g)).to(device=device, dtype=torch.bfloat16)  # noqa: E731
    return r(bh, s, d), r(bh, s, d), r(bh, s, d), r(bh, s, hk, sc=0.5), r(bh, s, wk, sc=0.5), r(bh, s, d)


# one ViT-L / ViT-H image; ragged tiles
@pytest.mark.parametrize("bh,hk,wk,d", [(16, 56, 28, 64), (3, 5, 7, 64), (2, 9, 64, 64), (16, 56, 28, 80), (3, 5, 7, 80), (2, 7, 4, 80),
                                        (4, *CROSS_GRID, 64), (4, *CROSS_GRID, 80)])
def test_attn_bwd_kernel_matches_plain(cuda, bh, hk, wk, d):
    """p and dS are bf16 mma operands in the kernel: 1% of each output's
    scale for dq/dk/dv; drh/drw sum fp32 dS and round once: 2 bf16 steps."""
    args = (*_bwd_inputs(cuda, bh, hk, wk, d=d), d**-0.5)
    before = cuda_attn.attn_bwd.launches
    got = cuda_attn.attn_bwd(*args)
    torch.cuda.synchronize()
    assert cuda_attn.attn_bwd.launches == before + 1
    want = attention_bwd_plain(*args)
    for name, a, w in zip(("dq", "dk", "dv", "drh", "drw"), got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        tol = (2 * BF16_EPS if name in ("drh", "drw") else 1e-2) * w.float().abs().max().item()
        assert (a.float() - w.float()).abs().max().item() <= tol, name


# the head dims of tiny_config (8, zero-padded to 16 by the wrappers) and of
# the debug backbone (16), on ragged grids, the ViT grid and one that crosses chunks
@pytest.mark.parametrize("hk,wk", [(3, 5), (7, 4), (56, 28), CROSS_GRID])
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("kernel", ["attn_packed", "attn_fused", "attn_bwd"])
def test_small_head_dim_kernels_match_plain(cuda, kernel, dtype, d, hk, wk):
    """#3, #7 and #4 at head dims 8 and 16 (B=2, 3 heads) against their
    plain versions, with the tolerances of head dims 64 and 80."""
    q, k, v, rh, rw = _packed_inputs(cuda, dtype, 6, hk, wk, d)
    bf16 = dtype == torch.bfloat16
    if kernel == "attn_bwd":
        g = _packed_inputs(cuda, dtype, 6, hk, wk, d, seed=1)[0]
        args = (q, k, v, rh, rw, g, d**-0.5)
        names = ("dq", "dk", "dv", "drh", "drw")
    else:
        args = (q, k, v, rh, rw, d**-0.5) + ((3,) if kernel == "attn_packed" else ())
        names = ("out",)
    fn = getattr(cuda_attn, kernel)
    plain = {"attn_packed": attention_packed_plain, "attn_fused": attention_fused_plain, "attn_bwd": attention_bwd_plain}[kernel]
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args)
    got, want = (got, want) if kernel == "attn_bwd" else ((got,), (want,))
    for name, a, w in zip(names, got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        if kernel != "attn_bwd":
            _assert_attn_close(a, w)
            continue
        tol = ((2 * BF16_EPS if name in ("drh", "drw") else 1e-2) if bf16 else 1e-4) * w.float().abs().max().item()
        assert (a.float() - w.float()).abs().max().item() <= tol, name


def test_attn_bwd_bf16_is_bitwise_repeatable(cuda):
    """No atomics and every sum in a fixed order: two runs of #4 bf16 on the
    same inputs (ViT-L's grid) give the same bits."""
    args = (*_bwd_inputs(cuda, 16, 56, 28), 0.125)
    first = cuda_attn.attn_bwd(*args)
    second = cuda_attn.attn_bwd(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "drh", "drw"), first, second):
        assert torch.equal(a, b), name


def _debug_model(device, dtype):
    from beach_seg_tpu_torch.train.loop import model_for_config

    conf = BeachSegConfig(debug=True, batch_size=2, compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    model, cfg = model_for_config(conf, device=device, seed=0)
    assert cfg.head_dim == 16
    return model, conf


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_debug_backbone_predict_and_train_on_card(cuda, dtype):
    """The debug backbone (C=64, 4 heads of 16) through PromptTuner on the
    card: predict_step runs #3 once per layer, train_step #3 and #4 once per
    layer each; pred_masks and one step's prompt gradient agree with the same
    calls through the plain versions within the ViT-L limits (bf16: 5% of the
    output's scale, 1 − cosine ≤ 1e-3; fp32: 1e-4, 1 − cosine ≤ 1e-5)."""
    from beach_seg_tpu_torch.ops import attention

    model, conf = _debug_model(cuda, dtype)
    n_layers = model.config.num_hidden_layers
    tuner = PromptTuner(model, conf, device=cuda)
    rng = np.random.default_rng(0)
    size = conf.inpt_size
    prompts = (rng.random((2, size, size, 3), dtype=np.float32), rng.integers(0, len(conf.classes), (2, size, size)).astype(np.int32),
               np.zeros((2, size, size), bool))
    batch = {"image_u8": rng.integers(0, 256, (2, conf.crop_size, conf.crop_size, 3), dtype=np.uint8),
             "crop_idx": np.array([0, 1], np.int32)}
    before = cuda_attn.attn_packed.launches
    ids = tuner.predict_step(*prompts, batch, out_size=conf.crop_size)
    torch.cuda.synchronize()
    assert cuda_attn.attn_packed.launches - before == n_layers
    assert ids.shape == (2, conf.crop_size, conf.crop_size)

    tbatch = {"image": rng.random((2, size, size, 3), dtype=np.float32),
              "mask": rng.integers(0, len(conf.classes), (2, size, size)).astype(np.int32),
              "nodata": np.zeros((2, size, size), bool), "crop_idx": np.array([0, 1], np.int32),
              "valid": np.ones((2,), bool)}
    state = tuner.init_state(prompts[0])
    p0, b0 = cuda_attn.attn_packed.launches, cuda_attn.attn_bwd.launches
    state, metrics = tuner.train_step(state, prompts[1], prompts[2], tbatch, generator=torch.Generator(device=cuda).manual_seed(0))
    assert np.isfinite(metrics["loss"].item())
    assert cuda_attn.attn_packed.launches - p0 == n_layers and cuda_attn.attn_bwd.launches - b0 == n_layers

    draws = tuner.step_draws(tbatch, 2, torch.Generator(device=cuda).manual_seed(7))
    _, grad, _, _, _ = tuner.loss_and_grad(state.prompt_pixels, prompts[1], prompts[2], tbatch, draws)
    saved = cuda_attn.attn_packed, cuda_attn.attn_bwd
    cuda_attn.attn_packed, cuda_attn.attn_bwd = attention.attention_packed_plain, attention.attention_bwd_plain
    try:
        _, want, _, _, _ = tuner.loss_and_grad(state.prompt_pixels, prompts[1], prompts[2], tbatch, draws)
    finally:
        cuda_attn.attn_packed, cuda_attn.attn_bwd = saved
    cos = torch.nn.functional.cosine_similarity(grad.flatten().float(), want.flatten().float(), dim=0).item()
    bf16 = dtype == torch.bfloat16
    assert torch.isfinite(grad).all()
    assert 1 - cos <= (1e-3 if bf16 else 1e-5)
    assert (grad - want).abs().max().item() <= (5e-2 if bf16 else 1e-3) * want.abs().max().item()


@pytest.mark.parametrize("n,c", [(S_GRID[0] * S_GRID[1], C), (77, 256), (100, 768), (77, 64), (100, 128)])
def test_mlp_dx_kernel_matches_plain(cuda, n, c):
    g = torch.Generator(device="cpu").manual_seed(0)
    m = 4 * c
    x = torch.randn((1, n, c), generator=g)
    ls, lb = 1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    w1, b1 = torch.randn((c, m), generator=g) / c**0.5, 0.1 * torch.randn(m, generator=g)
    w2 = torch.randn((m, c), generator=g) / m**0.5
    gy = torch.randn((1, n, c), generator=g)
    bf = lambda t: t.to(device=cuda, dtype=torch.bfloat16)  # noqa: E731
    for approx in (True, False):
        args = (bf(x), ls.to(cuda), lb.to(cuda), bf(w1), bf(b1), bf(w2), bf(gy), 1e-6, approx)
        before = cuda_mlp.ln_mlp_dx.launches
        got = cuda_mlp.ln_mlp_dx(*args)
        torch.cuda.synchronize()
        assert cuda_mlp.ln_mlp_dx.launches == before + 1
        want = cuda_mlp.ln_mlp_dx_plain(*args)
        assert (got.float() - want.float()).abs().max().item() <= 4 * BF16_EPS * want.float().abs().max().item()


@pytest.mark.parametrize("n", [S_GRID[0] * S_GRID[1] + 9, 45])  # not a multiple of the 128-row tile
def test_mlp_kernels_at_vit_h_width(cuda, n):
    """C=1280, M=5120 (ViT-H): the forward and dx stage chains at a ragged
    last 128-row tile, against their plain versions within four bf16 steps
    of the output's scale."""
    g = torch.Generator(device="cpu").manual_seed(1)
    c, m = 1280, 5120
    x = torch.randn((n, c), generator=g)
    ls, lb = 1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    w1, b1 = torch.randn((c, m), generator=g) / c**0.5, 0.1 * torch.randn(m, generator=g)
    w2, b2 = torch.randn((m, c), generator=g) / m**0.5, 0.1 * torch.randn(c, generator=g)
    gy = torch.randn((n, c), generator=g)
    bf = lambda t: t.to(device=cuda, dtype=torch.bfloat16)  # noqa: E731
    head = (bf(x), ls.to(cuda), lb.to(cuda), bf(w1), bf(b1), bf(w2))
    for fn, plain, last in ((cuda_mlp.ln_mlp, cuda_mlp.ln_mlp_plain, bf(b2)), (cuda_mlp.ln_mlp_dx, cuda_mlp.ln_mlp_dx_plain, bf(gy))):
        before = fn.launches
        got = fn(*head, last, 1e-6, True)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        want = plain(*head, last, 1e-6, True)
        assert (got.float() - want.float()).abs().max().item() <= 4 * BF16_EPS * want.float().abs().max().item(), fn.__name__


def _vith_tiny():
    # ViT-H's width and heads (C=1280, 16 heads of 80) at 3 layers on a 8×4 grid
    return tiny_config(hidden_size=1280, num_attention_heads=16, num_hidden_layers=3, merge_index=1,
                       intermediate_hidden_state_indices=(1, 2))


def test_vith_width_bf16_model_on_card_matches_cpu(cuda):
    """The packed attention and the MLP kernel run once per layer each (the
    qkv-rel kernel never); the card's pred_masks agree with the CPU plain
    path within eight bf16 steps of the scale, as the head_dim-64 model."""
    cfg = _vith_tiny()
    rng = np.random.default_rng(0)
    h, w = cfg.image_size[0] // 2, cfg.image_size[1]
    inputs = [torch.from_numpy(rng.standard_normal((2, h, w, 3)).astype(np.float32)) for _ in range(3)]
    cpu = build_model(cfg, torch.bfloat16, device="cpu", seed=1)
    gpu = build_model(cfg, torch.bfloat16, device=cuda, seed=1)
    a0, p0, m0 = cuda_attn.attn_qkv_rel.launches, cuda_attn.attn_packed.launches, cuda_mlp.ln_mlp.launches
    with torch.inference_mode():
        want = cpu(*inputs, decode_query_only=True)["pred_masks"]
        got = gpu(*(t.to(cuda) for t in inputs), decode_query_only=True)["pred_masks"].cpu()
    assert cuda_attn.attn_qkv_rel.launches == a0
    assert cuda_attn.attn_packed.launches - p0 == cfg.num_hidden_layers
    assert cuda_mlp.ln_mlp.launches - m0 == cfg.num_hidden_layers
    assert (got - want).abs().max().item() <= 8 * BF16_EPS * want.abs().max().item()


def test_vith_width_bf16_backward_on_card_launches_kernels(cuda):
    """C=1280, 16 heads of 80, labels and drop-path: the input gradient runs
    the attention backward and the MLP dx kernels once per layer each and
    agrees in direction with the CPU plain path."""
    cfg = _vith_tiny()
    rng = np.random.default_rng(0)
    h, w = cfg.image_size[0] // 2, cfg.image_size[1]
    x, px, pm, lab = (torch.from_numpy(rng.standard_normal((2, h, w, 3)).astype(np.float32)) for _ in range(4))
    grads = []
    for dev in ("cpu", cuda):
        model = build_model(cfg, torch.bfloat16, device=dev, seed=1)
        masks = model.sample_drop_masks(torch.Generator(device="cpu").manual_seed(0), 2)
        masks = [tuple(None if m is None else m.to(dev) for m in pair) for pair in masks]
        leaf = px.to(dev).requires_grad_(True)
        a0, m0 = cuda_attn.attn_bwd.launches, cuda_mlp.ln_mlp_dx.launches
        out = model(x.to(dev), leaf, pm.to(dev), labels=lab.to(dev), deterministic=False, drop_masks=masks, decode_query_only=True)
        (gr,) = torch.autograd.grad(out["loss"], leaf)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert cuda_attn.attn_bwd.launches - a0 == cfg.num_hidden_layers
            assert cuda_mlp.ln_mlp_dx.launches - m0 == cfg.num_hidden_layers
        grads.append(gr.float().cpu().flatten())
    assert torch.isfinite(grads[1]).all()
    assert torch.nn.functional.cosine_similarity(grads[0], grads[1], dim=0).item() >= 0.99


def test_tiny_bf16_backward_on_card_launches_kernels(cuda):
    """head_dim 64, C=256, labels and drop-path: the input gradient runs the
    two backward kernels once per layer each and agrees in direction with
    the CPU plain path."""
    cfg = tiny_config(hidden_size=256, num_attention_heads=4)
    rng = np.random.default_rng(0)
    h, w = cfg.image_size[0] // 2, cfg.image_size[1]
    x, px, pm, lab = (torch.from_numpy(rng.standard_normal((2, h, w, 3)).astype(np.float32)) for _ in range(4))
    grads = []
    for dev in ("cpu", cuda):
        model = build_model(cfg, torch.bfloat16, device=dev, seed=1)
        masks = model.sample_drop_masks(torch.Generator(device="cpu").manual_seed(0), 2)
        masks = [tuple(None if m is None else m.to(dev) for m in pair) for pair in masks]
        leaf = px.to(dev).requires_grad_(True)
        a0, m0 = cuda_attn.attn_bwd.launches, cuda_mlp.ln_mlp_dx.launches
        out = model(x.to(dev), leaf, pm.to(dev), labels=lab.to(dev), deterministic=False, drop_masks=masks, decode_query_only=True)
        (gr,) = torch.autograd.grad(out["loss"], leaf)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert cuda_attn.attn_bwd.launches - a0 == cfg.num_hidden_layers
            assert cuda_mlp.ln_mlp_dx.launches - m0 == cfg.num_hidden_layers
        grads.append(gr.float().cpu().flatten())
    assert torch.isfinite(grads[1]).all()
    assert torch.nn.functional.cosine_similarity(grads[0], grads[1], dim=0).item() >= 0.99


def test_backward_kernels_raise_on_shapes_they_do_not_take(cuda):
    q, k, v, rh, rw, g = _bwd_inputs(cuda, 2, 4, 8)
    with pytest.raises(ValueError, match="head_dim 8 or 16 or 64 or 80"):
        cuda_attn.attn_bwd(q[..., :32], k[..., :32], v[..., :32], rh, rw, g[..., :32], 0.1)
    with pytest.raises(ValueError, match="attn_packed kernel"):
        cuda_attn.attn_packed(q[..., :32], k[..., :32], v[..., :32], rh, rw, 0.1, 1)
    with pytest.raises(ValueError, match="bf16"):
        cuda_attn.attn_bwd(q.float(), k, v, rh, rw, g, 0.1)
    x = torch.zeros((4, 200), device=cuda, dtype=torch.bfloat16)
    w1 = torch.zeros((200, 800), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C % 256"):
        cuda_mlp.ln_mlp_dx(x, torch.ones(200, device=cuda), torch.zeros(200, device=cuda), w1,
                           torch.zeros(800, device=cuda, dtype=torch.bfloat16), w1.T.contiguous(), x, 1e-6, True)


@pytest.mark.parametrize("hk,wk", [(3, 5), (7, 4), (56, 28), CROSS_GRID])  # ragged tiles; the ViT-L/H grid; crossing chunks
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_attn_fused_kernel_matches_plain(cuda, dtype, d, hk, wk):
    """The basic fused attention (port of _kernel, head-split out) against
    its plain version (``_assert_attn_close``; the kernel rounds p before its
    division, the plain version after)."""
    q, k, v, rh, rw = _packed_inputs(cuda, dtype, 6, hk, wk, d)
    before = cuda_attn.attn_fused.launches
    got = cuda_attn.attn_fused(q, k, v, rh, rw, d**-0.5)
    torch.cuda.synchronize()
    assert cuda_attn.attn_fused.launches == before + 1
    want = attention_fused_plain(q, k, v, rh, rw, d**-0.5)
    assert got.dtype == dtype and got.shape == want.shape == (6, hk * wk, d)
    _assert_attn_close(got, want)


def _qkv_slot_inputs(device, dtype, b, nh, hk, wk, seed=0):
    """qkv (B, S, 3·nH·64) and rel_h64 / rel_w64 (B, S, nH·64) with zero
    unused slots, as rel_pos_terms_split makes them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = hk * wk
    qkv = torch.randn((b, s, 3 * nh * 64), generator=g)
    slots = []
    for n in (hk, wk):
        t = torch.zeros((b, s, nh, 64))
        t[..., :n] = 0.5 * torch.randn((b, s, nh, n), generator=g)
        slots.append(t.reshape(b, s, nh * 64))
    return [t.to(device=device, dtype=dtype) for t in (qkv, *slots)]


@pytest.mark.parametrize("hk,wk", [(3, 5), (7, 4), (56, 28), CROSS_GRID])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_attn_qkv_kernel_matches_plain(cuda, dtype, hk, wk):
    """The qkv-layout attention (port of _kernel_qkv: q, k, v by stride from
    (B, S, 3C), 64-slot rel terms, merged out) at B=2, 3 heads of 64."""
    qkv, rh64, rw64 = _qkv_slot_inputs(cuda, dtype, 2, 3, hk, wk)
    args = (qkv, rh64, rw64, 0.125, hk, wk, 3)
    before = cuda_attn.attn_qkv.launches
    got = cuda_attn.attn_qkv(*args)
    torch.cuda.synchronize()
    assert cuda_attn.attn_qkv.launches == before + 1
    want = attention_qkv_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape == (2, hk * wk, 3 * 64)
    _assert_attn_close(got, want)


# one ViT-L / ViT-H image; ragged tiles (S=35 is not a multiple of 8) at both head dims
@pytest.mark.parametrize("bh,hk,wk,d", [(16, 56, 28, 64), (3, 5, 7, 64), (2, 9, 64, 64), (16, 56, 28, 80), (2, 7, 4, 80),
                                        (3, 5, 7, 80), (4, *CROSS_GRID, 64), (4, *CROSS_GRID, 80)])
def test_attn_bwd_fp32_kernel_matches_plain(cuda, bh, hk, wk, d):
    """The fp32 attention backward: split-TF32 products on the tensor cores
    (~2^-21 relative a product, each step's sum added in fp32) against full
    fp32 ones, sums over S in another order: a few e-6 of each output's
    scale; 1e-4 of it."""
    args = (*(t.float() for t in _bwd_inputs(cuda, bh, hk, wk, d=d)), d**-0.5)
    before = cuda_attn.attn_bwd.launches
    got = cuda_attn.attn_bwd(*args)
    torch.cuda.synchronize()
    assert cuda_attn.attn_bwd.launches == before + 1
    want = attention_bwd_plain(*args)
    for name, a, w in zip(("dq", "dk", "dv", "drh", "drw"), got, want):
        assert a.dtype == w.dtype == torch.float32 and a.shape == w.shape, name
        assert (a - w).abs().max().item() <= 1e-4 * w.abs().max().item(), name


def test_library_attention_kernels_raise_on_what_they_do_not_take(cuda):
    """No instance, no launch: a head dim, a dtype or a mix of dtypes the
    kernels were not built for raises on the card."""
    q, k, v, rh, rw, g = _bwd_inputs(cuda, 2, 4, 8)
    with pytest.raises(ValueError, match="attn_fused kernel .*head_dim 8 or 16 or 64 or 80"):
        cuda_attn.attn_fused(q[..., :32], k[..., :32], v[..., :32], rh, rw, 0.1)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        cuda_attn.attn_fused(q.half(), k.half(), v.half(), rh.half(), rw.half(), 0.1)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        cuda_attn.attn_bwd(*(t.half() for t in (q, k, v, rh, rw, g)), 0.1)
    qkv, rh64, rw64 = _qkv_slot_inputs(cuda, torch.bfloat16, 1, 2, 4, 8)
    with pytest.raises(ValueError, match="attn_qkv kernel .*head_dim 64"):
        cuda_attn.attn_qkv(qkv, rh64, rw64, 0.1, 4, 8, 4)  # 2·64 columns as 4 heads of 32
    with pytest.raises(TypeError, match="bf16 or fp32"):
        cuda_attn.attn_qkv(qkv.half(), rh64, rw64, 0.1, 4, 8, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("entry", ["fused_attention", "fused_attention_qkv"])
def test_attention_entries_on_card(cuda, entry, dtype):
    """Forward and backward through the library entries launch the forward
    kernel once and the attention backward once, and their gradients agree
    with the same entry on the CPU (plain versions): fp32 within 1e-4 of
    each gradient's scale, bf16 within 2% (p and dS are bf16 operands)."""
    if entry == "fused_attention":
        hk, wk, d = 8, 4, 64
        inputs = _packed_inputs("cpu", dtype, 4, hk, wk, d)
        fn, fwd = (lambda *a: cuda_attn.fused_attention(*a, d**-0.5, hk, wk)), cuda_attn.attn_fused
        out_shape = (4, hk * wk, d)
    else:
        hk, wk, nh = 8, 4, 2
        inputs = _qkv_slot_inputs("cpu", dtype, 2, nh, hk, wk)
        fn, fwd = (lambda *a: cuda_attn.fused_attention_qkv(*a, 0.125, hk, wk, nh)), cuda_attn.attn_qkv
        out_shape = (2, hk * wk, nh * 64)
    g = torch.randn(out_shape, generator=torch.Generator().manual_seed(5)).to(dtype)
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_(True) for t in inputs]
        f0, b0 = fwd.launches, cuda_attn.attn_bwd.launches
        out = fn(*leaves)
        gr = torch.autograd.grad(out, leaves, g.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (fwd.launches - f0, cuda_attn.attn_bwd.launches - b0) == (1, 1)
        grads.append([t.float().cpu() for t in gr])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for want, got in zip(*grads):
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def _hd64_fp32_tiny():
    # head_dim 64 (the qkv-rel kernel's path), two layers, fp32 (the default compute dtype)
    return tiny_config(hidden_size=128, num_attention_heads=2, num_hidden_layers=2, merge_index=0,
                       intermediate_hidden_state_indices=(1,), initializer_range=0.2)


def test_fp32_backward_on_card_matches_cpu(cuda):
    """fp32: the input gradient runs the fp32 forward attention and the fp32
    attention backward once per layer each (the MLP stays plain torch under
    fp32) and agrees with the CPU plain path to fp32 precision."""
    cfg = _hd64_fp32_tiny()
    rng = np.random.default_rng(0)
    h, w = cfg.image_size[0] // 2, cfg.image_size[1]
    x, px, pm, lab = (torch.from_numpy(rng.standard_normal((2, h, w, 3)).astype(np.float32)) for _ in range(4))
    grads = []
    for dev in ("cpu", cuda):
        model = build_model(cfg, torch.float32, device=dev, seed=1)
        leaf = px.to(dev).requires_grad_(True)
        a0, b0, m0 = cuda_attn.attn_qkv_rel.launches, cuda_attn.attn_bwd.launches, cuda_mlp.ln_mlp.launches
        out = model(x.to(dev), leaf, pm.to(dev), labels=lab.to(dev), decode_query_only=True)
        (gr,) = torch.autograd.grad(out["loss"], leaf)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert cuda_attn.attn_qkv_rel.launches - a0 == cfg.num_hidden_layers
            assert cuda_attn.attn_bwd.launches - b0 == cfg.num_hidden_layers
            assert cuda_mlp.ln_mlp.launches == m0
        grads.append(gr.cpu().flatten())
    assert torch.isfinite(grads[1]).all()
    assert 1 - torch.nn.functional.cosine_similarity(grads[0], grads[1], dim=0).item() <= 1e-5
    assert (grads[1] - grads[0]).abs().max().item() <= 1e-3 * grads[0].abs().max().item()


@pytest.mark.parametrize("hidden,fwd", [(128, "attn_qkv_rel"), (160, "attn_packed")], ids=["hd64", "hd80"])
def test_fp32_train_step_on_card(cuda, hidden, fwd):
    """One PromptTuner.train_step of a 2-layer fp32 model on the card (the
    default BeachSegConfig compute dtype) runs without raising, through the
    fp32 forward attention (qkv-rel at head_dim 64, packed at ViT-H's 80) and
    the fp32 attention backward."""
    cfg = _hd64_fp32_tiny() if hidden == 128 else tiny_config(
        hidden_size=160, num_attention_heads=2, num_hidden_layers=2, merge_index=0,
        intermediate_hidden_state_indices=(1,), initializer_range=0.2)
    size = cfg.image_size[1]
    conf = BeachSegConfig(batch_size=2, inpt_size=size)
    assert conf.compute_dtype == "float32"
    model = build_model(cfg, torch.float32, device=cuda, seed=1)
    tuner = PromptTuner(model, conf, device=cuda)
    rng = np.random.default_rng(0)
    n = len(conf.classes)
    state = tuner.init_state(rng.random((2, size, size, 3), dtype=np.float32))
    batch = {
        "image": rng.random((2, size, size, 3), dtype=np.float32),
        "mask": rng.integers(0, n, (2, size, size)).astype(np.int32),
        "nodata": np.zeros((2, size, size), bool),
        "crop_idx": np.array([0, 1], np.int32),
        "valid": np.ones((2,), bool),
    }
    a0, b0 = getattr(cuda_attn, fwd).launches, cuda_attn.attn_bwd.launches
    state, metrics = tuner.train_step(state, rng.integers(0, n, (2, size, size)).astype(np.int32),
                                      np.zeros((2, size, size), bool), batch, generator=torch.Generator(device=cuda).manual_seed(0))
    assert np.isfinite(metrics["loss"].item())
    assert torch.isfinite(state.prompt_pixels).all()
    assert getattr(cuda_attn, fwd).launches > a0 and cuda_attn.attn_bwd.launches > b0


@pytest.mark.parametrize("hidden,dtype,fwd,painter", [(128, torch.bfloat16, "attn_qkv_rel", {}),
                                                      (160, torch.float32, "attn_packed", {}),
                                                      (128, torch.bfloat16, "attn_qkv_rel",
                                                       dict(window_size=3, global_attn_indexes=(1,), type_tokens=False)),
                                                      (256, torch.bfloat16, "attn_qkv_rope",
                                                       dict(num_attention_heads=4, mlp_dim=682, block="eva02",
                                                            use_relative_position_embeddings=False,
                                                            pretrain_image_size=16))],
                         ids=["hd64_bf16", "hd80_fp32", "painter_hd64_bf16", "eva02_hd64_bf16"])
def test_warm_forward_never_waits_on_the_card(cuda, hidden, dtype, fwd, painter):
    """A 2-layer SegGPT through #1 (head_dim 64, C=128, bf16) and through #3
    (head_dim 80, fp32), and a 2-layer Painter through #1 (block 0 in 3×3
    windows, which pad the 8×4 grid to 9×6; block 1 global), and a 2-layer
    EVA-02 through the RoPE attention and the SwiGLU MLP (C=256, head_dim
    64, bf16), on a grid whose abs-pos table is resized: once one forward
    has put its shape constants on the card (the rel-pos indices of each
    grid, the resize matrices, the masked-position mask, the RoPE tables), a
    second forward runs under sync-debug mode ``"error"`` without a single
    operation that waits on the card."""
    cfg = tiny_config(**{"hidden_size": hidden, "num_attention_heads": 2, "num_hidden_layers": 2, "merge_index": 0,
                         "intermediate_hidden_state_indices": (1,), **painter})
    model = build_model(cfg, dtype, device=cuda, seed=1)
    rng = np.random.default_rng(0)
    h, w = cfg.image_size[0] // 2, cfg.image_size[1]
    inputs = [torch.from_numpy(rng.standard_normal((2, h, w, 3)).astype(np.float32)).to(cuda) for _ in range(3)]
    with torch.inference_mode():
        model(*inputs, decode_query_only=True)
        torch.cuda.synchronize()
        a0 = getattr(cuda_attn, fwd).launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = model(*inputs, decode_query_only=True)["pred_masks"]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert getattr(cuda_attn, fwd).launches - a0 == cfg.num_hidden_layers
    assert torch.isfinite(out).all()


# (M, K, N) of ViT-H's and ViT-L's fp32 products: B = 8 tiles of 1568 tokens
# (12544 rows), 2·B before the stream merge (25088), ragged rows (4999, 1001),
# the decoder embed's 6496 rows (the query half and its halo row); N 1280,
# 3840, 5120 and 16384, K 1280 and 5120 (and ViT-L's 1024 and 4096)
_LINEAR_CASES = [(12544, 1280, 3840), (25088, 1280, 1280), (12544, 1280, 5120), (12544, 5120, 1280),
                 (4999, 1280, 16384), (6496, 5120, 16384), (25088, 1024, 4096), (1001, 4096, 1024)]


@pytest.mark.parametrize("m,k,n", _LINEAR_CASES, ids=lambda v: str(v))
def test_linear_f32_and_its_backward_match_fp64(cuda, m, k, n):
    """The fp32 linear products' kernel through the autograd Function the
    model calls, x·W + b and the input gradient dy·Wᵀ, one launch each,
    against an fp64 product: within 4e-6 of the output's scale, and no more
    than twice cuBLAS fp32's error (TF32 off) on the same operands."""
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device="cpu").manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g).to(cuda).requires_grad_(True)
    w = (torch.randn((k, n), generator=g) / k**0.5).to(cuda)
    b = (0.1 * torch.randn(n, generator=g)).to(cuda)
    dy = torch.randn((m, n), generator=g).to(cuda)
    l0 = cuda_gemm.linear_f32.launches
    y = cuda_gemm.linear(x, w, b)
    (dx,) = torch.autograd.grad(y, x, dy)
    torch.cuda.synchronize()
    assert cuda_gemm.linear_f32.launches - l0 == 2
    x = x.detach()
    for got, want, lib in ((y, x.double() @ w.double() + b.double(), x @ w + b),
                           (dx, dy.double() @ w.double().t(), dy @ w.t())):
        scale = want.abs().max().item()
        err = (got.double() - want).abs().max().item() / scale
        lib_err = (lib.double() - want).abs().max().item() / scale
        assert err <= 4e-6 and err <= 2 * lib_err, (err, lib_err)


@pytest.mark.parametrize("hidden", [128, 160], ids=["hd64", "hd80"])
def test_fp32_linear_products_launch_once_each_and_never_wait(cuda, hidden):
    """A 2-layer fp32 model's forward and prompt gradient on the card: one
    linear_f32 launch a qualifying product (the patch embed of both
    canvases, four a block, the decoder embed; the input gradient of each
    but the mask canvas's patch embed), every weight's parts made in the
    first step (both orientations) and none in the second, which runs under
    sync-debug mode ``"error"`` without an operation that waits on the card."""
    cfg = tiny_config(hidden_size=hidden, num_attention_heads=2, num_hidden_layers=2, merge_index=0,
                      intermediate_hidden_state_indices=(1,), initializer_range=0.2)
    model = build_model(cfg, torch.float32, device=cuda, seed=1)
    rng = np.random.default_rng(0)
    h, w = cfg.image_size[0] // 2, cfg.image_size[1]
    x, px, pm, lab = (torch.from_numpy(rng.standard_normal((2, h, w, 3)).astype(np.float32)).to(cuda) for _ in range(4))
    fwd = 2 + 4 * cfg.num_hidden_layers + 1

    def step():
        leaf = px.clone().requires_grad_(True)
        out = model(x, leaf, pm, labels=lab, decode_query_only=True)
        return torch.autograd.grad(out["loss"], leaf)[0]

    for first in (True, False):
        l0, c0 = cuda_gemm.linear_f32.launches, cuda_gemm.linear_f32.cache_builds
        if first:
            step()
        else:
            torch.cuda.set_sync_debug_mode("error")
            try:
                grad = step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert cuda_gemm.linear_f32.launches - l0 == 2 * fwd - 1
        assert cuda_gemm.linear_f32.cache_builds - c0 == (2 * (fwd - 1) if first else 0)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0


def test_linear_f32_raises_on_what_it_does_not_take(cuda):
    """The wrapper refuses bf16, N not a multiple of 4, a weight that
    requires grad (it forms no weight gradient) and a strided input; the
    model's ``linear`` sends the first two to ``x @ W`` instead."""
    x = torch.randn((4, 64), device=cuda)
    w = torch.randn((64, 128), device=cuda)
    with pytest.raises(TypeError):
        cuda_gemm.linear_f32(x.bfloat16(), w.bfloat16())
    for args in ((x, torch.randn((64, 3), device=cuda)), (x, w.clone().requires_grad_(True)),
                 (x[:, 1:61], torch.randn((60, 128), device=cuda))):
        with pytest.raises(ValueError):
            cuda_gemm.linear_f32(*args)
    l0 = cuda_gemm.linear_f32.launches
    for a, b in ((x.bfloat16(), w.bfloat16()), (x, torch.randn((64, 3), device=cuda))):
        assert torch.equal(cuda_gemm.linear(a, b), a @ b)
    assert cuda_gemm.linear_f32.launches == l0


_STAGE_PLAINS = ("ln_rows_plain", "lin1_gelu_plain", "lin2_plain", "dual_dh_plain", "dln_plain", "ln_vjp_plain",
                 "ln_mlp_plain", "ln_mlp_dx_plain")


def _mlp_stage_inputs(cuda, n, c, seed=3, m=None):
    g = torch.Generator(device="cpu").manual_seed(seed)
    m = m or 4 * c
    r = lambda *shape, sc=1.0: sc * torch.randn(shape, generator=g)  # noqa: E731
    bf = lambda t: t.to(device=cuda, dtype=torch.bfloat16)  # noqa: E731
    return (bf(r(n, c)), (1 + r(c, sc=0.1)).to(cuda), r(c, sc=0.1).to(cuda), bf(r(c, m, sc=c**-0.5)),
            bf(r(m, sc=0.1)), bf(r(m, c, sc=m**-0.5)), bf(r(c, sc=0.1)), bf(r(n, c)))


# chip_smoke.py's limits for the MLP stages' fp32 outputs (MLP_STATS_TOL,
# MLP_DLN_TOL): the largest error over max|plain| and the error norm over
# the output's, where only the order of fp32 sums differs
STATS_TOL, DLN_TOL = 1e-6, 1e-4


def _assert_mlp_close(got, want, tol_rel=4 * BF16_EPS, tol_norm=BF16_EPS):
    """chip_smoke.py's MLP limits: for bf16 outputs four bf16 steps of
    max|plain| and the error's norm within one rounding step of the
    output's; fp32 outputs pass their own ``tol_rel`` and ``tol_norm``."""
    assert got.shape == want.shape and got.dtype == want.dtype and got.device == want.device
    d = got.float() - want.float()
    assert d.abs().max().item() <= tol_rel * want.float().abs().max().item()
    assert (d.norm() / want.float().norm()).item() <= tol_norm


@pytest.mark.parametrize("n", [77, 45, S_GRID[0] * S_GRID[1] + 9, S_GRID[0] * S_GRID[1]])
@pytest.mark.parametrize("c", [256, 768, 1024, 1280])
def test_mlp_stage_kernels_match_plain(cuda, c, n):
    """Each stage kernel behind ln_mlp and ln_mlp_dx against its stage plain
    version on the plain chain's intermediates, both GELU forms, rows that
    are and are not a multiple of the 128-row tile."""
    x, ls, lb, w1, b1, w2, b2, gy = _mlp_stage_inputs(cuda, n, c)
    ln, mean, rstd = cuda_mlp.ln_rows_plain(x, ls, lb, 1e-6)
    got_ln, got_mean, got_rstd = cuda_mlp.ln_rows(x, ls, lb, 1e-6)
    _assert_mlp_close(got_ln, ln)
    _assert_mlp_close(got_mean, mean, STATS_TOL, STATS_TOL)
    _assert_mlp_close(got_rstd, rstd, STATS_TOL, STATS_TOL)
    for approx in (True, False):
        h = cuda_mlp.lin1_gelu_plain(ln, w1, b1, approx)
        _assert_mlp_close(cuda_mlp.lin1_gelu(ln, w1, b1, approx), h)
        _assert_mlp_close(cuda_mlp.lin2(h, w2, b2), cuda_mlp.lin2_plain(h, w2, b2))
        dh = cuda_mlp.dual_dh_plain(ln, gy, w1, b1, w2, approx)
        _assert_mlp_close(cuda_mlp.dual_dh(ln, gy, w1, b1, w2, approx), dh)
        dln = cuda_mlp.dln_plain(dh, w1)
        _assert_mlp_close(cuda_mlp.dln(dh, w1), dln, DLN_TOL, DLN_TOL)
        _assert_mlp_close(cuda_mlp.ln_vjp(dln, x, ls, mean, rstd), cuda_mlp.ln_vjp_plain(dln, x, ls, mean, rstd))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [77, 300])
def test_mlp_kernels_at_hidden_width_not_a_multiple_of_256(cuda, n):
    """C=256 with M=384: the last 256-column tile of lin1_gelu (and of
    dual_dh's 128-column tiles, the products over K = M for lin2 and dln)
    runs past M, and neither its bias reads nor its stores may reach past
    it. Each stage kernel and the two whole kernels against their plain
    versions."""
    x, ls, lb, w1, b1, w2, b2, gy = _mlp_stage_inputs(cuda, n, 256, m=384)
    ln, mean, rstd = cuda_mlp.ln_rows_plain(x, ls, lb, 1e-6)
    h = cuda_mlp.lin1_gelu_plain(ln, w1, b1, True)
    _assert_mlp_close(cuda_mlp.lin1_gelu(ln, w1, b1, True), h)
    _assert_mlp_close(cuda_mlp.lin2(h, w2, b2), cuda_mlp.lin2_plain(h, w2, b2))
    dh = cuda_mlp.dual_dh_plain(ln, gy, w1, b1, w2, True)
    _assert_mlp_close(cuda_mlp.dual_dh(ln, gy, w1, b1, w2, True), dh)
    _assert_mlp_close(cuda_mlp.dln(dh, w1), cuda_mlp.dln_plain(dh, w1), DLN_TOL, DLN_TOL)
    _assert_mlp_close(cuda_mlp.ln_mlp(x, ls, lb, w1, b1, w2, b2, 1e-6, True),
                      cuda_mlp.ln_mlp_plain(x, ls, lb, w1, b1, w2, b2, 1e-6, True))
    _assert_mlp_close(cuda_mlp.ln_mlp_dx(x, ls, lb, w1, b1, w2, gy, 1e-6, True),
                      cuda_mlp.ln_mlp_dx_plain(x, ls, lb, w1, b1, w2, gy, 1e-6, True))
    torch.cuda.synchronize()


def test_mlp_wrappers_never_run_plain_code_on_the_card(cuda, monkeypatch):
    """With every plain version, torch.matmul, the @ operator and
    F.layer_norm patched to raise, ln_mlp, ln_mlp_dx and each stage wrapper
    still run on CUDA tensors (every launch is a kernel of csrc/), and each
    wrapper's count rises by one a call."""
    x, ls, lb, w1, b1, w2, b2, gy = _mlp_stage_inputs(cuda, 300, 1024)
    ln, mean, rstd = cuda_mlp.ln_rows(x, ls, lb, 1e-6)
    h = cuda_mlp.lin1_gelu(ln, w1, b1, True)
    dh = cuda_mlp.dual_dh(ln, gy, w1, b1, w2, True)
    dln = cuda_mlp.dln(dh, w1)

    def boom(*a, **k):
        raise AssertionError("plain code ran on the card")

    for name in _STAGE_PLAINS:
        monkeypatch.setattr(cuda_mlp, name, boom)
    monkeypatch.setattr(torch, "matmul", boom)
    monkeypatch.setattr(torch.Tensor, "__matmul__", boom)
    monkeypatch.setattr(torch.nn.functional, "layer_norm", boom)
    calls = {
        "ln_mlp": lambda: cuda_mlp.ln_mlp(x, ls, lb, w1, b1, w2, b2, 1e-6, True),
        "ln_mlp_dx": lambda: cuda_mlp.ln_mlp_dx(x, ls, lb, w1, b1, w2, gy, 1e-6, True),
        "ln_rows": lambda: cuda_mlp.ln_rows(x, ls, lb, 1e-6),
        "lin1_gelu": lambda: cuda_mlp.lin1_gelu(ln, w1, b1, True),
        "lin2": lambda: cuda_mlp.lin2(h, w2, b2),
        "dual_dh": lambda: cuda_mlp.dual_dh(ln, gy, w1, b1, w2, True),
        "dln": lambda: cuda_mlp.dln(dh, w1),
        "ln_vjp": lambda: cuda_mlp.ln_vjp(dln, x, ls, mean, rstd),
    }
    for name, call in calls.items():
        before = getattr(cuda_mlp, name).launches
        call()
        assert getattr(cuda_mlp, name).launches == before + 1, name
    torch.cuda.synchronize()


def test_mlp_wrappers_raise_on_misaligned_or_strided_inputs(cuda):
    x, ls, lb, w1, b1, w2, b2, gy = _mlp_stage_inputs(cuda, 64, 256)
    ln, mean, rstd = cuda_mlp.ln_rows(x, ls, lb, 1e-6)
    shifted = torch.empty(64 * 256 + 8, device=cuda, dtype=torch.bfloat16)[8:].view(64, 256)  # 16-byte offset
    with pytest.raises(ValueError, match="contiguous, 32-byte aligned"):
        cuda_mlp.ln_mlp(shifted, ls, lb, w1, b1, w2, b2, 1e-6, True)
    with pytest.raises(ValueError, match="contiguous, 32-byte aligned"):
        cuda_mlp.lin1_gelu(ln, w1.T.contiguous().T, b1, True)
    with pytest.raises(ValueError, match="contiguous, 32-byte aligned"):
        cuda_mlp.dual_dh(ln, gy.T.contiguous().T, w1, b1, w2, True)
    with pytest.raises(ValueError, match="units"):
        cuda_mlp.dln(ln, w1)  # dh has C, not M, columns
    with pytest.raises(ValueError, match="want"):
        cuda_mlp.ln_vjp(ln, x, ls, mean, rstd)  # dln must be fp32
    with pytest.raises(ValueError, match="C % 256"):
        cuda_mlp.ln_rows(x[:, :128].contiguous(), ls[:128], lb[:128], 1e-6)


def test_scene_engine_on_card_matches_plain(cuda, tmp_path, monkeypatch):
    """infer.predict.run_predict on the card: the small scene of
    tests/synthetic_scene.py, the debug backbone in bf16 (#3 and #2 once per
    layer per batch, from pinned uploads and per-date pinned downloads behind
    CUDA events). Its GeoTIFFs agree with the same engine's through the plain
    versions on at least 98% of the pixels (chip_smoke.py's id limit)."""
    from beach_seg_tpu_torch.config import PredictionConfig
    from beach_seg_tpu_torch.geo.tiff import read
    from beach_seg_tpu_torch.infer import run_predict
    from beach_seg_tpu_torch.ops import attention

    # by its directory: a host may have a regular package named tests of its own
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent))
    from synthetic_scene import OTHER_DATES, build_scene

    scene = build_scene(tmp_path / "scene")
    conf = PredictionConfig(data=scene, model_training_root=tmp_path / "out", batch_size=2, debug=True,
                            compute_dtype="bfloat16", checkpoint="random", mesh_data=1)
    p0, m0 = cuda_attn.attn_packed.launches, cuda_mlp.ln_mlp.launches
    got_dir = run_predict(conf)
    packed, mlp = cuda_attn.attn_packed.launches - p0, cuda_mlp.ln_mlp.launches - m0
    assert packed > 0 and packed == mlp and packed % 4 == 0  # 4 layers a batch
    monkeypatch.setattr(cuda_attn, "attn_packed", attention.attention_packed_plain)
    monkeypatch.setattr(cuda_mlp, "ln_mlp", cuda_mlp.ln_mlp_plain)
    want_dir = run_predict(conf)
    for date in OTHER_DATES:
        got, want = read(got_dir / "tif" / f"{date}.tif").data[0], read(want_dir / "tif" / f"{date}.tif").data[0]
        assert got.shape == want.shape == (96, 128)
        assert set(np.unique(got)) <= {0, 1, 2, 3}
        assert (got == want).mean() >= 0.98


def test_run_training_on_card_matches_plain(cuda, tmp_path, monkeypatch):
    """train.loop.run_training on the card: the small scene of
    tests/synthetic_scene.py, the debug backbone in bf16, 1 epoch (3 train
    steps of 2 tiles, 3 eval batches). Each step launches #3, #2, #4 and #5
    once a layer (each eval batch #3 and #2), and each step's prompt
    gradient through the kernels is held against the same step's through
    the plain versions, on the same state and draws, with chip_smoke.py's
    phase-6 limits (1 - cosine <= 1e-3, max error <= 5e-2 of max|plain|):
    those gradients are what moved the tuned pixels."""
    from beach_seg_tpu_torch.ops import attention
    from beach_seg_tpu_torch.train import run_training

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent))
    from synthetic_scene import build_scene

    conf = BeachSegConfig(data=build_scene(tmp_path / "scene"), model_training_root=tmp_path / "out", crop_size=32,
                          inpt_size=64, batch_size=2, epochs=1, debug=True, compute_dtype="bfloat16", checkpoint="random",
                          num_viz_images=2, log_every_n_steps=1)
    plain = {(cuda_attn, "attn_packed"): attention.attention_packed_plain, (cuda_attn, "attn_bwd"): attention.attention_bwd_plain,
             (cuda_mlp, "ln_mlp"): cuda_mlp.ln_mlp_plain, (cuda_mlp, "ln_mlp_dx"): cuda_mlp.ln_mlp_dx_plain}
    loss_and_grad, pairs = PromptTuner.loss_and_grad, []

    def both(self, *args):
        out = loss_and_grad(self, *args)
        saved = {k: getattr(*k) for k in plain}
        for (mod, name), fn in plain.items():
            setattr(mod, name, fn)
        try:
            pairs.append((out[1], loss_and_grad(self, *args)[1]))
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
        return out

    monkeypatch.setattr(PromptTuner, "loss_and_grad", both)
    names = ("attn_packed", "ln_mlp", "attn_bwd", "ln_mlp_dx")
    wrappers = {n: getattr(cuda_attn, n, None) or getattr(cuda_mlp, n) for n in names}
    before = {n: w.launches for n, w in wrappers.items()}
    rd = run_training(conf)
    launches = {n: w.launches - before[n] for n, w in wrappers.items()}
    assert launches == {"attn_packed": 4 * 6, "ln_mlp": 4 * 6, "attn_bwd": 4 * 3, "ln_mlp_dx": 4 * 3}, launches
    assert len(pairs) == 3
    for got, want in pairs:
        assert torch.isfinite(got).all() and want.abs().max() > 0
        cos = torch.nn.functional.cosine_similarity(got.flatten().float(), want.flatten().float(), dim=0).item()
        assert 1 - cos <= 1e-3
        assert (got - want).abs().max().item() <= 5e-2 * want.abs().max().item()
    for name in ("prompt_batch.npz", "prompt_batch_tuned.npz", "prompt_batch_ema.npz", "metrics.csv", "best.json"):
        assert (rd / name).exists()
    assert (rd / "checkpoints" / "step_3" / "state.pt").exists()

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_feature_ensemble_on_card_matches_plain(cuda, dtype, monkeypatch):
    """The grouped feature ensemble (G=3 groups of P=3, the odd batch: 18
    rows before the stream merge, 9 after) at head_dim 64, C=256, on the
    card through #1 (and #2 under bf16) against the same model through the
    plain versions on the card: bf16 within 8 steps of the output's scale
    (the limit of test_tiny_bf16_model_on_card_matches_cpu), fp32 within
    1e-4 of it (split-TF32 attention)."""
    from beach_seg_tpu_torch.ops import attention

    cfg = tiny_config(hidden_size=256, num_attention_heads=4)
    g, p = 3, 3
    rng = np.random.default_rng(2)
    h, w = cfg.image_size[0] // 2, cfg.image_size[1]
    q = np.repeat(rng.standard_normal((g, h, w, 3)).astype(np.float32), p, axis=0)
    inputs = [torch.from_numpy(a).to(cuda) for a in (q, *(rng.standard_normal((g * p, h, w, 3)).astype(np.float32)
                                                            for _ in range(2)))]
    model = build_model(cfg, dtype, device=cuda, seed=1)
    kw = dict(feature_ensemble=True, ensemble_groups=g, decode_query_only=True)
    a0, m0 = cuda_attn.attn_qkv_rel.launches, cuda_mlp.ln_mlp.launches
    with torch.inference_mode():
        got = model(*inputs, **kw)["pred_masks"]
        off = model(*inputs, decode_query_only=True)["pred_masks"]
    assert cuda_attn.attn_qkv_rel.launches - a0 == 2 * cfg.num_hidden_layers
    assert cuda_mlp.ln_mlp.launches - m0 == (2 * cfg.num_hidden_layers if dtype == torch.bfloat16 else 0)
    monkeypatch.setattr(cuda_attn, "attn_qkv_rel", cuda_attn.attn_qkv_rel_plain)
    monkeypatch.setattr(cuda_mlp, "ln_mlp", cuda_mlp.ln_mlp_plain)
    with torch.inference_mode():
        want = model(*inputs, **kw)["pred_masks"]
    scale = want.abs().max().item()
    tol = 8 * BF16_EPS if dtype == torch.bfloat16 else 1e-4
    assert (got - want).abs().max().item() <= tol * scale
    assert (off - want).abs().max().item() > tol * scale  # the ensemble moved the output
    # the P canvases of a group share their query half after the ensemble,
    # but for its first pixel row, which the decoder's 3×3 conv takes from
    # the prompt half
    grouped = got.reshape(g, p, *got.shape[1:])[:, :, got.shape[1] // 2 + 1:]
    assert (grouped - grouped[:, :1]).abs().max().item() <= tol * scale


def test_scatter_votes_on_card_equals_cpu(cuda):
    """The device votes on the card equal the CPU's bit for bit: crops past
    every edge (negative origins too), overlaps and rows that are not
    valid."""
    from beach_seg_tpu_torch.infer.device_votes import scatter_votes, zero_counter

    rng = np.random.default_rng(3)
    b, cs, nc = 16, 112, 4
    one_hot = torch.from_numpy(np.eye(nc, dtype=np.int32)[rng.integers(0, nc, (b, cs, cs))])
    xmins = torch.from_numpy(rng.integers(-60, 300, b).astype(np.int32))
    ymins = torch.from_numpy(rng.integers(-60, 200, b).astype(np.int32))
    valid = torch.from_numpy(rng.random(b) < 0.8)
    want, got = zero_counter((200, 300), nc), zero_counter((200, 300), nc, device=cuda)
    for _ in range(2):
        scatter_votes(want, one_hot, xmins, ymins, valid)
        scatter_votes(got, one_hot.to(cuda), xmins.to(cuda), ymins.to(cuda), valid.to(cuda))
    assert torch.equal(got.cpu(), want) and want.sum() > 0
