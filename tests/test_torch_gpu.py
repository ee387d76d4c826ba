"""The port's CUDA kernels against their plain versions on the card, at one
ViT-L layer's shapes, at ViT-H's widths (head_dim 80, C=1280) and at ragged
small ones, tiny bf16 models (head_dim 64, and C=1280 with 16 heads of 80)
through the kernels forward and backward, and the shapes the kernels refuse.
Marked ``gpu``: they skip where no CUDA device is present (run them on the
card with ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

from beach_seg_tpu_torch.models.seggpt import build_model, tiny_config
from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp
from beach_seg_tpu_torch.ops.attention import attention_bwd_plain, attention_packed_plain, rel_tables_padded

pytestmark = pytest.mark.gpu

S_GRID = (56, 28)  # ViT-L: 896×448 canvas, 16-pixel patches
C, HEADS, MLP = 1024, 16, 4096
BF16_EPS = 2.0**-8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _attn_inputs(dtype, device, batch=1, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    gh, gw = S_GRID
    hd = C // HEADS
    qkv = torch.randn((batch, gh * gw, 3, C), generator=g)
    bias = 0.1 * torch.randn((3, C), generator=g)
    rph = 0.1 * torch.randn((2 * gh - 1, hd), generator=g)
    rpw = 0.1 * torch.randn((2 * gw - 1, hd), generator=g)
    rh, rw = rel_tables_padded(rph, rpw, S_GRID, S_GRID)
    return [t.to(device=device, dtype=dtype).contiguous() for t in (qkv, bias, rh, rw)]


@pytest.mark.parametrize("dtype,softmax,tol", [(torch.bfloat16, "clamp", 3e-2), (torch.float32, "stable", 1e-4)])
def test_attn_kernel_matches_plain(cuda, dtype, softmax, tol):
    qkv, bias, rh, rw = _attn_inputs(dtype, cuda)
    args = (qkv, bias, rh, rw, 0.125, S_GRID[1], HEADS, softmax)
    before = cuda_attn.attn_qkv_rel.launches
    got = cuda_attn.attn_qkv_rel(*args)
    torch.cuda.synchronize()
    assert cuda_attn.attn_qkv_rel.launches == before + 1
    want = cuda_attn.attn_qkv_rel_plain(*args)
    assert got.shape == want.shape == (1, S_GRID[0] * S_GRID[1], C)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("c", [256, C])  # the smallest width the kernel takes, and ViT-L's
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


def test_head_dim_8_raises_in_packed_kernel(cuda):
    """tiny_config's head_dim 8 takes the packed attention, whose kernel is
    instantiated for head dims 64 and 80 only: it raises, naming itself."""
    model = build_model(tiny_config(), device=cuda)
    x = torch.zeros((1, 32, 32, 3), device=cuda)
    with pytest.raises(ValueError, match="attn_packed kernel .*head_dim 64 or 80"):
        model(x, x, x)


def _packed_inputs(device, dtype, bh, hk, wk, d, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = hk * wk
    r = lambda *sh, sc=1.0: (sc * torch.randn(sh, generator=g)).to(device=device, dtype=dtype)  # noqa: E731
    return r(bh, s, d), r(bh, s, d), r(bh, s, d), r(bh, s, hk, sc=0.5), r(bh, s, wk, sc=0.5)


@pytest.mark.parametrize("hk,wk", [(3, 5), (7, 4), (56, 28)])  # ragged tiles; the ViT-L/H grid
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 1e-4)], ids=["bf16", "fp32"])
def test_attn_packed_kernel_matches_plain(cuda, dtype, tol, d, hk, wk):
    """The packed attention (B=2, 3 heads) against its plain version, with
    the qkv-rel kernel's tolerances: bf16 three bf16 steps at |out| ≤ ~1,
    fp32 the online softmax's few ulps."""
    args = (*_packed_inputs(cuda, dtype, 6, hk, wk, d), d**-0.5, 3)
    before = cuda_attn.attn_packed.launches
    got = cuda_attn.attn_packed(*args)
    torch.cuda.synchronize()
    assert cuda_attn.attn_packed.launches == before + 1
    want = attention_packed_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape == (2, hk * wk, 3 * d)
    assert (got.float() - want.float()).abs().max().item() <= tol


def _bwd_inputs(device, bh, hk, wk, seed=0, d=64):
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = hk * wk
    r = lambda *sh, sc=1.0: (sc * torch.randn(sh, generator=g)).to(device=device, dtype=torch.bfloat16)  # noqa: E731
    return r(bh, s, d), r(bh, s, d), r(bh, s, d), r(bh, s, hk, sc=0.5), r(bh, s, wk, sc=0.5), r(bh, s, d)


# one ViT-L / ViT-H image; ragged tiles
@pytest.mark.parametrize("bh,hk,wk,d", [(16, 56, 28, 64), (3, 5, 7, 64), (2, 9, 64, 64), (16, 56, 28, 80), (3, 5, 7, 80), (2, 7, 4, 80)])
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


@pytest.mark.parametrize("n,c", [(S_GRID[0] * S_GRID[1], C), (77, 256), (100, 768)])
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


@pytest.mark.parametrize("n", [S_GRID[0] * S_GRID[1] + 9, 45])  # not a multiple of the 32- or 16-row tile
def test_mlp_kernels_at_vit_h_width(cuda, n):
    """C=1280, M=5120 (ViT-H): the forward kernel's 32-row clusters and the
    dx kernel's 16-row blocks, against their plain versions within four bf16
    steps of the output's scale."""
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
    with pytest.raises(ValueError, match="head_dim 64 or 80"):
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
