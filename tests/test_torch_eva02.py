"""EVA-02's block (``eva02_config``, ``BeachSegConfig.backbone="eva02"``): 2D
RoPE in place of the rel-pos bias, a q/v-only bias, a SwiGLU MLP and the two
sub-LNs, on SegGPT's painter path. The port against the benchmark's plain
EVA-02 painter (``portbench/reference/eva02.py``, float32 PyTorch that owes
the port nothing), on the benchmark's seeded EVA-02 weights at a tiny size:

- the painted canvas of a forward in fp32, and the prompt-pixel gradient of
  the nodata loss (``PromptTuner.loss_and_grad`` under the benchmark's
  draws), at head_dim 64 (16 frequencies a pair axis) and 8;
- a half-split RoPE pairing, a block without its sub-LNs and a bias on k
  each fail that comparison;
- the RoPE attention's entry and the SwiGLU MLP's against their plain
  versions, forward and backward, and the RoPE tables against the
  reference's;
- ``config_for``, the ``.npz`` topology, and the ViT presets (SegGPT,
  ViT-H's head_dim 80, Painter, debug) keeping their operations: their
  outputs equal, bit for bit, those of the ViT-block formulas written out
  below without the EVA-02 branch, fp32 and bf16;
- a bf16 rel-pos table that needs resizing reaches kernel #1 in bf16.

On the card (``gpu``): the RoPE attention at EVA-02-L's widths (B·16 heads,
S 2048, head_dim 64) and the SwiGLU MLP at C 1024, M 2730 against their
plain versions; one bf16 train step's prompt gradient against the
reference's; a bf16 SegGPT whose rel-pos tables need resizing held to its
plain run.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt import SegGPTConfig, build_model, eva02_config, save_params, tiny_config
from beach_seg_tpu_torch.models.seggpt import model as model_mod
from beach_seg_tpu_torch.models.seggpt.convert import PORT_ONLY, load_config, load_npz
from beach_seg_tpu_torch.ops import attention as attn_mod
from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp
from beach_seg_tpu_torch.ops.sharding import copy_to_model, model_axis_size, reduce_from_model
from beach_seg_tpu_torch.train import PromptTuner
from beach_seg_tpu_torch.train.loop import config_for, model_for_config
from portbench.reference import eva02 as ref
from portbench.reference import seggpt as ref_seggpt
from portbench.traffic import draws as traffic_draws
from portbench.traffic.eva02_weights import make_weights

ROOT = Path(__file__).resolve().parents[1]
AUG = json.loads((ROOT / "portbench" / "configs" / "seggpt_vit_h_fp32.json").read_text())["augment"]
H = 32  # crops and prompts: a (64, 32) canvas of 8-pixel patches, an 8×4 grid
# head_dim 64 at C 256 (the SwiGLU kernels' least width) with int(256 · 2.6667) hidden units, and head_dim 8
GEOMS = {"hd64": dict(hidden_size=256, num_attention_heads=4, mlp_dim=682), "hd8": dict(mlp_dim=86)}
INIT = {"std": 0.02, "head_std": 0.3}
EVA_FIELDS = dict(use_relative_position_embeddings=False, block="eva02", pretrain_image_size=16)


def tiny_eva(geometry: str, **over):
    """EVA-02's block at a tiny size: the 8×4 grid at RoPE step 0.5 (the
    cell's: the 2×2 pretrain grid's side over 4 columns), an MLP width that
    is no multiple of 8 (as 2730 is not)."""
    return tiny_config(**GEOMS[geometry], **{**EVA_FIELDS, **over})


def model_dict(cfg) -> dict:
    """The config as the benchmark's files hold a model (lists, no tuples)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def weights_and_model(cfg, seed: int = 3, dtype=torch.float32):
    w = make_weights(model_dict(cfg), INIT, seed, "cpu")
    return w, build_model(cfg, dtype, device="cpu", state=w)


def images(seed: int, n: int, b: int = 2) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, H, H, 3)).astype(np.float32)) for _ in range(n)]


def forward_gap(model, w, cfg) -> float:
    """The largest difference of the port's painted query half from the
    reference's, over the reference's largest value."""
    q, p, pm = images(0, 3)
    with torch.no_grad():
        got = model(q, p, pm)["pred_masks"][:, H:]
        want = ref.forward(w, model_dict(cfg), q, p, pm)
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize("geometry", list(GEOMS))
def test_forward_matches_the_reference(geometry):
    """fp32 on both sides: the port's rotation by pair tables, its fused
    attention's softmax and LayerNorm's one-pass statistics round
    differently from the reference's op-by-op float32 (EVA's rotate_half on
    repeated frequencies): 2.3e-6 (head_dim 64) and 1.0e-6 (8) of the
    canvas's scale over 6 blocks; the limit is 1e-5 of it (a misplaced
    rotation, a missing sub-LN or a bias on k moves the canvas by far more:
    ``test_faults_fail_the_comparison``)."""
    cfg = tiny_eva(geometry)
    w, model = weights_and_model(cfg)
    assert forward_gap(model, w, cfg) <= 1e-5


def half_split(x, tables, sign=1.0):
    """The fault: pairs (j, j + hd/2) in place of (2j, 2j + 1)."""
    cos, sin = tables[0], sign * tables[1]
    a, b = x.float().chunk(2, dim=-1)
    return torch.cat((a * cos - b * sin, b * cos + a * sin), dim=-1).to(x.dtype)


def k_bias_too(qv_bias):
    """The fault: the q bias added to k as well, as a (3, C) bias would."""
    return torch.cat([qv_bias[0], qv_bias[0], qv_bias[1]])


@pytest.mark.parametrize("fault", ["half_split_rope", "no_sub_ln", "k_bias"])
def test_faults_fail_the_comparison(fault, monkeypatch):
    """Each planted fault moves the painted canvas past the forward test's
    limit by more than a hundredfold: RoPE on the (j, j + hd/2) pairs of
    NeoX-style code (6.0e-2 of the canvas's scale), a block without the
    inner and the hidden-width LayerNorms (both made identities: 1.1), and
    the q bias added to k as well (through ``qkv_bias_of``, the fp32 path's
    bias; the kernel's pre-pass takes the (2, C) bias and has no k slot):
    2.5e-3, over a thousand times the sound gap in fp32, where the cell's
    bf16 ids on the card cannot show it (PERF.md §2)."""
    cfg = tiny_eva("hd64")
    w = make_weights(model_dict(cfg), INIT, 3, "cpu")
    model = build_model(cfg, device="cpu", state=w)
    if fault == "half_split_rope":
        monkeypatch.setattr(model_mod, "rope_rotate", half_split)
    elif fault == "no_sub_ln":
        for name, _ in list(model.named_modules()):
            if name.endswith(("inner_layernorm", "ffn_layernorm")):
                parent, _, attr = name.rpartition(".")
                setattr(model.get_submodule(parent), attr, torch.nn.Identity())
    else:
        monkeypatch.setattr(model_mod, "qkv_bias_of", k_bias_too)
    assert forward_gap(model, w, cfg) > 1e-3


@pytest.mark.parametrize("geometry", list(GEOMS))
def test_prompt_gradient_matches_the_reference(geometry):
    """One step's nodata loss and prompt-pixel gradient under the benchmark's
    draws (augmentation, palettes, prompt indices, stochastic depth), through
    the RoPE attention's backward (#4's plain version with zero rel terms
    and the rotation's transpose) or the flash entry's, and the SwiGLU MLP's
    autograd: the loss within 1e-5 relative and the gradient's error within
    2e-5 of its norm (fp32 sums reordered over the batch and the heads, as
    Painter's test allows)."""
    cfg = tiny_eva(geometry)
    w, model = weights_and_model(cfg)
    conf = BeachSegConfig(batch_size=2, crop_size=H, inpt_size=H, **{k: tuple(v) if isinstance(v, list) else v
                                                                       for k, v in AUG.items() if k != "erasing_ratio"})
    tuner = PromptTuner(model, conf, device="cpu")
    rng = np.random.default_rng(1)
    pixels = torch.from_numpy(rng.random((3, H, H, 3), dtype=np.float32))
    masks = torch.from_numpy(rng.integers(0, 4, (3, H, H)).astype(np.int64))
    nodata = torch.zeros((3, H, H), dtype=torch.bool)
    batch = {"image": torch.from_numpy(rng.random((2, H, H, 3), dtype=np.float32)),
             "mask": torch.from_numpy(rng.integers(1, 4, (2, H, H)).astype(np.int64)),
             "nodata": torch.zeros((2, H, H), dtype=torch.bool), "valid": torch.ones(2, dtype=torch.bool)}
    gen = torch.Generator().manual_seed(7)
    draws = traffic_draws.step_draws(gen, 2, H, 3, 4, AUG, model_dict(cfg))
    loss, grad = tuner.loss_and_grad(pixels, masks, nodata, batch, tuner.step_draws(batch, 3, None, draws))[:2]
    want_loss, want = ref.loss_and_grad(w, model_dict(cfg), {"loss_beta": conf.loss_beta}, AUG, pixels, masks, nodata,
                                        batch, draws)
    assert want.norm() > 0 and loss.item() == pytest.approx(want_loss.item(), rel=1e-5)
    assert (grad - want).norm().item() <= 2e-5 * want.norm().item()


def test_rope_tables_match_the_reference():
    """The port's pair tables (one column a pair) against EVA's per-dim
    cos / sin on repeated frequencies: equal to fp32 rounding of the angles
    (the port's are formed in float64, up to 31.5 rad), and a rotation by
    them is EVA's ``t·cos + rotate_half(t)·sin``; the transpose turns back."""
    tables = torch.from_numpy(attn_mod.rope_tables((64, 32), 0.5, 64))
    cos, sin = ref.rope_cos_sin(64, 32, 0.5, 64, "cpu")
    assert tables.shape == (2, 2048, 32)
    assert (tables[0].repeat_interleave(2, -1) - cos).abs().max() <= 4e-6
    assert (tables[1].repeat_interleave(2, -1) - sin).abs().max() <= 4e-6
    x = torch.randn(3, 2048, 64, dtype=torch.float64).float()
    got = attn_mod.rope_rotate(x, tables)
    assert (got - (x * cos + ref.rotate_half(x) * sin)).abs().max() <= 1e-4
    assert (attn_mod.rope_rotate(got, tables, -1.0) - x).abs().max() <= 1e-5


def rope_inputs(dtype=torch.float32, seed=0, b=2, gh=8, gw=4, nh=2):
    """(qkv4, qv_bias, tables, scale, gw, heads) of the RoPE attention, head_dim 64."""
    g = torch.Generator().manual_seed(seed)
    c = 64 * nh
    qkv4 = torch.randn((b, gh * gw, 3, c), generator=g).to(dtype)
    qv = (0.1 * torch.randn((2, c), generator=g)).to(dtype)
    return qkv4, qv, torch.from_numpy(attn_mod.rope_tables((gh, gw), 0.5, 64)), 0.125, gw, nh


def test_rope_attention_entry_and_its_gradient():
    """``rope_attention``'s forward is the plain version, and its backward
    (the pre-pass recomputed, #4's plain version with zero rel terms, the
    rotation's transpose) is autograd of the plain version, within 1e-5 of
    each gradient's scale in fp32 (stable softmax)."""
    qkv4, qv, tables, scale, gw, nh = rope_inputs()
    g = torch.randn((2, 32, 128), generator=torch.Generator().manual_seed(9))
    leaves = [qkv4.clone().requires_grad_(True), qv.clone().requires_grad_(True)]
    out = cuda_attn.rope_attention(*leaves, tables, scale, gw, nh, "stable")
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [qkv4.clone().requires_grad_(True), qv.clone().requires_grad_(True)]
    want_out = cuda_attn.attn_qkv_rope_plain(*ref_leaves, tables, scale, nh, "stable")
    want = torch.autograd.grad(want_out, ref_leaves, g)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_rope_attention_plain_is_the_reference_attention():
    """The plain version at its bf16 rounding points against the
    reference's fp32 attention core on the same inputs: within 4 bf16 steps
    of the output's scale (q, k, v, q·scale and p rounded to bf16)."""
    qkv4, qv, tables, scale, gw, nh = rope_inputs(torch.bfloat16, seed=1)
    got = cuda_attn.attn_qkv_rope_plain(qkv4, qv, tables, scale, nh).float()
    b, s, _, c = qkv4.shape
    x = qkv4.float() + torch.stack([qv[0].float(), torch.zeros(c), qv[1].float()])[None, None]
    q, k, v = (x[:, :, i].reshape(b, s, nh, 64).transpose(1, 2) for i in range(3))
    cos, sin = ref.rope_cos_sin(8, 4, 0.5, 64, "cpu")
    q, k = q * cos + ref.rotate_half(q) * sin, k * cos + ref.rotate_half(k) * sin
    want = (torch.softmax(q * scale @ k.transpose(-1, -2), -1) @ v).transpose(1, 2).reshape(b, s, c)
    assert (got - want).abs().max().item() <= 4 * 2.0**-8 * want.abs().max().item()


def swiglu_inputs(dtype, seed=0, n=40, c=64, m=86):
    g = torch.Generator().manual_seed(seed)
    r = lambda *sh, s=1.0: s * torch.randn(sh, generator=g)  # noqa: E731
    return (r(2, n // 2, c).to(dtype), 1 + r(c, s=0.1), r(c, s=0.1), (r(c, m) / c**0.5).to(dtype), r(m, s=0.1).to(dtype),
            (r(c, m) / c**0.5).to(dtype), r(m, s=0.1).to(dtype), 1 + r(m, s=0.1), r(m, s=0.1),
            (r(m, c) / m**0.5).to(dtype), r(c, s=0.1).to(dtype), 1e-6)


def test_swiglu_mlp_plain_and_its_gradient():
    """The plain chain is EVA's SwiGLU with the sub-LN (LN, silu(x·W1 + b1)
    ⊙ (x·W2 + b2), LN over M, ·W3 + b3) in fp32 to the last bits of its
    products; ``fused_swiglu_mlp``'s backward is autograd of it. In bf16 the
    rounding points hold it within 4 bf16 steps of the fp32 chain."""
    args = swiglu_inputs(torch.float32)
    x, ls, lb, w1, b1, w2, b2, fs, fb, w3, b3, eps = args
    h = F.silu(F.layer_norm(x, (64,), ls, lb, eps) @ w1 + b1) * (F.layer_norm(x, (64,), ls, lb, eps) @ w2 + b2)
    want = F.layer_norm(h, (86,), fs, fb, eps) @ w3 + b3
    got = cuda_mlp.swiglu_mlp_plain(*args)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    leaves = [t.clone().requires_grad_(True) if torch.is_tensor(t) else t for t in args]
    out = cuda_mlp.fused_swiglu_mlp(*leaves)
    grads = torch.autograd.grad(out.square().sum(), [leaves[0], leaves[3], leaves[7]])
    ref_leaves = [t.clone().requires_grad_(True) if torch.is_tensor(t) else t for t in args]
    wants = torch.autograd.grad(cuda_mlp.swiglu_mlp_plain(*ref_leaves).square().sum(),
                                [ref_leaves[0], ref_leaves[3], ref_leaves[7]])
    for a, b in zip(grads, wants):
        assert torch.equal(a, b)
    bf = cuda_mlp.swiglu_mlp_plain(*swiglu_inputs(torch.bfloat16)).float()
    f32 = cuda_mlp.swiglu_mlp_plain(*(t.float() if torch.is_tensor(t) else t for t in swiglu_inputs(torch.bfloat16)))
    assert (bf - f32).abs().max().item() <= 4 * 2.0**-8 * f32.abs().max().item()


def test_swiglu_operands_are_made_once():
    """The SwiGLU kernels' operands (a weight rounded to bf16 with the
    hidden width zero-padded, ``cuda_mlp._operand``) are made once per
    source tensor and kept while its version counter and storage stay, and
    made again after an in-place change: the model hands its fp32
    parameters, and a warm call copies none."""
    w = torch.randn(8, 10)
    before = cuda_mlp.swiglu_mlp.operand_builds
    cols = cuda_mlp._operand(w, torch.bfloat16, 64, 1)
    assert cols.shape == (8, 64) and cols.dtype == torch.bfloat16 and cols.is_contiguous()
    assert torch.equal(cols[:, :10], w.to(torch.bfloat16)) and not cols[:, 10:].any()
    assert cuda_mlp._operand(w, torch.bfloat16, 64, 1) is cols
    rows = cuda_mlp._operand(w.t(), torch.float32, 16, 0)  # W3's zero rows, from a view of the same storage
    assert rows.shape == (16, 8) and torch.equal(rows[:10], w.t()) and not rows[10:].any()
    assert cuda_mlp.swiglu_mlp.operand_builds == before + 2
    w.mul_(2)
    again = cuda_mlp._operand(w, torch.bfloat16, 64, 1)
    assert again is not cols and torch.equal(again[:, :10], w.to(torch.bfloat16))
    assert cuda_mlp.swiglu_mlp.operand_builds == before + 3


def test_bf16_path_runs_the_new_entries(monkeypatch):
    """A bf16 EVA-02 model at head_dim 64 on the CPU goes through
    ``rope_attention`` and ``fused_swiglu_mlp`` once a block (their plain
    versions here), forward and backward, and stays within bf16's reach of
    the fp32 reference: 5% of the canvas's scale over 6 blocks."""
    cfg = tiny_eva("hd64")
    w, model = weights_and_model(cfg, dtype=torch.bfloat16)
    seen = {"rope": 0, "swiglu": 0}
    real_r, real_s = cuda_attn.rope_attention, cuda_mlp.fused_swiglu_mlp
    monkeypatch.setattr(cuda_attn, "rope_attention", lambda *a, **k: seen.__setitem__("rope", seen["rope"] + 1) or real_r(*a, **k))
    monkeypatch.setattr(cuda_mlp, "fused_swiglu_mlp",
                        lambda *a, **k: seen.__setitem__("swiglu", seen["swiglu"] + 1) or real_s(*a, **k))
    q, p, pm = images(4, 3)
    p = p.requires_grad_(True)
    out = model(q, p, pm)["pred_masks"][:, H:]
    (grad,) = torch.autograd.grad(out.float().sum(), p)
    assert seen == {"rope": 6, "swiglu": 6} and torch.isfinite(grad).all() and grad.abs().sum() > 0
    want = ref.forward(w, model_dict(cfg), q, p.detach(), pm)
    assert (out.float() - want).abs().max().item() <= 5e-2 * want.abs().max().item()


def test_spans_of_the_new_entries():
    """A traced bf16 forward opens ``bst.kernel.attn_qkv_rope``,
    ``bst.kernel.swiglu_mlp`` and ``bst.seggpt.sub_ln`` (the inner LayerNorm,
    which runs outside both kernels) once a block."""
    cfg = tiny_eva("hd64")
    _, model = weights_and_model(cfg, dtype=torch.bfloat16)
    q, p, pm = images(2, 3)
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(q, p, pm)
    names = [e.name for e in prof.events()]
    for name in ("bst.kernel.attn_qkv_rope", "bst.kernel.swiglu_mlp", "bst.seggpt.sub_ln"):
        assert names.count(name) == cfg.num_hidden_layers, name


@pytest.mark.parametrize("inpt, grid", [(448, (64, 32)), (224, (32, 16))])
def test_config_for_eva02(inpt, grid):
    """EVA-02-L/14's widths on the (2·inpt, inpt) canvas at patch 14."""
    cfg = config_for(BeachSegConfig(backbone="eva02", inpt_size=inpt))
    assert cfg == eva02_config(image_size=(2 * inpt, inpt)) and cfg.grid_size == grid
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads, cfg.mlp_dim, cfg.patch_size) == (1024, 24, 16, 2730, 14)
    assert (cfg.block, cfg.use_relative_position_embeddings, cfg.window_size) == ("eva02", False, 0)
    model, got = model_for_config(BeachSegConfig(backbone="eva02", inpt_size=inpt), device="meta")
    state = model.state_dict()
    assert got == cfg and state["encoder.layers_0.attention.qv_bias"].shape == (2, 1024)
    assert state["encoder.layers_0.mlp.ffn_layernorm.scale"].shape == (2730,)
    assert not any("rel_pos" in k or "qkv_bias" in k or "lin1" in k for k in state)
    assert abs(sum(t.numel() for t in state.values()) / 1e6 - 354.75) < 0.01


def test_config_checks_its_fields():
    with pytest.raises(ValueError, match="block"):
        tiny_config(block="swiglu")
    with pytest.raises(ValueError, match="RoPE"):
        tiny_config(block="eva02")  # with the rel-pos bias on


@pytest.mark.parametrize("over", [dict(use_relative_position_embeddings=True), dict(window_size=2),
                                  dict(qkv_bias=False), dict(hidden_size=40, num_attention_heads=4)],
                         ids=["rel_pos", "windows", "no_qkv_bias", "head_dim_10"])
def test_eva02_block_refuses_what_it_does_not_run(over):
    """The eva02 block runs one way: RoPE over the whole grid, its q/v bias,
    head dims in whole rotation pairs of both axes. A config that asks for
    it with the rel-pos bias, windows, no qkv bias or a head_dim not a
    multiple of 4 is refused, not built as another block."""
    with pytest.raises(ValueError, match="RoPE"):
        tiny_eva("hd8", **over)


def test_npz_topology_round_trip(tmp_path):
    """An EVA-02 ``.npz`` stores its ``block`` and builds the same model;
    a SegGPT one stores none of the port-only fields."""
    cfg = tiny_eva("hd8")
    w, model = weights_and_model(cfg)
    save_params(model.state_dict(), tmp_path / "e.npz", cfg)
    assert load_config(tmp_path / "e.npz") == cfg
    conf = BeachSegConfig(checkpoint=str(tmp_path / "e.npz"), backbone="large")
    assert config_for(conf) == cfg
    loaded = build_model(config_for(conf), device="cpu", state=load_npz(tmp_path / "e.npz", "cpu"))
    assert all(torch.equal(v, w[k]) for k, v in loaded.state_dict().items()) and set(loaded.state_dict()) == set(w)
    seggpt = tiny_config()
    save_params(build_model(seggpt, device="cpu").state_dict(), tmp_path / "s.npz", seggpt)
    with np.load(tmp_path / "s.npz") as data:
        stored = json.loads(bytes(data["__config_json__"]).decode())
    assert not set(PORT_ONLY) & set(stored)


def test_tensor_parallel_refuses_the_block():
    from beach_seg_tpu_torch.parallel.mesh import shard_model

    class Mesh:
        pass

    model = build_model(tiny_eva("hd8"), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("beach_seg_tpu_torch.parallel.mesh.model_axis_size", lambda mesh: 2)
        with pytest.raises(ValueError, match="EVA-02"):
            shard_model(model, Mesh())


# ------------------------------------------- the ViT presets' operations


def vit_attention_forward(self, x):
    """``Attention.forward``'s ViT-block formulas written out without the
    EVA-02 branch and without the rel tables' cast, for the presets'
    bit-for-bit check."""
    cfg, dt = self.config, self.compute_dtype
    b, gh, gw, c = x.shape
    hd = cfg.head_dim
    s = gh * gw
    rel = cfg.use_relative_position_embeddings
    use_qkv_rel_kernel = rel and 2 * hd == 128 and c % 128 == 0 and gh <= 64 and gw <= 64
    cl = self.qkv_kernel.shape[-1]
    nh = cl // hd
    x = copy_to_model(x, self.mesh)
    qkv_bias = self.qkv_bias.reshape(3 * cl).to(dt) if self.qkv_bias is not None and not use_qkv_rel_kernel else None
    qkv4 = model_mod.cuda_gemm.linear(x.reshape(b, s, c).to(dt), self.qkv_kernel.reshape(c, 3 * cl).to(dt), qkv_bias)
    qkv4 = qkv4.reshape(b, s, 3, cl)
    rel_params = (self.rel_pos_h.to(dt), self.rel_pos_w.to(dt)) if rel else None
    if use_qkv_rel_kernel:
        bias = self.qkv_bias.to(dt) if self.qkv_bias is not None else torch.zeros((3, cl), dtype=dt, device=x.device)
        rh_tab, rw_tab = model_mod.rel_tables_padded(*rel_params, (gh, gw), (gh, gw))
        out = cuda_attn.qkv_rel_attention(qkv4, bias, rh_tab, rw_tab, hd**-0.5, gw, nh).reshape(b, gh, gw, cl)
    else:
        qkv = qkv4.reshape(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4).reshape(3, b * nh, s, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if rel_params is not None:
            rel_h, rel_w = model_mod.rel_pos_terms(q, *rel_params, (gh, gw), (gh, gw))
            out = cuda_attn.packed_attention(
                q, k, v, rel_h.reshape(b * nh, s, gh), rel_w.reshape(b * nh, s, gw), hd**-0.5, nh
            ).reshape(b, gh, gw, cl)
        else:
            out = model_mod.attention_reference(q, k, v, None, None, hd**-0.5)
            out = out.reshape(b, nh, gh, gw, hd).permute(0, 2, 3, 1, 4).reshape(b, gh, gw, cl)
    return reduce_from_model(model_mod.cuda_gemm.linear(out, self.proj_kernel.to(dt)), self.mesh) + self.proj_bias.to(dt)


def vit_mlp_forward(self, x, ln_params=None):
    """``Mlp.forward``'s GELU formulas written out without the SwiGLU kind."""
    dt = self.compute_dtype
    k1, b1 = self.lin1_kernel.to(dt), self.lin1_bias.to(dt)
    k2, b2 = self.lin2_kernel.to(dt), self.lin2_bias.to(dt)
    mp = model_axis_size(self.mesh)
    x = copy_to_model(x, self.mesh)
    if ln_params is not None:
        ln_scale, ln_bias = ln_params
        out = cuda_mlp.fused_ln_mlp(x, ln_scale, ln_bias, k1, b1, k2, b2 / mp if mp > 1 else b2,
                                    self.config.layer_norm_eps, dt == torch.bfloat16)
        return reduce_from_model(out, self.mesh)
    h = model_mod._gelu(model_mod.cuda_gemm.linear(x, k1, b1), dt)
    return reduce_from_model(model_mod.cuda_gemm.linear(h, k2), self.mesh) + b2


PRESETS = {
    "large": lambda: tiny_config(hidden_size=128, num_attention_heads=2),
    "huge_hd80": lambda: tiny_config(hidden_size=160, num_attention_heads=2),
    "painter": lambda: tiny_config(hidden_size=128, num_attention_heads=2, window_size=3, global_attn_indexes=(2, 5),
                                   type_tokens=False),
    "debug": lambda: config_for(BeachSegConfig(debug=True, inpt_size=32)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_presets_keep_their_operations(preset, dtype, monkeypatch):
    """Every ViT preset's forward (the plain versions on the CPU) equals the
    ViT-block formulas written out above bit for bit: the EVA-02 fields at
    their defaults change no operation, and the rel tables' cast is a no-op
    where they already have the compute dtype."""
    cfg = PRESETS[preset]()
    model = build_model(cfg, dtype, device="cpu", seed=2)
    assert cfg.block == "vit"
    assert cfg.image_size == (64, 32)
    q, p, pm = images(5, 3)
    with torch.no_grad():
        got = model(q, p, pm)["pred_masks"]
        monkeypatch.setattr(model_mod.Attention, "forward", vit_attention_forward)
        monkeypatch.setattr(model_mod.Mlp, "forward", vit_mlp_forward)
        want = model(q, p, pm)["pred_masks"]
    assert torch.equal(got, want)


def test_resized_rel_tables_reach_kernel_1_in_bf16(monkeypatch):
    """Fault §B1: a bf16 SegGPT whose rel-pos tables have another length
    (resized to the grid by ``get_rel_pos``, which returns fp32) hands kernel
    #1 bf16 tables, as the TPU kernel casts them inside itself."""
    cfg = tiny_config(hidden_size=128, num_attention_heads=2, num_hidden_layers=1, merge_index=0,
                      intermediate_hidden_state_indices=(0,))
    model = build_model(cfg, torch.bfloat16, device="cpu", seed=1)
    att = model.encoder.layers_0.attention
    att.rel_pos_h = torch.nn.Parameter(torch.randn(9, 64) * 0.1, requires_grad=False)  # 2·8 − 1 = 15 at the grid
    seen = []
    real = cuda_attn.qkv_rel_attention
    monkeypatch.setattr(cuda_attn, "qkv_rel_attention", lambda qkv4, bias, rh, rw, *a: seen.append((rh.dtype, rw.dtype))
                        or real(qkv4, bias, rh, rw, *a))
    q, p, pm = images(6, 3)
    with torch.no_grad():
        out = model(q, p, pm)["pred_masks"]
    assert seen == [(torch.bfloat16, torch.bfloat16)] and torch.isfinite(out).all()


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


BF16_EPS = 2.0**-8


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 16])  # B = 8 after the stream merge, 16 before
def test_rope_attention_at_eva02_widths(cuda, rows):
    """The RoPE attention kernel at EVA-02-L's widths (16 heads of 64, the
    64×32 grid, S 2048) against its plain version, clamp softmax (the
    model's mode): bf16 two steps of max|plain| (capped at 3e-2) and the
    error norm one step of the output's, ``test_torch_gpu``'s limits for #1
    (the pre-pass rounds as the plain version does, bit for bit)."""
    g = torch.Generator(device="cpu").manual_seed(rows)
    c, heads = 1024, 16
    qkv = torch.randn((rows, 2048, 3, c), generator=g).to(cuda, torch.bfloat16)
    qv = (0.1 * torch.randn((2, c), generator=g)).to(cuda, torch.bfloat16)
    tables = torch.from_numpy(attn_mod.rope_tables((64, 32), 0.5, 64)).to(cuda)
    before = cuda_attn.attn_qkv_rope.launches
    got = cuda_attn.attn_qkv_rope(qkv, qv, tables, 0.125, heads, "clamp")
    torch.cuda.synchronize()
    assert cuda_attn.attn_qkv_rope.launches == before + 1
    want = cuda_attn.attn_qkv_rope_plain(qkv, qv, tables, 0.125, heads, "clamp")
    d = got.float() - want.float()
    assert d.abs().max().item() <= min(3e-2, 4 * BF16_EPS * want.float().abs().max().item())
    assert (d.norm() / want.float().norm()).item() <= BF16_EPS


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8 * 2048, 1000])  # the cell's rows after the merge; a row count no tile divides
def test_swiglu_mlp_at_eva02_widths(cuda, n):
    """The SwiGLU kernel chain at C 1024, M 2730 (padded to 2752) against its
    plain version: four bf16 steps of max|plain| and the error norm one step
    of the output's (#2's limits: ln, h and hl rounded at the same points).
    A second call on the same weights makes no operand copy and gives the
    same bits."""
    g = torch.Generator(device=cuda).manual_seed(n)
    c, m, bf = 1024, 2730, torch.bfloat16
    r = lambda *sh, s=1.0: s * torch.randn(sh, generator=g, device=cuda)  # noqa: E731
    args = (r(n, c).to(bf), 1 + r(c, s=0.1), r(c, s=0.1), (r(c, m) / c**0.5).to(bf), r(m, s=0.1).to(bf),
            (r(c, m) / c**0.5).to(bf), r(m, s=0.1).to(bf), 1 + r(m, s=0.1), r(m, s=0.1), (r(m, c) / m**0.5).to(bf),
            r(c, s=0.1).to(bf), 1e-6)
    before = cuda_mlp.swiglu_mlp.launches
    got = cuda_mlp.swiglu_mlp(*args)
    torch.cuda.synchronize()
    assert cuda_mlp.swiglu_mlp.launches == before + 1
    builds = cuda_mlp.swiglu_mlp.operand_builds
    assert torch.equal(cuda_mlp.swiglu_mlp(*args), got) and cuda_mlp.swiglu_mlp.operand_builds == builds
    want = cuda_mlp.swiglu_mlp_plain(*args)
    d = got.float() - want.float()
    assert d.abs().max().item() <= 4 * BF16_EPS * want.float().abs().max().item()
    assert (d.norm() / want.float().norm()).item() <= BF16_EPS


@pytest.mark.gpu
def test_bf16_train_step_prompt_gradient(cuda):
    """One bf16 ``train_step`` of EVA-02 at its published widths (C 1024, 16
    heads of 64, SwiGLU 2730) on the 896×448 canvas at patch 14, 6 blocks,
    B = 2 under the benchmark's draws: the RoPE attention and SwiGLU
    kernels forward, #4 and the plain SwiGLU backward. Its prompt gradient
    (Adam's first moment after one step) against the float32 reference's:
    cosine ≥ 0.99 and the norm within 5%, the room bf16 operands (8 bits)
    leave over 6 blocks (Painter's test's limits)."""
    cfg = eva02_config(num_hidden_layers=6, intermediate_hidden_state_indices=(2, 3, 4, 5))
    m = model_dict(cfg)
    w = make_weights(m, INIT, 5, cuda)
    model = build_model(cfg, torch.bfloat16, device=cuda, state=w)
    conf = BeachSegConfig(batch_size=2, crop_size=448, inpt_size=448, compute_dtype="bfloat16",
                          **{k: tuple(v) if isinstance(v, list) else v for k, v in AUG.items() if k != "erasing_ratio"})
    tuner = PromptTuner(model, conf, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    pixels = torch.rand((3, 448, 448, 3), generator=g, device=cuda)
    masks = torch.randint(0, 4, (3, 448, 448), generator=g, device=cuda)
    nodata = torch.zeros((3, 448, 448), dtype=torch.bool, device=cuda)
    batch = {"image": torch.rand((2, 448, 448, 3), generator=g, device=cuda),
             "mask": torch.randint(1, 4, (2, 448, 448), generator=g, device=cuda),
             "nodata": torch.zeros((2, 448, 448), dtype=torch.bool, device=cuda),
             "valid": torch.ones(2, dtype=torch.bool, device=cuda)}
    draws = traffic_draws.step_draws(g, 2, 448, 3, 4, AUG, m)
    state = tuner.init_state(pixels)
    a0, s0, b0 = cuda_attn.attn_qkv_rope.launches, cuda_mlp.swiglu_mlp.launches, cuda_attn.attn_bwd.launches
    state, metrics = tuner.train_step(state, masks, nodata, batch, draws=draws)
    assert (cuda_attn.attn_qkv_rope.launches - a0, cuda_mlp.swiglu_mlp.launches - s0,
            cuda_attn.attn_bwd.launches - b0) == (6, 6, 6)
    got = (state.opt_state["mu"] / 0.1).double()
    del tuner, model, state
    torch.cuda.empty_cache()
    loss, want = ref.loss_and_grad(w, m, {"loss_beta": conf.loss_beta}, AUG, pixels, masks, nodata, batch, draws,
                                   ref_seggpt.FP32)
    want = want.double()
    cos = (got * want).sum() / (got.norm() * want.norm())
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-2)
    assert cos.item() >= 0.99 and abs(got.norm().item() / want.norm().item() - 1) <= 0.05, (cos.item(), got.norm().item(), want.norm().item())


@pytest.mark.gpu
def test_bf16_model_with_resized_rel_tables(cuda, monkeypatch):
    """Fault §B1 on the card: a bf16 SegGPT at ViT-L's widths (3 blocks on
    the 56×28 grid) whose rel-pos tables have 2·27 − 1 rows where the grid
    wants 2·56 − 1 and 2·28 − 1, so ``get_rel_pos`` resizes them to fp32.
    Through kernel #1 (which takes bf16 tables only) against the same model
    through #1's plain version: ``PRED_REL_TOL`` of chip_smoke (5% of the
    canvas's scale) with ids mostly equal."""
    cfg = SegGPTConfig(num_hidden_layers=3, merge_index=0, intermediate_hidden_state_indices=(0, 1, 2))
    model = build_model(cfg, torch.bfloat16, device=cuda, seed=4)
    g = torch.Generator(device="cpu").manual_seed(0)
    for i in range(3):
        att = getattr(model.encoder, f"layers_{i}").attention
        att.rel_pos_h = torch.nn.Parameter((0.1 * torch.randn(53, 64, generator=g)).to(cuda), requires_grad=False)
        att.rel_pos_w = torch.nn.Parameter((0.1 * torch.randn(53, 64, generator=g)).to(cuda), requires_grad=False)
    rng = np.random.default_rng(0)
    q, p, pm = (torch.from_numpy(rng.standard_normal((2, 448, 448, 3)).astype(np.float32)).to(cuda) for _ in range(3))
    before = cuda_attn.attn_qkv_rel.launches
    with torch.no_grad():
        got = model(q, p, pm)["pred_masks"]
        torch.cuda.synchronize()
        assert cuda_attn.attn_qkv_rel.launches == before + 3
        monkeypatch.setattr(cuda_attn, "attn_qkv_rel", cuda_attn.attn_qkv_rel_plain)
        want = model(q, p, pm)["pred_masks"]
    assert (got - want).abs().max().item() <= 5e-2 * want.abs().max().item()
