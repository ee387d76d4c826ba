"""SegGPT — in-context "image painting" segmentation ViT, as torch modules
(counterpart of ``beach_seg_tpu/models/seggpt/model.py``).

Layouts follow the JAX package so the two compare like with like: NHWC
images, ``x @ W`` kernels of shape (in, out), the qkv kernel as (C, 3, C),
and parameter names equal to the flax tree's paths joined by dots (see
``convert.from_jax_params``). Parameters stay fp32; every module casts them
to the compute dtype at use, as the flax modules do.

On the card the hot ops run hand-written CUDA kernels, forward and
backward: the qkv-rel attention (``ops.cuda_attn.qkv_rel_attention``)
whenever head_dim is 64 and the grid fits 64×64, the packed attention over
head-split q, k, v (``ops.cuda_attn.packed_attention``, the port of the TPU
package's ``_kernel_packed`` path) for other head dims, and the fused LN→MLP
(``ops.cuda_mlp.fused_ln_mlp``) under bf16, and under fp32 every linear
product of the encoder, the patch embed and the decoder embed
(``ops.cuda_gemm.linear``: split TF32 on the tensor cores, with the frozen
weights' TF32 parts made once). The packed kernel takes head
dims 64 and 80 (ViT-H); others (``tiny_config``'s 8) run on CPU tensors
through the plain versions and raise in ``attn_packed`` on CUDA.

Training runs the model with ``labels`` (the loss) and ``deterministic=False``
(drop-path). Autograd saves the compute-dtype weight copies the frozen
matmuls use (about 0.6 GB at ViT-L bf16), since a frozen weight's copy is
still an operand of the input gradient.

Input convention (HF semantics, axes transposed to NHWC):
  pixel_values        (B, H, W, 3)  query image
  prompt_pixel_values (B, H, W, 3)  prompt image
  prompt_masks        (B, H, W, 3)  colorized prompt mask
  labels              (B, H, W, 3)  colorized target (training only)
The model stacks prompt‖query along height into a (B, 2H, W, 3) canvas.

With ``config.window_size`` > 0 the model is Painter (``painter_config``,
ViTDet's block): a block outside ``global_attn_indexes`` pads the grid with
zeros to a multiple of the window, attends within each window through the
same kernels, with rel-pos tables of the window's size, and crops the pad
(:func:`window_partition`, :func:`window_unpartition`).
With ``config.block`` "eva02" the block is EVA-02's (``eva02_config``): q and k
rotate by the 2D RoPE (``ops.attention.rope_rotate``, the cos/sin tables a
device constant) in place of the rel-pos bias, the qkv bias covers q and v
only (``qv_bias``), a LayerNorm over C (``inner_layernorm``) precedes the
out projection, and the MLP is SwiGLU with a LayerNorm over its hidden
width (``ffn_layernorm``). Under bf16 at head_dim 64 the attention is
``ops.cuda_attn.rope_attention`` and the MLP ``ops.cuda_mlp.fused_swiglu_mlp``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig
from beach_seg_tpu_torch.ops import cuda_attn, cuda_gemm, cuda_mlp
from beach_seg_tpu_torch.ops.attention import (
    attention_reference,
    rel_pos_terms,
    rel_tables_padded,
    rope_rotate,
    rope_tables,
)
from beach_seg_tpu_torch.ops.resize import resize_2d
from beach_seg_tpu_torch.ops.sharding import (
    copy_to_model,
    data_sum,
    gather_from_model,
    model_axis_size,
    reduce_from_model,
)
from beach_seg_tpu_torch.utils.device import device_constant, resolve_device
from beach_seg_tpu_torch.utils.profiling import span


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape))


def _gelu(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """GELU in fp32 matched to the compute-dtype policy: exact erf form under
    fp32 (HF parity), tanh form under bf16."""
    return F.gelu(h.float(), approximate="tanh" if dtype == torch.bfloat16 else "none").to(dtype)


class PatchEmbed(nn.Module):
    """16×16/stride-16 patch embedding as reshape + matmul."""

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype):
        super().__init__()
        self.config, self.compute_dtype = config, dtype
        p = config.patch_size
        self.kernel = _param(p * p * config.num_channels, config.hidden_size)
        self.bias = _param(config.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, dt = self.config.patch_size, self.compute_dtype
        b, h, w, c = x.shape
        gh, gw = h // p, w // p
        # (B, gh, p, gw, p, C) → (B, gh, gw, p, p, C) → (B, gh, gw, p*p*C)
        patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh, gw, p * p * c)
        return cuda_gemm.linear(patches.to(dt), self.kernel.to(dt), self.bias.to(dt))


class Embeddings(nn.Module):
    """Patch embed + mask-token substitution + interpolated abs-pos +
    segment/type tokens; concatenates the pixel and mask streams on batch
    in the order [input, prompt] (HF modeling_seggpt.py:125-207). Without
    ``config.type_tokens`` (Painter) no type token is held or added, and
    ``embedding_type`` is not read."""

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype):
        super().__init__()
        self.config, self.compute_dtype = config, dtype
        hs = config.hidden_size
        tokens = ("mask_token", "segment_token_input", "segment_token_prompt")
        if config.type_tokens:
            tokens += ("type_token_semantic", "type_token_instance")
        for name in tokens:
            setattr(self, name, _param(1, 1, 1, hs))
        n_pos = (config.pretrain_image_size // config.patch_size) ** 2 + 1
        self.position_embeddings = _param(1, n_pos, hs)
        self.patch_embeddings = PatchEmbed(config, dtype)

    def forward(self, pixel_canvas, mask_canvas, bool_masked_pos, embedding_type="instance"):
        cfg, dt = self.config, self.compute_dtype
        hs = cfg.hidden_size
        input_embeddings = self.patch_embeddings(pixel_canvas)
        prompt_embeddings = self.patch_embeddings(mask_canvas)
        b, gh, gw, _ = input_embeddings.shape

        # replace masked mask-stream tokens with the learned mask token
        w = bool_masked_pos.to(dt).reshape(-1, gh, gw, 1)
        prompt_embeddings = prompt_embeddings * (1.0 - w) + self.mask_token.to(dt) * w

        # interpolate the pretrained abs-pos grid (bicubic, torch parity) in fp32
        pre = cfg.pretrain_image_size // cfg.patch_size
        pos = self.position_embeddings[:, 1:]
        if (pre, pre) != (gh, gw):
            grid = resize_2d(pos.reshape(1, pre, pre, hs).permute(0, 3, 1, 2), (gh, gw), "bicubic_torch")
            grid = grid.permute(0, 2, 3, 1)
        else:
            grid = pos.reshape(1, gh, gw, hs)
        grid = grid.to(dt)

        input_embeddings = input_embeddings + self.segment_token_input.to(dt) + grid
        prompt_embeddings = prompt_embeddings + self.segment_token_prompt.to(dt) + grid
        if cfg.type_tokens:
            type_token = self.type_token_semantic if embedding_type == "semantic" else self.type_token_instance
            input_embeddings = input_embeddings + type_token.to(dt)
            prompt_embeddings = prompt_embeddings + type_token.to(dt)
        return torch.cat([input_embeddings, prompt_embeddings], dim=0)


def qkv_bias_of(qv_bias: torch.Tensor) -> torch.Tensor:
    """EVA-02's (3C) qkv bias from its (2, C) q and v biases: none on k."""
    return torch.stack([qv_bias[0], torch.zeros_like(qv_bias[0]), qv_bias[1]]).reshape(-1)


class Attention(nn.Module):
    """MHA with decomposed relative position bias (HF :210-349) over the
    grid of its input: the whole canvas, or one window a row. ``grid``
    sizes the rel-pos tables (the config's grid when None).

    Under tensor parallelism (``parallel.mesh.shard_model``) the module holds
    whole heads of qkv and the matching rows of proj: it runs its local
    heads through the same kernels, then sums the ranks' proj outputs."""

    mesh = None

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype, grid: tuple[int, int] | None = None):
        super().__init__()
        self.config, self.compute_dtype = config, dtype
        c, hd = config.hidden_size, config.head_dim
        gh, gw = grid or config.grid_size
        eva = config.block == "eva02"
        self.qkv_kernel = _param(c, 3, c)
        if eva:
            self.qv_bias = _param(2, c)  # EVA-02's bias: on q and v, none on k
        else:
            self.qkv_bias = _param(3, c) if config.qkv_bias else None
        if config.use_relative_position_embeddings:
            self.rel_pos_h = _param(2 * gh - 1, hd)
            self.rel_pos_w = _param(2 * gw - 1, hd)
        self.proj_kernel = _param(c, c)
        self.proj_bias = _param(c)
        if eva:
            self.inner_layernorm = LayerNorm(c, config.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.config, self.compute_dtype
        if cfg.block == "eva02":
            return self._rope_forward(x)
        b, gh, gw, c = x.shape
        hd = cfg.head_dim
        s = gh * gw
        rel = cfg.use_relative_position_embeddings
        # the qkv-rel kernel's preconditions (JAX model.py:151-155)
        use_qkv_rel_kernel = rel and 2 * hd == 128 and c % 128 == 0 and gh <= 64 and gw <= 64
        cl = self.qkv_kernel.shape[-1]  # this rank's channels: whole heads
        if cl * model_axis_size(self.mesh) != c:
            raise RuntimeError(f"qkv holds {cl} of {c} channels, but the mesh has {model_axis_size(self.mesh)} model ranks")
        nh = cl // hd

        x = copy_to_model(x, self.mesh)
        # the qkv-rel kernel adds the bias itself
        qkv_bias = self.qkv_bias.reshape(3 * cl).to(dt) if self.qkv_bias is not None and not use_qkv_rel_kernel else None
        qkv4 = cuda_gemm.linear(x.reshape(b, s, c).to(dt), self.qkv_kernel.reshape(c, 3 * cl).to(dt), qkv_bias)
        qkv4 = qkv4.reshape(b, s, 3, cl)
        rel_params = (self.rel_pos_h.to(dt), self.rel_pos_w.to(dt)) if rel else None

        if use_qkv_rel_kernel:
            bias = self.qkv_bias.to(dt) if self.qkv_bias is not None else torch.zeros((3, cl), dtype=dt, device=x.device)
            # a table resized to the grid comes back fp32: the kernel takes the
            # dtype, as the TPU kernel casts inside itself
            rh_tab, rw_tab = (t.to(dt) for t in rel_tables_padded(*rel_params, (gh, gw), (gh, gw)))
            out = cuda_attn.qkv_rel_attention(qkv4, bias, rh_tab, rw_tab, hd**-0.5, gw, nh).reshape(b, gh, gw, cl)
        else:
            # (B, S, 3, nH, hd) → (3, B·nH, S, hd)
            qkv = qkv4.reshape(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4).reshape(3, b * nh, s, hd)
            q, k, v = qkv[0], qkv[1], qkv[2]
            if rel_params is not None:
                rel_h, rel_w = rel_pos_terms(q, *rel_params, (gh, gw), (gh, gw))
                out = cuda_attn.packed_attention(
                    q, k, v, rel_h.reshape(b * nh, s, gh), rel_w.reshape(b * nh, s, gw), hd**-0.5, nh
                ).reshape(b, gh, gw, cl)
            else:
                out = attention_reference(q, k, v, None, None, hd**-0.5)
                out = out.reshape(b, nh, gh, gw, hd).permute(0, 2, 3, 1, 4).reshape(b, gh, gw, cl)
        return reduce_from_model(cuda_gemm.linear(out, self.proj_kernel.to(dt)), self.mesh) + self.proj_bias.to(dt)

    def _rope_forward(self, x: torch.Tensor) -> torch.Tensor:
        """EVA-02's attention: q + bq, k and v + bv from one product, q and k
        rotated by the 2D RoPE, softmax(q·kᵀ·hd^−0.5)·v, the inner LN over C,
        then the out projection."""
        cfg, dt = self.config, self.compute_dtype
        b, gh, gw, c = x.shape
        hd, nh, s = cfg.head_dim, cfg.num_attention_heads, gh * gw
        if model_axis_size(self.mesh) != 1:
            raise RuntimeError("tensor parallelism of the EVA-02 block is not supported")
        step = (cfg.pretrain_image_size // cfg.patch_size) / gw  # EVA-02's pt_hw_seq_len / ft_seq_len
        tables = device_constant(rope_tables, (gh, gw), step, hd, device=x.device)
        kernel = dt == torch.bfloat16 and hd == 64
        qv = self.qv_bias.to(dt)
        full = None if kernel else qkv_bias_of(qv)
        qkv4 = cuda_gemm.linear(x.reshape(b, s, c).to(dt), self.qkv_kernel.reshape(c, 3 * c).to(dt), full)
        scale = hd**-0.5
        if kernel:
            out = cuda_attn.rope_attention(qkv4.reshape(b, s, 3, c), qv, tables, scale, gw, nh).reshape(b, gh, gw, c)
        else:
            qkv = qkv4.reshape(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4).reshape(3, b * nh, s, hd)
            q, k, v = rope_rotate(qkv[0], tables), rope_rotate(qkv[1], tables), qkv[2].contiguous()
            if hd in cuda_attn.HEAD_DIMS and gh <= 64 and gw <= 64:
                # the flash forward and backward with zero rel terms
                zh, zw = (torch.zeros((b * nh, s, n), dtype=dt, device=x.device) for n in (gh, gw))
                out = cuda_attn.fused_attention(q, k, v, zh, zw, scale, gh, gw)
            else:
                out = attention_reference(q, k, v, None, None, scale)
            out = out.reshape(b, nh, gh, gw, hd).permute(0, 2, 3, 1, 4).reshape(b, gh, gw, c)
        with span("bst.seggpt.sub_ln"):
            out = self.inner_layernorm(out)
        return cuda_gemm.linear(out, self.proj_kernel.to(dt)) + self.proj_bias.to(dt)


class Mlp(nn.Module):
    """Lin1 → GELU → Lin2; under tensor parallelism a column block of lin1
    and the rows of lin2 (Megatron's split), the ranks' outputs summed.
    With ``config.block`` "eva02": silu(x·W1 + b1) ⊙ (x·W2 + b2), a
    LayerNorm over the hidden width, then ·W3 + b3; one rank only."""

    mesh = None

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype):
        super().__init__()
        self.config, self.compute_dtype = config, dtype
        c, m = config.hidden_size, config.mlp_dim
        if config.block == "eva02":
            self.w1_kernel, self.w1_bias = _param(c, m), _param(m)
            self.w2_kernel, self.w2_bias = _param(c, m), _param(m)
            self.ffn_layernorm = LayerNorm(m, config.layer_norm_eps)
            self.w3_kernel, self.w3_bias = _param(m, c), _param(c)
            return
        self.lin1_kernel = _param(c, m)
        self.lin1_bias = _param(m)
        self.lin2_kernel = _param(m, c)
        self.lin2_bias = _param(c)

    @property
    def fuses_ln(self) -> bool:
        """Whether the bf16 path takes the LayerNorm before it (``ln_params``):
        the GELU MLP's kernels, and the SwiGLU MLP's at the widths they take."""
        cfg = self.config
        return cfg.block == "vit" or cuda_mlp.swiglu_takes(cfg.hidden_size, cfg.mlp_dim)

    def forward(self, x: torch.Tensor, ln_params=None) -> torch.Tensor:
        dt = self.compute_dtype
        if self.config.block == "eva02":
            return self._swiglu(x, ln_params)
        k1, b1 = self.lin1_kernel.to(dt), self.lin1_bias.to(dt)
        k2, b2 = self.lin2_kernel.to(dt), self.lin2_bias.to(dt)
        mp = model_axis_size(self.mesh)
        x = copy_to_model(x, self.mesh)
        if ln_params is not None:
            # LN+Lin1+GELU+Lin2 in one kernel; the LN params go in uncast
            # (fp32). Each rank adds b2/mp to its partial output, so the sum
            # over ranks adds b2 once (JAX pallas_mlp.py:133-137)
            ln_scale, ln_bias = ln_params
            out = cuda_mlp.fused_ln_mlp(
                x, ln_scale, ln_bias, k1, b1, k2, b2 / mp if mp > 1 else b2, self.config.layer_norm_eps,
                dt == torch.bfloat16,
            )
            return reduce_from_model(out, self.mesh)
        h = _gelu(cuda_gemm.linear(x, k1, b1), dt)
        return reduce_from_model(cuda_gemm.linear(h, k2), self.mesh) + b2

    def _swiglu(self, x: torch.Tensor, ln_params) -> torch.Tensor:
        cfg, dt = self.config, self.compute_dtype
        if model_axis_size(self.mesh) != 1:
            raise RuntimeError("tensor parallelism of the EVA-02 block is not supported")
        if ln_params is not None:
            # LN(C) → W1 ‖ W2 with silu·mul → LN(H) → W3 in one chain of
            # kernels, on the fp32 parameters: the wrapper rounds and pads
            # them once per weight
            ffn = self.ffn_layernorm
            return cuda_mlp.fused_swiglu_mlp(x, *ln_params, self.w1_kernel, self.w1_bias, self.w2_kernel, self.w2_bias,
                                             ffn.scale, ffn.bias, self.w3_kernel, self.w3_bias, cfg.layer_norm_eps)
        k1, b1 = self.w1_kernel.to(dt), self.w1_bias.to(dt)
        k2, b2 = self.w2_kernel.to(dt), self.w2_bias.to(dt)
        h = (F.silu(cuda_gemm.linear(x, k1, b1).float()) * cuda_gemm.linear(x, k2, b2).float()).to(dt)
        with span("bst.seggpt.sub_ln"):
            h = self.ffn_layernorm(h)
        return cuda_gemm.linear(h, self.w3_kernel.to(dt)) + self.w3_bias.to(dt)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, result in the input dtype (one fused
    fp32 ``F.layer_norm`` rather than the reference's op-by-op two-pass
    form: the same function up to fp32 rounding)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = _param(dim)
        self.bias = _param(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias, self.eps).to(x.dtype)


def drop_path(x: torch.Tensor, rate: float, mask: torch.Tensor | None) -> torch.Tensor:
    """Stochastic depth per sample (HF modeling_seggpt.py:368-385, JAX
    ``_drop_path``): ``x / keep * mask`` with ``mask`` (B,) of 0/1 kept
    samples, in that order; identity without a mask or at rate 0."""
    if mask is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return x / keep * mask.to(x.dtype).reshape(x.shape[0], *([1] * (x.ndim - 1)))


def drop_path_rates(config: SegGPTConfig) -> list[float]:
    """Per-layer rates, ``np.linspace`` in fp32 as the JAX package takes
    them (torch.linspace parity, JAX model.py:406)."""
    dpr = np.linspace(0.0, config.drop_path_rate, config.num_hidden_layers, dtype=np.float32)
    return [float(r) for r in dpr]


def ensemble_mean(attn_out: torch.Tensor, ensemble_cond: int, ensemble_groups: int, streams: int) -> torch.Tensor:
    """The feature ensemble (HF modeling_seggpt.py:426-436, JAX model.py:344-370):
    the query (bottom) half of the attention output averaged over each
    ensemble's prompts. The batch holds ``ensemble_groups`` ensembles of P
    prompts, rows group-major within each of its ``streams`` stacked streams
    [pixel, mask]. Before the merge (``ensemble_cond`` 2) each stream is
    averaged within each group; at ``merge_index`` (cond 1, still two
    streams) the mean spans both streams' rows of each group, HF's quirk;
    after the merge it is taken within each group. Unchanged when an
    ensemble is too small for its cond (HF's ``shape[0] // 2 >= cond``).
    Each mean is taken in fp32 and rounded once into the compute dtype."""
    per_group = attn_out.shape[0] // (streams * ensemble_groups)
    if streams * per_group // 2 < ensemble_cond:
        return attn_out
    half = attn_out.shape[1] // 2
    query = attn_out[:, half:].float()
    if ensemble_cond == 2:
        qp = query.reshape(2 * ensemble_groups, per_group, -1)
        qp = qp.mean(dim=1, keepdim=True).expand(qp.shape)
    elif streams == 2:
        qp = query.reshape(2, ensemble_groups, per_group, -1)
        qp = qp.mean(dim=(0, 2), keepdim=True).expand(qp.shape)
    else:
        qp = query.reshape(ensemble_groups, per_group, -1)
        qp = qp.mean(dim=1, keepdim=True).expand(qp.shape)
    return torch.cat([attn_out[:, :half], qp.reshape(query.shape).to(attn_out.dtype)], dim=1)


def window_partition(x: torch.Tensor, window: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """(B, H, W, C) → (B·nW, window, window, C) windows, row-major over the
    grid padded with zeros at the bottom and right to a multiple of
    ``window``, and the padded (Hp, Wp) (ViTDet's ``window_partition``).
    The pads are Python ints, so no value is read from the card."""
    b, h, w, c = x.shape
    ph, pw = -h % window, -w % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // window, window, wp // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window, window, c), (hp, wp)


def window_unpartition(x: torch.Tensor, window: int, padded: tuple[int, int], hw: tuple[int, int]) -> torch.Tensor:
    """The inverse of :func:`window_partition`: (B·nW, window, window, C)
    → (B, H, W, C), the pad cropped."""
    hp, wp = padded
    nh, nw = hp // window, wp // window
    b = x.shape[0] // (nh * nw)
    x = x.reshape(b, nh, nw, window, window, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, : hw[0], : hw[1]]


class Block(nn.Module):
    """Pre-LN transformer block with the optional feature ensemble (HF
    SegGptLayer, modeling_seggpt.py:403-447). With ``window`` > 0 the
    attention runs within window² windows of the LayerNormed grid (ViTDet's
    block, Painter's), the padded tokens zeros before qkv, so keys that
    carry only the qkv bias."""

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype, drop_path_rate: float = 0.0, window: int = 0):
        super().__init__()
        self.compute_dtype = dtype
        self.drop_path_rate = drop_path_rate
        self.window = window
        self.layernorm_before = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.attention = Attention(config, dtype, (window, window) if window else None)
        self.layernorm_after = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.mlp = Mlp(config, dtype)

    def forward(self, x: torch.Tensor, drop_masks=(None, None), ensemble_cond: int = 1,
                feature_ensemble: bool = False, ensemble_groups: int = 1, streams: int = 1) -> torch.Tensor:
        """``drop_masks``: (B,) keep masks of the attention and MLP branches,
        or None for no drop-path. ``feature_ensemble``: :func:`ensemble_mean`
        on the attention output, with ``streams`` the stream count the batch
        still carries (2 up to and including ``merge_index``)."""
        rate = self.drop_path_rate
        with span("bst.seggpt.attn"):
            attn_out = self.layernorm_before(x)
            if self.window:
                with span("bst.seggpt.window"):
                    attn_out, padded = window_partition(attn_out, self.window)
                with span("bst.seggpt.attn_win"):
                    attn_out = self.attention(attn_out)
                with span("bst.seggpt.window"):
                    attn_out = window_unpartition(attn_out, self.window, padded, x.shape[1:3])
            else:
                attn_out = self.attention(attn_out)
            if feature_ensemble:
                attn_out = ensemble_mean(attn_out, ensemble_cond, ensemble_groups, streams)
            x = x + drop_path(attn_out, rate, drop_masks[0])
        with span("bst.seggpt.mlp"):
            if self.compute_dtype == torch.bfloat16 and self.mlp.fuses_ln:
                ln = self.layernorm_after
                mlp_out = self.mlp(x, ln_params=(ln.scale, ln.bias))
            else:
                mlp_out = self.mlp(self.layernorm_after(x))
            return x + drop_path(mlp_out, rate, drop_masks[1])


class Encoder(nn.Module):
    """ViT with the pixel/mask stream merge at ``merge_index`` and
    LayerNormed intermediate collection (HF SegGptEncoder :450-507)."""

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype, remat: bool = False):
        super().__init__()
        self.config, self.remat = config, remat
        self.layernorm = LayerNorm(config.hidden_size, config.layer_norm_eps)
        for i, rate in enumerate(drop_path_rates(config)):
            self.add_module(f"layers_{i}", Block(config, dtype, rate, config.block_window(i)))

    def forward(self, x: torch.Tensor, drop_masks: list | None = None, feature_ensemble: bool = False,
                ensemble_groups: int = 1) -> list[torch.Tensor]:
        """``drop_masks``: one (attention, MLP) pair of keep masks per layer,
        each of the batch size the layer sees (2B up to ``merge_index``), or
        None for no drop-path. ``feature_ensemble``, ``ensemble_groups``: as
        :func:`ensemble_mean` takes them."""
        cfg = self.config
        # remat (JAX model.py:409-411, nn.remat(Block)): each block keeps only
        # its input for the backward and runs its forward again there. The
        # drop-path masks are arguments, so the recompute sees the same ones;
        # the kernels' autograd Functions keep their tensors through
        # save_for_backward, so the backward takes them from the recompute.
        remat = self.remat and torch.is_grad_enabled()
        intermediates = []
        for i in range(cfg.num_hidden_layers):
            block = getattr(self, f"layers_{i}")
            args = (x, drop_masks[i] if drop_masks is not None else (None, None),
                    2 if cfg.merge_index > i else 1, feature_ensemble, ensemble_groups, 2 if cfg.merge_index >= i else 1)
            if remat:
                x = checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(*args)
            if i == cfg.merge_index:
                half = x.shape[0] // 2
                x = (x[:half] + x[half:]) * 0.5
            if i in cfg.intermediate_hidden_state_indices:
                intermediates.append(self.layernorm(x))
        return intermediates


class Decoder(nn.Module):
    """Intermediate-concat → Linear → pixel-shuffle → Conv3×3+LN+GELU+Conv1×1
    (HF SegGptDecoder :537-591). NHWC throughout. Under tensor parallelism
    the embed is column-split and its blocks gathered before the shuffle."""

    mesh = None

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype):
        super().__init__()
        self.config, self.compute_dtype = config, dtype
        p, dh = config.patch_size, config.decoder_hidden_size
        cin = config.hidden_size * len(config.intermediate_hidden_state_indices)
        self.embed_kernel = _param(cin, p * p * dh)
        self.embed_bias = _param(p * p * dh)
        self.conv_kernel = _param(3, 3, dh, dh)  # HWIO
        self.conv_bias = _param(dh)
        self.layernorm = LayerNorm(dh, config.layer_norm_eps)
        self.head_kernel = _param(dh, 3)
        self.head_bias = _param(3)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.config, self.compute_dtype
        p, dh = cfg.patch_size, cfg.decoder_hidden_size
        b, gh, gw, _ = feats.shape
        h = cuda_gemm.linear(copy_to_model(feats, self.mesh), self.embed_kernel.to(dt), self.embed_bias.to(dt))
        h = gather_from_model(h, self.mesh)
        # pixel shuffle: (B, gh, gw, p, p, dh) → (B, gh·p, gw·p, dh)
        h = h.reshape(b, gh, gw, p, p, dh).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * p, gw * p, dh)
        # 3×3 "SAME" conv, NHWC/HWIO in the JAX layout → NCHW/OIHW for F.conv2d
        h = F.conv2d(h.to(dt).permute(0, 3, 1, 2), self.conv_kernel.to(dt).permute(3, 2, 0, 1), padding=1)
        h = h.permute(0, 2, 3, 1) + self.conv_bias.to(dt)
        h = _gelu(self.layernorm(h), dt)
        return h @ self.head_kernel.to(dt) + self.head_bias.to(dt)


def _query_half_mask(n: int) -> np.ndarray:
    """(n,) bool: the last ``n - n // 2`` patches, the query half, are masked."""
    return np.arange(n) >= n // 2


def default_bool_masked_pos(config: SegGPTConfig, batch: int, device=None) -> torch.Tensor:
    """Mask the bottom (query) half of the canvas (HF :926-934): a
    (batch, n) view of one (n,) mask copied to ``device`` once per n and
    device (:func:`device_constant`: read-only, no autograd history)."""
    n = config.num_patches
    return device_constant(_query_half_mask, n, device=device)[None, :].expand(batch, n)


def seggpt_loss(
    config: SegGPTConfig,
    prompt_masks: torch.Tensor,
    pred_masks: torch.Tensor,
    labels: torch.Tensor,
    bool_masked_pos: torch.Tensor,
    sample_weight: torch.Tensor | None = None,
    mesh=None,
) -> torch.Tensor:
    """Smooth-L1 on masked patches (HF SegGptLoss :804-843, JAX model.py:476-501).
    ``sample_weight`` (B,) optionally down-weights rows. With a data axis in
    ``mesh`` the sums run over every rank's rows (``ops.sharding.data_sum``)."""
    ground_truth = torch.cat([prompt_masks, labels], dim=1)
    b, h2, w, c = ground_truth.shape
    p = config.patch_size
    gh, gw = h2 // p, w // p
    mask = bool_masked_pos.reshape(b, gh, gw, 1, 1, 1).float()
    mask = mask.expand(b, gh, gw, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h2, w, c)
    if sample_weight is not None:
        mask = mask * sample_weight.float().reshape(b, 1, 1, 1)
    diff = (pred_masks - ground_truth).float()
    beta = config.beta
    l1 = diff.abs()
    loss = torch.where(l1 < beta, 0.5 * diff * diff / beta, l1 - 0.5 * beta)
    return data_sum((loss * mask).sum(), mesh) / data_sum(mask.sum(), mesh).clamp(min=1.0)


class SegGPT(nn.Module):
    """Full model: canvas assembly → embeddings → encoder → decoder.

    ``forward`` returns ``{"pred_masks": (B, 2H, W, 3) fp32, "loss"}``: the
    painted NHWC canvas, and the masked smooth-L1 when ``labels`` is given
    (else None). ``parallel.mesh.shard_model`` puts it on a mesh."""

    mesh = None

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config, self.compute_dtype = config, dtype
        self.embeddings = Embeddings(config, dtype)
        self.encoder = Encoder(config, dtype, remat)
        self.decoder = Decoder(config, dtype)

    def forward(
        self,
        pixel_values: torch.Tensor,
        prompt_pixel_values: torch.Tensor,
        prompt_masks: torch.Tensor,
        labels: torch.Tensor | None = None,
        bool_masked_pos: torch.Tensor | None = None,
        feature_ensemble: bool = False,
        embedding_type: str = "instance",
        deterministic: bool = True,
        decode_query_only: bool = False,
        drop_masks: list | None = None,
        ensemble_groups: int = 1,
    ) -> dict[str, torch.Tensor | None]:
        """``deterministic=False`` turns drop-path on: ``drop_masks`` as
        ``Encoder.forward`` takes them (:meth:`sample_drop_masks` draws them),
        required when the config's rate is positive. ``feature_ensemble``
        averages the query half across each ensemble's prompts in every
        layer (:func:`ensemble_mean`): the batch holds ``ensemble_groups``
        ensembles, rows group-major."""
        cfg, dt = self.config, self.compute_dtype
        with span("bst.seggpt"):
            with span("bst.seggpt.embed"):
                pixel_canvas = torch.cat([prompt_pixel_values, pixel_values], dim=1)
                mask_canvas = torch.cat([prompt_masks, labels if labels is not None else prompt_masks], dim=1)
                if bool_masked_pos is None:
                    bool_masked_pos = default_bool_masked_pos(cfg, pixel_canvas.shape[0], pixel_canvas.device)
                if deterministic:
                    drop_masks = None
                elif drop_masks is None and cfg.drop_path_rate > 0.0:
                    raise ValueError("drop-path (deterministic=False) needs drop_masks")
                x = self.embeddings(pixel_canvas.to(dt), mask_canvas.to(dt), bool_masked_pos, embedding_type)
            feats = self.encoder(x, drop_masks, feature_ensemble, ensemble_groups)
            with span("bst.seggpt.decoder"):
                feats = torch.cat(feats, dim=-1)
                if decode_query_only:
                    # decode the query patch rows plus a one-row halo for the 3×3
                    # conv, then drop the halo: equal to the bottom half of a full
                    # decode; the prompt half is zeros
                    half = feats.shape[1] // 2
                    p = cfg.patch_size
                    out = self.decoder(feats[:, half - 1 :].contiguous()).float()  # contiguous: one GEMM, not a batched one
                    top = out.new_zeros((out.shape[0], half * p, out.shape[2], 3))
                    pred_masks = torch.cat([top, out[:, p:]], dim=1)
                else:
                    pred_masks = self.decoder(feats).float()
            loss = None
            if labels is not None:
                with span("bst.seggpt.loss"):
                    loss = seggpt_loss(cfg, prompt_masks, pred_masks, labels, bool_masked_pos, mesh=self.mesh)
        return {"pred_masks": pred_masks, "loss": loss}

    def sample_drop_masks(self, generator: torch.Generator, batch: int) -> list:
        """Keep masks for every layer with a positive rate: Bernoulli(1 − rate)
        per sample of the batch the layer sees (2·batch up to and including
        ``merge_index``), attention branch first."""
        cfg = self.config
        masks = []
        for i, rate in enumerate(drop_path_rates(cfg)):
            n = 2 * batch if cfg.merge_index >= i else batch
            if rate == 0.0:
                masks.append((None, None))
                continue
            draw = torch.rand((2, n), generator=generator, device=generator.device) < 1.0 - rate
            masks.append((draw[0], draw[1]))
        return masks


@functools.lru_cache(maxsize=4)
def _random_tensors(config: SegGPTConfig, seed: int) -> tuple[tuple[str, torch.Tensor], ...]:
    rng = np.random.default_rng(seed)
    std = config.initializer_range
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in SegGPT(config).state_dict().items()}
    state = []
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            arr = np.ones(shape, np.float32)
        elif leaf.endswith("bias"):
            arr = np.zeros(shape, np.float32)
        else:
            arr = np.clip(rng.standard_normal(shape, dtype=np.float32) * np.float32(std), -2 * std, 2 * std)
        state.append((name, torch.from_numpy(arr)))
    return tuple(state)


def random_state(config: SegGPTConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded random weights (numpy, so CPU and GPU builds agree): LayerNorm
    scales 1, biases 0, everything else normal with the config's
    initializer range, clipped at ±2σ like the flax truncated-normal init.
    A draw is kept per (config, seed), since ViT-L's takes seconds on the
    host: the CPU tensors are shared between calls, so treat them as
    read-only (``build_model`` and ``load_model_params`` copy them)."""
    return dict(_random_tensors(config, seed))


def build_model(
    config: SegGPTConfig,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
    state: dict | None = None,
    seed: int = 0,
    remat: bool = False,
) -> SegGPT:
    """The model builder: a SegGPT on ``device`` (None → CUDA, raising if
    absent) with ``state`` (from ``convert``) or seeded random weights, in
    eval mode without gradients; ``remat`` recomputes each encoder block in
    the backward. On the ``meta`` device it has shapes and no weights."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = SegGPT(config, dtype, remat)
    if dev.type != "meta":
        model.load_state_dict(state if state is not None else random_state(config, seed))
    return model.eval().requires_grad_(False)
