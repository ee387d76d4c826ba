"""SegGPT — in-context "image painting" segmentation ViT, as torch modules
(counterpart of ``beach_seg_tpu/models/seggpt/model.py``).

Layouts follow the JAX package so the two compare like with like: NHWC
images, ``x @ W`` kernels of shape (in, out), the qkv kernel as (C, 3, C),
and parameter names equal to the flax tree's paths joined by dots (see
``convert.from_jax_params``). Parameters stay fp32; every module casts them
to the compute dtype at use, as the flax modules do.

On the card the two hot ops run hand-written CUDA kernels, forward and
backward: the qkv-rel attention (``ops.cuda_attn.qkv_rel_attention``)
whenever head_dim is 64 and the grid fits 64×64, the packed attention over
head-split q, k, v (``ops.cuda_attn.packed_attention``, the port of the TPU
package's ``_kernel_packed`` path) for other head dims, and the fused LN→MLP
(``ops.cuda_mlp.fused_ln_mlp``) under bf16. The packed kernel takes head
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
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig
from beach_seg_tpu_torch.ops import cuda_attn, cuda_mlp
from beach_seg_tpu_torch.ops.attention import attention_reference, rel_pos_terms, rel_tables_padded
from beach_seg_tpu_torch.ops.resize import resize_2d
from beach_seg_tpu_torch.utils.device import resolve_device


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
        return patches.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class Embeddings(nn.Module):
    """Patch embed + mask-token substitution + interpolated abs-pos +
    segment/type tokens; concatenates the pixel and mask streams on batch
    in the order [input, prompt] (HF modeling_seggpt.py:125-207)."""

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype):
        super().__init__()
        self.config, self.compute_dtype = config, dtype
        hs = config.hidden_size
        for name in ("mask_token", "segment_token_input", "segment_token_prompt",
                     "type_token_semantic", "type_token_instance"):
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

        type_token = self.type_token_semantic if embedding_type == "semantic" else self.type_token_instance
        input_embeddings = input_embeddings + self.segment_token_input.to(dt) + grid + type_token.to(dt)
        prompt_embeddings = prompt_embeddings + self.segment_token_prompt.to(dt) + grid + type_token.to(dt)
        return torch.cat([input_embeddings, prompt_embeddings], dim=0)


class Attention(nn.Module):
    """Global MHA with decomposed relative position bias (HF :210-349)."""

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype):
        super().__init__()
        self.config, self.compute_dtype = config, dtype
        c, hd = config.hidden_size, config.head_dim
        gh, gw = config.grid_size
        self.qkv_kernel = _param(c, 3, c)
        self.qkv_bias = _param(3, c) if config.qkv_bias else None
        if config.use_relative_position_embeddings:
            self.rel_pos_h = _param(2 * gh - 1, hd)
            self.rel_pos_w = _param(2 * gw - 1, hd)
        self.proj_kernel = _param(c, c)
        self.proj_bias = _param(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.config, self.compute_dtype
        b, gh, gw, c = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        s = gh * gw
        rel = cfg.use_relative_position_embeddings
        # the qkv-rel kernel's preconditions (JAX model.py:151-155)
        use_qkv_rel_kernel = rel and 2 * hd == 128 and c % 128 == 0 and gh <= 64 and gw <= 64

        qkv4 = (x.reshape(b, s, c).to(dt) @ self.qkv_kernel.reshape(c, 3 * c).to(dt)).reshape(b, s, 3, c)
        if self.qkv_bias is not None and not use_qkv_rel_kernel:
            qkv4 = qkv4 + self.qkv_bias.to(dt)  # the kernel adds the bias itself
        rel_params = (self.rel_pos_h.to(dt), self.rel_pos_w.to(dt)) if rel else None

        if use_qkv_rel_kernel:
            bias = self.qkv_bias.to(dt) if self.qkv_bias is not None else torch.zeros((3, c), dtype=dt, device=x.device)
            rh_tab, rw_tab = rel_tables_padded(*rel_params, (gh, gw), (gh, gw))
            out = cuda_attn.qkv_rel_attention(qkv4, bias, rh_tab, rw_tab, hd**-0.5, gw, nh).reshape(b, gh, gw, c)
        else:
            # (B, S, 3, nH, hd) → (3, B·nH, S, hd)
            qkv = qkv4.reshape(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4).reshape(3, b * nh, s, hd)
            q, k, v = qkv[0], qkv[1], qkv[2]
            if rel_params is not None:
                rel_h, rel_w = rel_pos_terms(q, *rel_params, (gh, gw), (gh, gw))
                out = cuda_attn.packed_attention(
                    q, k, v, rel_h.reshape(b * nh, s, gh), rel_w.reshape(b * nh, s, gw), hd**-0.5, nh
                ).reshape(b, gh, gw, c)
            else:
                out = attention_reference(q, k, v, None, None, hd**-0.5)
                out = out.reshape(b, nh, gh, gw, hd).permute(0, 2, 3, 1, 4).reshape(b, gh, gw, c)
        return out @ self.proj_kernel.to(dt) + self.proj_bias.to(dt)


class Mlp(nn.Module):
    def __init__(self, config: SegGPTConfig, dtype: torch.dtype):
        super().__init__()
        self.config, self.compute_dtype = config, dtype
        c, m = config.hidden_size, config.mlp_dim
        self.lin1_kernel = _param(c, m)
        self.lin1_bias = _param(m)
        self.lin2_kernel = _param(m, c)
        self.lin2_bias = _param(c)

    def forward(self, x: torch.Tensor, ln_params=None) -> torch.Tensor:
        dt = self.compute_dtype
        k1, b1 = self.lin1_kernel.to(dt), self.lin1_bias.to(dt)
        k2, b2 = self.lin2_kernel.to(dt), self.lin2_bias.to(dt)
        if ln_params is not None:
            # LN+Lin1+GELU+Lin2 in one kernel; the LN params go in uncast (fp32)
            ln_scale, ln_bias = ln_params
            return cuda_mlp.fused_ln_mlp(
                x, ln_scale, ln_bias, k1, b1, k2, b2, self.config.layer_norm_eps, dt == torch.bfloat16
            )
        h = _gelu(x @ k1 + b1, dt)
        return h @ k2 + b2


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


class Block(nn.Module):
    """Pre-LN transformer block (HF SegGptLayer, modeling_seggpt.py:403-447)."""

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype, drop_path_rate: float = 0.0):
        super().__init__()
        self.compute_dtype = dtype
        self.drop_path_rate = drop_path_rate
        self.layernorm_before = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.attention = Attention(config, dtype)
        self.layernorm_after = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.mlp = Mlp(config, dtype)

    def forward(self, x: torch.Tensor, drop_masks=(None, None)) -> torch.Tensor:
        """``drop_masks``: (B,) keep masks of the attention and MLP branches,
        or None for no drop-path."""
        rate = self.drop_path_rate
        x = x + drop_path(self.attention(self.layernorm_before(x)), rate, drop_masks[0])
        if self.compute_dtype == torch.bfloat16:
            ln = self.layernorm_after
            mlp_out = self.mlp(x, ln_params=(ln.scale, ln.bias))
        else:
            mlp_out = self.mlp(self.layernorm_after(x))
        return x + drop_path(mlp_out, rate, drop_masks[1])


class Encoder(nn.Module):
    """ViT with the pixel/mask stream merge at ``merge_index`` and
    LayerNormed intermediate collection (HF SegGptEncoder :450-507)."""

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype):
        super().__init__()
        self.config = config
        self.layernorm = LayerNorm(config.hidden_size, config.layer_norm_eps)
        for i, rate in enumerate(drop_path_rates(config)):
            self.add_module(f"layers_{i}", Block(config, dtype, rate))

    def forward(self, x: torch.Tensor, drop_masks: list | None = None) -> list[torch.Tensor]:
        """``drop_masks``: one (attention, MLP) pair of keep masks per layer,
        each of the batch size the layer sees (2B up to ``merge_index``), or
        None for no drop-path."""
        cfg = self.config
        intermediates = []
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layers_{i}")(x, drop_masks[i] if drop_masks is not None else (None, None))
            if i == cfg.merge_index:
                half = x.shape[0] // 2
                x = (x[:half] + x[half:]) * 0.5
            if i in cfg.intermediate_hidden_state_indices:
                intermediates.append(self.layernorm(x))
        return intermediates


class Decoder(nn.Module):
    """Intermediate-concat → Linear → pixel-shuffle → Conv3×3+LN+GELU+Conv1×1
    (HF SegGptDecoder :537-591). NHWC throughout."""

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
        h = feats @ self.embed_kernel.to(dt) + self.embed_bias.to(dt)
        # pixel shuffle: (B, gh, gw, p, p, dh) → (B, gh·p, gw·p, dh)
        h = h.reshape(b, gh, gw, p, p, dh).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * p, gw * p, dh)
        # 3×3 "SAME" conv, NHWC/HWIO in the JAX layout → NCHW/OIHW for F.conv2d
        h = F.conv2d(h.to(dt).permute(0, 3, 1, 2), self.conv_kernel.to(dt).permute(3, 2, 0, 1), padding=1)
        h = h.permute(0, 2, 3, 1) + self.conv_bias.to(dt)
        h = _gelu(self.layernorm(h), dt)
        return h @ self.head_kernel.to(dt) + self.head_bias.to(dt)


def default_bool_masked_pos(config: SegGPTConfig, batch: int, device=None) -> torch.Tensor:
    """Mask the bottom (query) half of the canvas (HF :926-934)."""
    n = config.num_patches
    m = torch.cat([torch.zeros(n // 2, dtype=torch.bool), torch.ones(n - n // 2, dtype=torch.bool)])
    return m.to(device)[None, :].expand(batch, n)


def seggpt_loss(
    config: SegGPTConfig,
    prompt_masks: torch.Tensor,
    pred_masks: torch.Tensor,
    labels: torch.Tensor,
    bool_masked_pos: torch.Tensor,
    sample_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """Smooth-L1 on masked patches (HF SegGptLoss :804-843, JAX model.py:476-501).
    ``sample_weight`` (B,) optionally down-weights rows."""
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
    return (loss * mask).sum() / mask.sum().clamp(min=1.0)


class SegGPT(nn.Module):
    """Full model: canvas assembly → embeddings → encoder → decoder.

    ``forward`` returns ``{"pred_masks": (B, 2H, W, 3) fp32, "loss"}``: the
    painted NHWC canvas, and the masked smooth-L1 when ``labels`` is given
    (else None). Feature ensembles are not ported yet and raise."""

    def __init__(self, config: SegGPTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.compute_dtype = config, dtype
        self.embeddings = Embeddings(config, dtype)
        self.encoder = Encoder(config, dtype)
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
    ) -> dict[str, torch.Tensor | None]:
        """``deterministic=False`` turns drop-path on: ``drop_masks`` as
        ``Encoder.forward`` takes them (:meth:`sample_drop_masks` draws them),
        required when the config's rate is positive."""
        if feature_ensemble:
            raise NotImplementedError("feature ensembles are not ported yet (ROADMAP.md §A item 2)")
        cfg, dt = self.config, self.compute_dtype
        pixel_canvas = torch.cat([prompt_pixel_values, pixel_values], dim=1)
        mask_canvas = torch.cat([prompt_masks, labels if labels is not None else prompt_masks], dim=1)
        if bool_masked_pos is None:
            bool_masked_pos = default_bool_masked_pos(cfg, pixel_canvas.shape[0], pixel_canvas.device)
        if deterministic:
            drop_masks = None
        elif drop_masks is None and cfg.drop_path_rate > 0.0:
            raise ValueError("drop-path (deterministic=False) needs drop_masks")
        x = self.embeddings(pixel_canvas.to(dt), mask_canvas.to(dt), bool_masked_pos, embedding_type)
        feats = torch.cat(self.encoder(x, drop_masks), dim=-1)
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
            loss = seggpt_loss(cfg, prompt_masks, pred_masks, labels, bool_masked_pos)
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
) -> SegGPT:
    """The model builder: a SegGPT on ``device`` (None → CUDA, raising if
    absent) with ``state`` (from ``convert``) or seeded random weights, in
    eval mode without gradients. On the ``meta`` device it has shapes and
    no weights."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = SegGPT(config, dtype)
    if dev.type != "meta":
        model.load_state_dict(state if state is not None else random_state(config, seed))
    return model.eval().requires_grad_(False)
