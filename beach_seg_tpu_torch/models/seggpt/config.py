"""SegGPT architecture configuration (copy of
``beach_seg_tpu/models/seggpt/config.py``).

Mirrors the hyperparameters of ``BAAI/seggpt-vit-large`` (HF
``transformers/models/seggpt/configuration_seggpt.py:93-140``). Three
fields the JAX package lacks describe Painter (:func:`painter_config`), the
in-context painter SegGPT was built on: ``window_size`` (0: every block
attends over the whole grid, SegGPT's topology), ``global_attn_indexes``
(the blocks that still do when windows are on) and ``type_tokens``
(SegGPT's semantic/instance tokens, which Painter's embedding lacks).
One more, ``block``, picks what a block computes: "vit" (the plain ViT
block: rel-pos bias, a full qkv bias, LN → Lin → GELU → Lin) or "eva02"
(EVA-02's block, :func:`eva02_config`: 2D rotary positions on q and k in
place of the rel-pos bias, at t = index · the pretrain grid's side / the
grid's width on both axes, EVA-02's ``pt_hw_seq_len`` over
``ft_seq_len``; a qkv bias on q and v only; a LayerNorm over C before the
attention's out projection; the MLP silu(x·W1 + b1) ⊙ (x·W2 + b2), a
LayerNorm over the hidden width, then ·W3 + b3).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SegGPTConfig:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    mlp_dim: int = 0  # 0 → 4 * hidden_size
    hidden_dropout_prob: float = 0.0
    layer_norm_eps: float = 1e-6
    image_size: tuple[int, int] = (896, 448)  # prompt‖query canvas (H, W)
    patch_size: int = 16
    num_channels: int = 3
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    pretrain_image_size: int = 224
    decoder_hidden_size: int = 64
    use_relative_position_embeddings: bool = True
    merge_index: int = 2
    intermediate_hidden_state_indices: tuple[int, ...] = (5, 11, 17, 23)
    beta: float = 0.01
    initializer_range: float = 0.02
    window_size: int = 0  # > 0: blocks outside global_attn_indexes attend within window_size² windows
    global_attn_indexes: tuple[int, ...] = ()
    type_tokens: bool = True
    block: str = "vit"  # "vit" | "eva02"

    def __post_init__(self):
        if self.mlp_dim == 0:
            object.__setattr__(self, "mlp_dim", 4 * self.hidden_size)
        if self.merge_index > min(self.intermediate_hidden_state_indices):
            raise ValueError("merge_index must precede the first intermediate index")
        # a topology read from JSON carries lists
        object.__setattr__(self, "global_attn_indexes", tuple(self.global_attn_indexes))
        if self.window_size < 0:
            raise ValueError(f"window_size must be 0 (all global) or positive, got {self.window_size}")
        bad = [i for i in self.global_attn_indexes if not 0 <= i < self.num_hidden_layers]
        if bad:
            raise ValueError(f"global_attn_indexes {bad} outside the {self.num_hidden_layers} blocks")
        if self.block not in ("vit", "eva02"):
            raise ValueError(f"block must be 'vit' or 'eva02', got {self.block!r}")
        if self.block == "eva02" and (self.use_relative_position_embeddings or self.window_size
                                      or not self.qkv_bias or self.head_dim % 4):
            raise ValueError("the eva02 block's RoPE takes the place of the rel-pos bias over a global grid, "
                             "with its q/v bias and head_dim % 4 == 0")

    @property
    def grid_size(self) -> tuple[int, int]:
        return (self.image_size[0] // self.patch_size, self.image_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def block_window(self, i: int) -> int:
        """Block ``i``'s window side, 0 when it attends over the whole grid."""
        return 0 if i in self.global_attn_indexes else self.window_size


def tiny_config(**overrides) -> SegGPTConfig:
    """A miniature config for fast tests/parity checks (same topology)."""
    base = dict(
        hidden_size=32,
        num_hidden_layers=6,
        num_attention_heads=4,
        image_size=(64, 32),
        patch_size=8,
        pretrain_image_size=32,
        decoder_hidden_size=16,
        merge_index=1,
        intermediate_hidden_state_indices=(2, 5),
        drop_path_rate=0.1,
    )
    base.update(overrides)
    return SegGPTConfig(**base)


def huge_config(**overrides) -> SegGPTConfig:
    """ViT-H-class scale-up (BeachSegConfig.backbone="huge")."""
    base = dict(
        hidden_size=1280,
        num_hidden_layers=32,
        num_attention_heads=16,
        intermediate_hidden_state_indices=(7, 15, 23, 31),
    )
    base.update(overrides)
    return SegGPTConfig(**base)


def painter_config(**overrides) -> SegGPTConfig:
    """Painter ViT-L (arXiv:2212.02499; ``models_painter.py``'s
    ``painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1``): SegGPT's
    ViT-L widths, canvas, merge, intermediates and decoder, every third
    block global and the other 16 in 14×14 windows, no type tokens
    (BeachSegConfig.backbone="painter")."""
    base = dict(window_size=14, global_attn_indexes=(2, 5, 8, 11, 14, 17, 20, 23), type_tokens=False)
    base.update(overrides)
    return SegGPTConfig(**base)


def eva02_config(**overrides) -> SegGPTConfig:
    """EVA-02-L/14's block (arXiv:2303.11331; the widths of EVA-02-CLIP-L-14's
    vision tower, arXiv:2303.15389) in SegGPT's painter topology
    (BeachSegConfig.backbone="eva02"): 24 layers of C 1024, 16 heads of 64,
    a SwiGLU MLP of int(1024 · 2.6667) = 2730 with sub-LN, 2D RoPE in place
    of the rel-pos bias, q/v-only bias; patch 14 on the 896×448 canvas (a
    64×32 grid), SegGPT's embedding from a 16×16 pretrain grid, merge,
    intermediates and decoder; every block global."""
    base = dict(
        patch_size=14,
        mlp_dim=2730,
        use_relative_position_embeddings=False,
        block="eva02",
    )
    base.update(overrides)
    return SegGPTConfig(**base)
