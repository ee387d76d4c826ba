"""The weights bridge (counterpart of ``beach_seg_tpu/models/seggpt/convert.py``):
the JAX package's parameter tree, its npz files and HF torch SegGPT state
dicts → the port's module state, and the port's state → the same npz files.

The port's parameter names are the flax tree's paths joined by dots, and its
tensors keep the flax layouts, so the bridge only flattens. The npz format
(``save_params`` / ``load_npz``) is the JAX package's: keys are the tree
paths joined by "/", the topology may ride along as a JSON entry, and older
files store qkv as (C, 3C)/(3C,). ``convert_torch_state_dict`` maps an HF
``SegGptForImageSegmentation`` state dict onto the flax tree: linear weights
transposed (torch stores (out, in)), convs OIHW→HWIO, the patch-embed conv
flattened to PatchEmbed's (p·p·C, hidden) matmul kernel.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig
from beach_seg_tpu_torch.utils.device import resolve_device

_CONFIG_KEY = "__config_json__"
# SegGPTConfig's fields that the JAX package's config lacks
PORT_ONLY = ("window_size", "global_attn_indexes", "type_tokens", "block")
_DEFAULTS = {f.name: f.default for f in dataclasses.fields(SegGPTConfig)}


def _qkv3(a: np.ndarray) -> np.ndarray:
    """(…, 3C) qkv weight/bias → (…, 3, C)."""
    return a.reshape(a.shape[:-1] + (3, a.shape[-1] // 3))


def from_jax_params(tree: Mapping[str, Any], device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Nested dict of arrays (as flax ``init`` or ``convert.load_params``
    gives it) → ``{dotted.path: tensor}`` on ``device`` (None → CUDA)."""
    dev = resolve_device(device)
    state: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                state[key] = torch.tensor(np.asarray(v), device=dev)

    walk(tree, "")
    return state


def load_npz(path: Path | str, device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """The port's reader of ``convert.save_params`` files → module state on
    ``device`` (None → CUDA)."""
    dev = resolve_device(device)
    state: dict[str, torch.Tensor] = {}
    with np.load(path) as data:
        for key in data.files:
            if key == _CONFIG_KEY:
                continue
            parts = key.split("/")
            arr = data[key]
            # older checkpoints stored qkv as (C, 3C)/(3C,): reshape to the
            # current (C, 3, C)/(3, C) layout (values identical)
            if parts[-1] == "qkv_kernel" and arr.ndim == 2:
                arr = _qkv3(arr)
            elif parts[-1] == "qkv_bias" and arr.ndim == 1:
                arr = _qkv3(arr)
            state[".".join(parts)] = torch.as_tensor(arr, device=dev)
    return state



# the JAX package's name for the reader of save_params files
load_params = load_npz


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def convert_torch_state_dict(sd: Mapping[str, Any], config: SegGPTConfig) -> dict:
    """HF torch state dict → the flax parameter tree (nested dict of numpy
    arrays); ``from_jax_params`` turns it into module state."""
    g = lambda k: _np(sd[k])  # noqa: E731

    def ln(prefix: str) -> dict:
        return {"scale": g(f"{prefix}.weight"), "bias": g(f"{prefix}.bias")}

    proj_w = g("model.embeddings.patch_embeddings.projection.weight")  # (H, C, p, p)
    hidden = proj_w.shape[0]
    patch_kernel = proj_w.transpose(2, 3, 1, 0).reshape(-1, hidden)  # (p·p·C, H)

    embeddings = {
        "mask_token": g("model.embeddings.mask_token"),
        "segment_token_input": g("model.embeddings.segment_token_input"),
        "segment_token_prompt": g("model.embeddings.segment_token_prompt"),
        "type_token_semantic": g("model.embeddings.type_token_semantic"),
        "type_token_instance": g("model.embeddings.type_token_instance"),
        "position_embeddings": g("model.embeddings.position_embeddings"),
        "patch_embeddings": {
            "kernel": patch_kernel,
            "bias": g("model.embeddings.patch_embeddings.projection.bias"),
        },
    }

    encoder: dict[str, Any] = {"layernorm": ln("model.encoder.layernorm")}
    for i in range(config.num_hidden_layers):
        p = f"model.encoder.layers.{i}"
        layer = {
            "layernorm_before": ln(f"{p}.layernorm_before"),
            "layernorm_after": ln(f"{p}.layernorm_after"),
            "attention": {
                "qkv_kernel": _qkv3(g(f"{p}.attention.qkv.weight").T),  # (C, 3, C)
                "proj_kernel": g(f"{p}.attention.proj.weight").T,
                "proj_bias": g(f"{p}.attention.proj.bias"),
            },
            "mlp": {
                "lin1_kernel": g(f"{p}.mlp.lin1.weight").T,
                "lin1_bias": g(f"{p}.mlp.lin1.bias"),
                "lin2_kernel": g(f"{p}.mlp.lin2.weight").T,
                "lin2_bias": g(f"{p}.mlp.lin2.bias"),
            },
        }
        if config.qkv_bias:
            layer["attention"]["qkv_bias"] = _qkv3(g(f"{p}.attention.qkv.bias"))
        if config.use_relative_position_embeddings:
            layer["attention"]["rel_pos_h"] = g(f"{p}.attention.rel_pos_h")
            layer["attention"]["rel_pos_w"] = g(f"{p}.attention.rel_pos_w")
        encoder[f"layers_{i}"] = layer

    head_w = g("decoder.decoder_pred.head.weight")  # (3, dh, 1, 1)
    decoder = {
        "embed_kernel": g("decoder.decoder_embed.weight").T,
        "embed_bias": g("decoder.decoder_embed.bias"),
        "conv_kernel": g("decoder.decoder_pred.conv.weight").transpose(2, 3, 1, 0),
        "conv_bias": g("decoder.decoder_pred.conv.bias"),
        "layernorm": ln("decoder.decoder_pred.layernorm"),
        "head_kernel": head_w.reshape(head_w.shape[0], head_w.shape[1]).T,
        "head_bias": g("decoder.decoder_pred.head.bias"),
    }

    return {"embeddings": embeddings, "encoder": encoder, "decoder": decoder}


def config_from_hf(hf_config) -> SegGPTConfig:
    """The port's config from a transformers ``SegGptConfig`` instance."""
    return SegGPTConfig(
        hidden_size=hf_config.hidden_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        mlp_dim=hf_config.mlp_dim,
        layer_norm_eps=hf_config.layer_norm_eps,
        image_size=tuple(hf_config.image_size),
        patch_size=hf_config.patch_size,
        num_channels=hf_config.num_channels,
        qkv_bias=hf_config.qkv_bias,
        drop_path_rate=hf_config.drop_path_rate,
        pretrain_image_size=hf_config.pretrain_image_size,
        decoder_hidden_size=hf_config.decoder_hidden_size,
        use_relative_position_embeddings=hf_config.use_relative_position_embeddings,
        merge_index=hf_config.merge_index,
        intermediate_hidden_state_indices=tuple(hf_config.intermediate_hidden_state_indices),
        beta=hf_config.beta,
    )


def save_params(params: Mapping[str, Any], path: Path | str, config: SegGPTConfig | None = None) -> None:
    """Write module state (``{dotted.path: tensor}``) or a flax-layout tree
    to a compressed npz in the JAX package's format (no pickle). With
    ``config`` the topology rides along, so loaders rebuild the exact model."""
    flat: dict[str, np.ndarray] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for k, v in node.items():
            key = f"{prefix}/{k.replace('.', '/')}" if prefix else k.replace(".", "/")
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                flat[key] = _np(v)

    walk(params, "")
    if config is not None:
        flat[_CONFIG_KEY] = np.frombuffer(json.dumps(_stored_topology(config)).encode(), dtype=np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)


def _stored_topology(config: SegGPTConfig) -> dict:
    """The config's fields, less the port-only Painter fields and ``block``
    (``PORT_ONLY``) at their defaults: a SegGPT topology stays readable by the
    JAX package, whose config has no such fields."""
    raw = dataclasses.asdict(config)
    for name in PORT_ONLY:
        if raw[name] == _DEFAULTS[name]:
            del raw[name]
    return raw


def load_config(path: Path | str) -> SegGPTConfig | None:
    """Topology embedded by ``save_params``, or None for older files."""
    with np.load(path) as data:
        if _CONFIG_KEY not in data.files:
            return None
        raw = json.loads(bytes(data[_CONFIG_KEY]).decode())
    for k in ("image_size", "intermediate_hidden_state_indices"):
        if k in raw and isinstance(raw[k], list):
            raw[k] = tuple(raw[k])
    return SegGPTConfig(**raw)
