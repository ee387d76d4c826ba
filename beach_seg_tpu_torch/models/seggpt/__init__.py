"""SegGPT as torch modules and its weights bridge. ``load_params`` and
``init_random`` are the JAX package's names for the port's ``load_npz`` (a
``save_params`` file → module state) and ``random_state`` (seeded random
weights); both names are exported."""

from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig, eva02_config, huge_config, painter_config, tiny_config
from beach_seg_tpu_torch.models.seggpt.convert import (
    config_from_hf,
    convert_torch_state_dict,
    from_jax_params,
    load_npz,
    load_params,
    save_params,
)
from beach_seg_tpu_torch.models.seggpt.load import init_random, load_model_params
from beach_seg_tpu_torch.models.seggpt.model import (
    SegGPT,
    build_model,
    default_bool_masked_pos,
    random_state,
    seggpt_loss,
)

__all__ = [
    "SegGPT",
    "SegGPTConfig",
    "build_model",
    "config_from_hf",
    "convert_torch_state_dict",
    "default_bool_masked_pos",
    "eva02_config",
    "from_jax_params",
    "huge_config",
    "init_random",
    "load_model_params",
    "load_npz",
    "load_params",
    "painter_config",
    "random_state",
    "save_params",
    "seggpt_loss",
    "tiny_config",
]
