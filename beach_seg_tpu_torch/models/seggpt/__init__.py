from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig, huge_config, tiny_config
from beach_seg_tpu_torch.models.seggpt.convert import from_jax_params, load_npz
from beach_seg_tpu_torch.models.seggpt.model import SegGPT, build_model, default_bool_masked_pos, random_state

__all__ = [
    "SegGPT",
    "SegGPTConfig",
    "build_model",
    "default_bool_masked_pos",
    "from_jax_params",
    "huge_config",
    "load_npz",
    "random_state",
    "tiny_config",
]
