from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig, huge_config, tiny_config
from beach_seg_tpu_torch.models.seggpt.convert import from_jax_params, load_npz, save_params
from beach_seg_tpu_torch.models.seggpt.load import load_model_params
from beach_seg_tpu_torch.models.seggpt.model import SegGPT, build_model, default_bool_masked_pos, random_state

__all__ = [
    "SegGPT",
    "SegGPTConfig",
    "build_model",
    "default_bool_masked_pos",
    "from_jax_params",
    "huge_config",
    "load_model_params",
    "load_npz",
    "random_state",
    "save_params",
    "tiny_config",
]
