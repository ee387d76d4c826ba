"""Host utilities: configs from YAML and the command line, .env files, run
dirs and loggers, tracing and step timing, and the device rule. The JAX
package's ``utils.profiling.enable_compilation_cache`` has no counterpart
(the port compiles no programs at run time; see ``utils.profiling``)."""

from beach_seg_tpu_torch.utils.confix import load_yaml, merge_dotlist, parse_cli, save_yaml
from beach_seg_tpu_torch.utils.device import device_for_platform, resolve_device
from beach_seg_tpu_torch.utils.env import find_dotenv, load_dotenv
from beach_seg_tpu_torch.utils.logging import allocate_run_dir, setup_logger
from beach_seg_tpu_torch.utils.profiling import StepTimer, maybe_trace

__all__ = [
    "StepTimer",
    "allocate_run_dir",
    "device_for_platform",
    "find_dotenv",
    "load_dotenv",
    "load_yaml",
    "maybe_trace",
    "merge_dotlist",
    "parse_cli",
    "resolve_device",
    "save_yaml",
    "setup_logger",
]
