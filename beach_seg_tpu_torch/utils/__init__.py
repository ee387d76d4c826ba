from beach_seg_tpu_torch.utils.device import device_for_platform, resolve_device

__all__ = ["device_for_platform", "resolve_device"]
