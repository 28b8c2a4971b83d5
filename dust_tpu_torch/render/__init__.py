"""Scene assembly and the per-frame pipeline (torch)."""

from dust_tpu_torch.render.scene import DeviceScene, build_device_scene  # noqa: F401
