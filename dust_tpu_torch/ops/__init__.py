"""Per-ray and per-pixel operators (torch), one module per dust_tpu.ops module."""
