"""Scene assembly and the per-frame pipeline (torch)."""
