"""Image comparison: RMSE / PSNR between two renders (port of
``tools/rmse.py``).

Usage: python -m dust_tpu_torch.tools.rmse a.png b.png
"""

from __future__ import annotations

import sys

import numpy as np


def rmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def psnr(a, b, peak: float = 1.0) -> float:
    e = rmse(a, b)
    return float("inf") if e == 0 else 20.0 * np.log10(peak / e)


def main(argv=None) -> int:
    from dust_tpu_torch.utils.image import read_png

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m dust_tpu_torch.tools.rmse a.png b.png",
              file=sys.stderr)
        return 2
    a = read_png(argv[0]).astype(np.float64) / 255.0
    b = read_png(argv[1]).astype(np.float64) / 255.0
    e = rmse(a, b)
    print(f"rmse {e:.5f} ({e*100:.2f}%), psnr {psnr(a, b):.2f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
