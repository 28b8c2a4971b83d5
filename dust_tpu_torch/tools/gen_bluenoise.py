"""The blue-noise assets (port of ``tools/gen_bluenoise.py``, numpy).

:func:`main`: a 128×128 blue-noise rank texture by Ulichney's
void-and-cluster with a toroidal gaussian energy (sigma 1.9), every
convolution by FFT; uint16 ranks 0..16383 in
``dust_tpu_torch/assets/bluenoise128.npy``.

:func:`gen_stbn`: the spatio-temporal volume (reference:
``assets/stbn/*.png``, 128×128×64, ``crates/render/src/noise.rs``) by
greedy stratified void-filling over a toroidal (T, N, N) volume with a
separable gaussian energy (spatial sigma 1.9 within a slice, temporal
sigma 1.1 across slices): each slice is an exact stratified uniform set
that is spatially blue, and each pixel's values decorrelate from frame
to frame. uint16 per-slice ranks in
``dust_tpu_torch/assets/stbn128x64.npy`` (hours at the full size).

:mod:`dust_tpu_torch.ops.noise` derives the six blue-noise tables from
these files. Both take their size and seed as parameters (the
reference's module constants are the defaults), so the same size and
seed give the reference's arrays.

Usage:
  python -m dust_tpu_torch.tools.gen_bluenoise [stbn] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

N = 128
SIGMA = 1.9
SEED = 0x5717B9
STBN_SEED = 0x57B1
_ASSETS = Path(__file__).resolve().parents[1] / "assets"


def _energy_kernel(n: int, sigma: float):
    ax = np.arange(n)
    d = np.minimum(ax, n - ax).astype(np.float64)
    dx, dy = np.meshgrid(d, d, indexing="ij")
    r2 = dx * dx + dy * dy
    return np.exp(-r2 / (2.0 * sigma * sigma))


def _filtered(binary, kf):
    return np.real(np.fft.ifft2(np.fft.fft2(binary) * kf))


def main(out_path=_ASSETS / "bluenoise128.npy", n: int = N,
         seed: int = SEED, sigma: float = SIGMA) -> np.ndarray:
    """(n, n) uint16 ranks 0..n*n-1, written to ``out_path`` (None: no
    file); returns them."""
    rng = np.random.default_rng(seed)
    kf = np.fft.fft2(_energy_kernel(n, sigma))
    total = n * n
    ones_target = total // 10

    # Initial binary pattern: random, then swap the tightest cluster with
    # the largest void until stable.
    binary = np.zeros((n, n), dtype=np.float64)
    idx = rng.choice(total, ones_target, replace=False)
    binary.flat[idx] = 1.0
    for _ in range(total):
        e = _filtered(binary, kf)
        cluster = np.unravel_index(
            np.argmax(np.where(binary > 0, e, -np.inf)), e.shape)
        binary[cluster] = 0.0
        e = _filtered(binary, kf)
        void = np.unravel_index(
            np.argmin(np.where(binary > 0, np.inf, e)), e.shape)
        binary[void] = 1.0
        if void == cluster:
            break

    rank = np.zeros((n, n), dtype=np.int64)
    # Phase 1: remove ones, ranking them down from ones_target-1.
    work = binary.copy()
    for r in range(ones_target - 1, -1, -1):
        e = _filtered(work, kf)
        c = np.unravel_index(np.argmax(np.where(work > 0, e, -np.inf)),
                             e.shape)
        work[c] = 0.0
        rank[c] = r
    # Phase 2: fill voids upward.
    work = binary.copy()
    for r in range(ones_target, total):
        e = _filtered(work, kf)
        c = np.unravel_index(np.argmin(np.where(work > 0, np.inf, e)),
                             e.shape)
        work[c] = 1.0
        rank[c] = r
    rank = rank.astype(np.uint16)
    if out_path is not None:
        np.save(out_path, rank)
        print(f"wrote {out_path}; rank uniques={len(np.unique(rank))}")
    return rank


def gen_stbn(T=64, N=N, sigma_s=1.9, sigma_t=1.1, seed=STBN_SEED,
             out_path=_ASSETS / "stbn128x64.npy") -> np.ndarray:
    """Per-slice ranks 0..N*N-1 as (T, N, N) uint16, written to
    ``out_path`` (None: no file); returns them."""
    rng = np.random.default_rng(seed)
    Rs = max(3, int(np.ceil(4.0 * sigma_s)))
    Rt = min(max(2, int(np.ceil(4.0 * sigma_t))), T // 2)
    ds = np.arange(-Rs, Rs + 1)
    dt = np.arange(-Rt, Rt + 1)
    ks = np.exp(-(ds ** 2) / (2 * sigma_s ** 2))
    kt = np.exp(-(dt ** 2) / (2 * sigma_t ** 2))
    K = kt[:, None, None] * ks[None, :, None] * ks[None, None, :]
    E = rng.random((T, N, N)) * 1e-6  # tie-break jitter
    occ = np.zeros((T, N, N), bool)
    rank = np.zeros((T, N, N), np.int32)
    t0 = time.time()
    order = np.arange(T)
    for r in range(N * N):
        rng.shuffle(order)  # vary the slice visit order: no fixed t precedence
        for t in order:
            sl = np.where(occ[t], np.inf, E[t])
            i = int(np.argmin(sl))
            y, x = divmod(i, N)
            occ[t, y, x] = True
            rank[t, y, x] = r
            E[np.ix_((t + dt) % T, (y + ds) % N, (x + ds) % N)] += K
        if r % 2048 == 0:
            print(f"  rank {r}/{N*N}  ({time.time()-t0:.0f}s)", flush=True)
    rank = rank.astype(np.uint16)
    if out_path is not None:
        np.save(out_path, rank)
        print(f"wrote {out_path} in {time.time()-t0:.0f}s")
    return rank


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("what", nargs="?", choices=["stbn"],
                    help="stbn: the spatio-temporal volume (default: the "
                    "2-D rank texture)")
    ap.add_argument("--out", default=None, help="output .npy (default: the "
                    "package's asset)")
    args = ap.parse_args(argv)
    if args.what == "stbn":
        gen_stbn(out_path=args.out or _ASSETS / "stbn128x64.npy")
    else:
        main(out_path=args.out or _ASSETS / "bluenoise128.npy")
    return 0


if __name__ == "__main__":
    sys.exit(cli())
