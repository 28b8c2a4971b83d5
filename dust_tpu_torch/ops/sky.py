"""Hošek-Wilkie analytic sky + solar radiance.

Port of :mod:`dust_tpu.ops.sky`: the host-side bake is the same numpy
code over the port's copy of the same dataset
(``dust_tpu_torch/assets/hosek_sky.npz``); the per-direction evaluation
runs on tensors. As in the reference, the model past the ``arccos`` is
evaluated in bfloat16 (every op rounds to bf16), so the port and the
reference agree to bf16 precision there, not to the last float32 bit.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from dust_tpu_torch.config import SunlightSettings
from dust_tpu_torch.ops import packing as pk
from dust_tpu_torch.utils import color as colorlib

__all__ = ["SkyModelState", "bake_sky", "sky_radiance", "sun_radiance",
           "primary_sky"]

_DATASET = Path(__file__).resolve().parents[1] / "assets" / "hosek_sky.npz"


class SkyModelState(NamedTuple):
    configs: torch.Tensor          # (3, 9) per-channel 9-coef model
    radiances: torch.Tensor        # (3,) per-channel radiance scale
    ld_coefs: torch.Tensor         # (3, 6) limb-darkening coefficients
    direction: torch.Tensor        # (3,) unit, eye -> sun
    solar_intensity: torch.Tensor  # (3,) XYZ direct solar radiance
    solar_radius: torch.Tensor     # () angular radius (rad)


def _coefficient(elev_matrix: np.ndarray, x: float) -> np.ndarray:
    rx = 1.0 - x
    w = np.array([rx**5, 5 * rx**4 * x, 10 * rx**3 * x**2,
                  10 * rx**2 * x**3, 5 * rx * x**4, x**5])
    return np.tensordot(w, elev_matrix, axes=(0, 0))


def _cook(low, high, turbidity, albedo, x):
    it = int(turbidity)
    rem = turbidity - it
    res = (1.0 - albedo) * (1.0 - rem) * _coefficient(
        np.moveaxis(low[it - 1], -2, 0), x)
    res += albedo * (1.0 - rem) * _coefficient(
        np.moveaxis(high[it - 1], -2, 0), x)
    if it < 10:
        res += (1.0 - albedo) * rem * _coefficient(
            np.moveaxis(low[it], -2, 0), x)
        res += albedo * rem * _coefficient(np.moveaxis(high[it], -2, 0), x)
    return res


def _solar_radiance_internal(turbidity: int, elevation: float, data):
    pieces, order = 45, 4
    elevation = max(elevation, 0.0)
    pos = int((2.0 * elevation / np.pi) ** (1.0 / 3.0) * pieces)
    pos = min(pos, pieces - 1)
    break_x = (pos / pieces) ** 3 * (np.pi / 2.0)
    x = elevation - break_x
    coefs = data["solar_dataset"][order * pieces * turbidity + order * pos:][:order]
    res = np.zeros(3)
    x_exp = 1.0
    for coef in coefs[::-1]:
        res += coef * x_exp
        x_exp *= x
    return res


def bake_sky(s: SunlightSettings, device) -> SkyModelState:
    """Host-side bake: sunlight settings -> the per-frame sky uniform."""
    with np.load(_DATASET) as f:
        data = dict(f)
    direction = np.asarray(s.direction, np.float64)
    direction = direction / np.linalg.norm(direction)
    albedo = np.asarray(s.albedo, np.float64)
    elevation = float(np.arcsin(np.clip(direction[1], -1.0, 1.0)))
    x = (max(elevation, 0.0) / (np.pi / 2.0)) ** (1.0 / 3.0)
    cfg = _cook(data["config_low_albedo"], data["config_high_albedo"],
                s.turbidity, albedo, x)
    rad = _cook(data["rad_low_albedo"], data["rad_high_albedo"],
                s.turbidity, albedo, x)
    turb_low = int(s.turbidity) - 1
    turb_frac = s.turbidity - (turb_low + 1)
    if turb_low == 9:
        turb_low, turb_frac = 8, 1.0
    solar = (1.0 - turb_frac) * _solar_radiance_internal(
        turb_low, elevation, data) + turb_frac * _solar_radiance_internal(
        turb_low + 1, elevation, data)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32, order="C"),
                               device=device)

    return SkyModelState(configs=t(cfg.T), radiances=t(rad),
                         ld_coefs=t(data["solar_ld"].T), direction=t(direction),
                         solar_intensity=t(solar),
                         solar_radius=t(s.solar_radius))


def _dot3(dirs, v):
    return dirs[..., 0] * v[0] + dirs[..., 1] * v[1] + dirs[..., 2] * v[2]


def sky_radiance(state: SkyModelState, dirs: torch.Tensor) -> torch.Tensor:
    """Per-direction ACEScg sky radiance; ``dirs`` (..., 3) normalised.
    Zero when the sun is below the horizon."""
    cos_theta = torch.clamp(dirs[..., 1], 0.0, 1.0)
    cos_gamma = torch.clamp(_dot3(dirs, state.direction), -1.0, 1.0)
    gamma = torch.arccos(cos_gamma)
    bf = torch.bfloat16
    ct = cos_theta.to(bf)
    cg = cos_gamma.to(bf)
    c = state.configs.to(bf)
    exp_m = torch.exp(c[:, 4] * gamma.to(bf)[..., None])
    ray_m = (cg * cg)[..., None]
    mie_d = 1.0 + c[:, 8] ** 2 - 2.0 * c[:, 8] * cg[..., None]
    mie = (1.0 + ray_m) / (mie_d * torch.sqrt(mie_d))
    zenith = torch.sqrt(ct)[..., None]
    xyz = ((1.0 + c[:, 0] * torch.exp(c[:, 1] / (ct[..., None] + 0.01)))
           * (c[:, 2] + c[:, 3] * exp_m + c[:, 5] * ray_m + c[:, 6] * mie
              + c[:, 7] * zenith)).float() * state.radiances
    out = colorlib.xyz_to_acescg(xyz * 683.0)
    return torch.where(state.direction[1] > 0, out, 0.0)


def sun_radiance(state: SkyModelState, dirs: torch.Tensor) -> torch.Tensor:
    """Solar disc with limb darkening (ACEScg); nonzero only in the disc."""
    cos_gamma = _dot3(dirs, state.direction)
    sol_rad_sin = torch.sin(state.solar_radius)
    ar2 = 1.0 / (sol_rad_sin * sol_rad_sin)
    singamma = 1.0 - cos_gamma * cos_gamma
    sc2 = 1.0 - ar2 * singamma * singamma
    sample_cosine = torch.sqrt(torch.clamp(sc2, min=0.0))
    ld = state.ld_coefs
    darkening = ld[:, 0] + ld[:, 1] * sample_cosine[..., None]
    cur = sample_cosine
    for i in range(4):
        cur = cur * sample_cosine
        darkening = darkening + ld[:, 2 + i] * cur[..., None]
    out = colorlib.xyz_to_acescg(state.solar_intensity * darkening)
    visible = (cos_gamma >= 0.0) & (dirs[..., 1] >= 0.0) & (sc2 > 0.0)
    return torch.where(visible[..., None], out, 0.0)


def primary_sky(state: SkyModelState, dirs: torch.Tensor) -> torch.Tensor:
    """What a primary ray that misses writes to the output: the sky and sun
    radiance of its normalised direction over 3.14; ``dirs`` (N, 3)."""
    dirs_n = dirs / pk.norm3(dirs, keepdim=True)
    return (sky_radiance(state, dirs_n) + sun_radiance(state, dirs_n)) / 3.14
