"""Tone mapping: albedo modulation, exposure, ACES fit, output OETFs
(port of :mod:`dust_tpu.ops.tonemap`)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.utils import color as colorlib

__all__ = ["aces_fitted", "oetf", "tonemap", "TRANSFER_FUNCTIONS"]

# sRGB => XYZ => D65_2_D60 => AP1 => RRT_SAT, and the ODT back (row-major,
# applied as matrix @ color).
_RGB_TO_RRT = np.array([[0.59719, 0.35458, 0.04823],
                        [0.07600, 0.90834, 0.01566],
                        [0.02840, 0.13383, 0.83777]], dtype=np.float32)
_ODT_TO_RGB = np.array([[1.60475, -0.53108, -0.07367],
                        [-0.10208, 1.10813, -0.00605],
                        [-0.00327, -0.07276, 1.07602]], dtype=np.float32)

TRANSFER_FUNCTIONS = ("linear", "srgb", "scrgb", "dci_p3", "display_p3",
                      "itu", "pq", "hlg", "adobe_rgb")


def _rrt_and_odt_fit(v):
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def aces_fitted(color: torch.Tensor) -> torch.Tensor:
    c = _rrt_and_odt_fit(colorlib.apply_mat3(color, _RGB_TO_RRT))
    return colorlib.apply_mat3(c, _ODT_TO_RGB)


def _pow(c, e):
    return torch.clamp(c, min=1e-12) ** e


def oetf(c: torch.Tensor, transfer: str = "srgb") -> torch.Tensor:
    """Swapchain output transfer functions."""
    if transfer == "linear":
        return c
    if transfer == "srgb":
        return torch.where(c <= 0.0031308, 12.92 * c,
                           1.055 * _pow(c, 1.0 / 2.4) - 0.055)
    if transfer == "scrgb":
        neg = -1.055 * _pow(-c, 1.0 / 2.4) + 0.055
        return torch.where(c <= -0.0031308, neg,
                           oetf(torch.clamp(c, min=0.0), "srgb"))
    if transfer == "dci_p3":
        return torch.clamp(c / 52.37, min=0.0) ** (1.0 / 2.6)
    if transfer == "display_p3":
        return torch.where(c < 0.0030186, 12.92 * c,
                           1.055 * _pow(c, 1.0 / 2.4) - 0.055)
    if transfer == "itu":
        alpha, beta = 1.0993, 0.0181
        return torch.where(c < beta, 4.5 * c,
                           alpha * _pow(c, 0.45) - (alpha - 1.0))
    if transfer == "pq":
        m1 = 2610.0 / 16384.0
        m2 = (2523.0 / 4096.0) * 128.0
        c2 = (2413.0 / 4096.0) * 32.0
        c3 = (2392.0 / 4096.0) * 32.0
        c1 = c3 - c2 + 1.0
        lm = torch.clamp(c, min=0.0) ** m1
        return ((c1 + c2 * lm) / (1.0 + c3 * lm)) ** m2
    if transfer == "hlg":
        a, b, cc = 0.17883277, 1.0 - 4.0 * 0.17883277, 0.55991073
        return torch.where(c < 1.0 / 12.0,
                           torch.sqrt(torch.clamp(3.0 * c, min=0.0)),
                           a * torch.log(torch.clamp(12.0 * c - b, min=1e-12))
                           + cc)
    if transfer == "adobe_rgb":
        return torch.clamp(c, min=0.0) ** (256.0 / 563.0)
    raise ValueError(f"unknown transfer function {transfer!r}")


def tonemap(radiance: torch.Tensor, albedo_srgb: torch.Tensor, exposure,
            transfer: str = "srgb", color_matrix=None) -> torch.Tensor:
    """Radiance (linear ACEScg) × linearised albedo, exposure, an optional
    3×3 ``color_matrix`` (applied as ``mapped @ color_matrix.T``), ACES
    fit, output transfer, clamped to [0, 1]."""
    albedo_lin = colorlib.srgb_eotf(albedo_srgb)
    srgb = colorlib.acescg_to_srgb(radiance) * albedo_lin
    mapped = colorlib.srgb_to_acescg(srgb) * exposure
    if color_matrix is not None:
        mapped = colorlib.apply_mat3(mapped,
                                     np.asarray(color_matrix, np.float32))
    mapped = aces_fitted(mapped)
    return torch.clamp(oetf(mapped, transfer), 0.0, 1.0)
