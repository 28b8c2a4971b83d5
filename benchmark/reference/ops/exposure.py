"""Histogram auto-exposure (port of :mod:`dust_tpu.ops.exposure`). The
index-weighted histogram total is the sum of the per-pixel bins, so the
frame builds no histogram; :func:`luminance_histogram` is the diagnostic
API."""

from __future__ import annotations

import torch

from benchmark.reference.config import ExposureSettings
from benchmark.reference.utils import color as colorlib

__all__ = ["mean_bin", "adapt_average_luminance",
           "exposure_value"]


def _bins(radiance: torch.Tensor, settings: ExposureSettings) -> torch.Tensor:
    lum = colorlib.luminance_rec601(radiance)
    log_lum = torch.clamp(
        (torch.log2(torch.clamp(lum, min=1e-30)) - settings.min_log_luminance)
        / settings.log_luminance_range, 0.0, 1.0)
    return torch.where(lum < 0.005, 0, (log_lum * 254.0 + 1.0).int())


def mean_bin(radiance: torch.Tensor, settings: ExposureSettings):
    """``sum(histogram * bin_index)``: the float32 sum of per-pixel bins."""
    return _bins(radiance, settings).float().sum()


def adapt_average_luminance(histogram, previous_avg, num_pixels: int,
                            settings: ExposureSettings, weighted=None):
    """Index-weighted mean -> log-space luminance, then temporal
    adaptation toward it. Pass ``weighted`` (from :func:`mean_bin`) to
    skip the histogram; otherwise it is ``sum(histogram * bin_index)``
    in float32."""
    if weighted is None:
        idx = torch.arange(settings.num_bins, dtype=torch.float32,
                           device=histogram.device)
        weighted = (histogram.float() * idx).sum()
    weighted_log_avg = weighted / max(num_pixels, 1.0) - 1.0
    avg_lum = torch.exp2((weighted_log_avg / 254.0)
                         * settings.log_luminance_range
                         + settings.min_log_luminance)
    return previous_avg + (avg_lum - previous_avg) * settings.time_coefficient


def exposure_value(avg_luminance):
    exposure = 1.0 / (9.6 * torch.clamp(avg_luminance, min=1e-8))
    return exposure * 9.6
