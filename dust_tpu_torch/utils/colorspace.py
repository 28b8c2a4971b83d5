"""Color spaces: primaries, white points, and conversion matrices.

Reference: ``crates/rhyolite/src/utils/format.rs`` (707 LoC, unit-tested
at :702) — ``ColorSpace`` = primaries + transfer function, with the
primaries→XYZ matrix derivation used to build the tone mapper's
color-space conversion specialization constants. Same math here, tested
against the canonical sRGB/Display-P3/BT.2020 matrices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Primaries", "ColorSpace", "SRGB", "DISPLAY_P3", "BT2020",
           "DCI_P3", "ACES_AP1", "conversion_matrix"]


@dataclasses.dataclass(frozen=True)
class Primaries:
    """Chromaticity coordinates (CIE xy) of R, G, B and the white point."""

    red: tuple[float, float]
    green: tuple[float, float]
    blue: tuple[float, float]
    white: tuple[float, float]

    def to_xyz_matrix(self) -> np.ndarray:
        """RGB→XYZ for these primaries (format.rs primaries→matrix)."""
        def xyz(xy):
            x, y = xy
            return np.array([x / y, 1.0, (1.0 - x - y) / y])

        m = np.stack([xyz(self.red), xyz(self.green), xyz(self.blue)], axis=1)
        w = xyz(self.white)
        scale = np.linalg.solve(m, w)
        return m * scale

    def from_xyz_matrix(self) -> np.ndarray:
        return np.linalg.inv(self.to_xyz_matrix())


@dataclasses.dataclass(frozen=True)
class ColorSpace:
    """Primaries + transfer function name (see ops/tonemap.oetf)."""

    primaries: Primaries
    transfer: str = "srgb"


D65 = (0.3127, 0.3290)
D60_ACES = (0.32168, 0.33767)

SRGB = ColorSpace(Primaries((0.640, 0.330), (0.300, 0.600), (0.150, 0.060), D65), "srgb")
DISPLAY_P3 = ColorSpace(
    Primaries((0.680, 0.320), (0.265, 0.690), (0.150, 0.060), D65), "display_p3")
DCI_P3 = ColorSpace(
    Primaries((0.680, 0.320), (0.265, 0.690), (0.150, 0.060), (0.314, 0.351)),
    "dci_p3")
BT2020 = ColorSpace(
    Primaries((0.708, 0.292), (0.170, 0.797), (0.131, 0.046), D65), "itu")
# ACEScg (AP1 primaries, ~D60 white) — format.rs includes ACES_AP1.
ACES_AP1 = ColorSpace(
    Primaries((0.713, 0.293), (0.165, 0.830), (0.128, 0.044), D60_ACES),
    "linear")


def conversion_matrix(src: ColorSpace, dst: ColorSpace) -> np.ndarray:
    """Linear RGB src→dst via XYZ (no chromatic adaptation, matching the
    reference's direct matrix product). This is what feeds tone mapping's
    COLOR_SPACE_CONVERSION constants when rendering to a non-sRGB
    swapchain (tone_map.comp:14-24)."""
    return dst.primaries.from_xyz_matrix() @ src.primaries.to_xyz_matrix()
