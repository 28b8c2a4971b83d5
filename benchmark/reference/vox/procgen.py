"""Procedural stand-in scenes.

The reference's canonical assets (``assets/castle.vox``, 88 MB, and
``assets/teapot.vox``) are git-LFS pointer stubs in the snapshot
(SURVEY §6), so benchmarks and demos use deterministic procedural
replacements of comparable scale: a walled castle with towers and a keep
on a terrain slab, and a superellipsoid teapot. Both are emitted as real
``.vox`` bytes so every run exercises the full parser → tree → geometry
path.

The port's copy of :mod:`dust_tpu.vox.procgen`.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.vox import parser as vp

__all__ = ["make_castle_vox", "make_teapot_vox"]

# Palette indices (1-based voxel color indices).
GRASS_A, GRASS_B, STONE_A, STONE_B, STONE_C, ROOF, WOOD, WATER, GOLD = range(1, 10)

_PALETTE_RGB = {
    GRASS_A: (86, 125, 70, 255),
    GRASS_B: (74, 111, 58, 255),
    STONE_A: (158, 158, 158, 255),
    STONE_B: (140, 140, 145, 255),
    STONE_C: (120, 120, 128, 255),
    ROOF: (178, 52, 44, 255),
    WOOD: (110, 78, 48, 255),
    WATER: (52, 88, 148, 255),
    GOLD: (212, 175, 55, 255),
}


def _palette() -> np.ndarray:
    p = vp.DEFAULT_PALETTE.copy()
    for i, rgba in _PALETTE_RGB.items():
        p[i] = rgba
    return p


def _grid_to_voxels(grid: np.ndarray) -> np.ndarray:
    """Dense (X,Y,Z) uint8 color grid -> (N,4) XYZI voxel array."""
    x, y, z = np.nonzero(grid)
    return np.stack([x, y, z, grid[x, y, z]], axis=1).astype(np.uint8)


def make_castle_vox(size: int = 256) -> np.ndarray:
    """Dense color grid of the castle, vox orientation (z = up).

    Round 4 scaled the scene up toward the reference's 88 MB
    ``castle.vox`` (unfetchable LFS stub): rolling solid terrain, a keep
    with four interior floors, an inner ward wall, a bailey of houses,
    trees and outcrops outside the moat — ~38k occupied leaves / ~37 mask
    chunks vs round-3's 14.6k / 15 (VERDICT r3 item 7: the kernel must be
    stressed like a production scene, not flattered by a thin shell)."""
    g = np.zeros((size, size, size), dtype=np.uint8)
    x, y = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")

    # Rolling SOLID terrain (real scenes are volumetric, not a 4-voxel
    # shell): height 4..26, gentle trig hills, flattened inside the
    # walls so the buildings sit level.
    cx = cy = size // 2
    d = np.maximum(np.abs(x - cx), np.abs(y - cy))
    hills = (22.0 + 13.0 * np.sin(x * (np.pi / 37.0)) * np.cos(y * (np.pi / 29.0))
             + 9.0 * np.sin((x + y) * (np.pi / 53.0))
             + 3.0 * np.sin(x * (np.pi / 5.0)) * np.cos(y * (np.pi / 7.0)))
    h = np.clip(4.0 + np.maximum(hills, 0.0), 4.0, 46.0)
    flat_in = np.clip((d - 96.0) / 16.0, 0.0, 1.0)  # 1 outside, 0 inside
    h = np.round(4.0 + (h - 4.0) * flat_in).astype(np.int64)
    # Raised garden terrace in the bailey (three leaf layers of ground).
    h = np.where((d >= 64) & (d < 90), np.maximum(h, 12), h)
    checker = ((x >> 3) + (y >> 3)) & 1
    ground = np.where(checker == 0, GRASS_A, GRASS_B).astype(np.uint8)
    zs = np.arange(size)[None, None, :]
    terra = zs < h[:, :, None]
    g[terra] = np.broadcast_to(ground[:, :, None], g.shape)[terra]

    # Moat carved into the terrain, water at the old level.
    moat = (d >= 104) & (d < 112)
    g[:, :, 2:][moat] = 0
    g[:, :, 3][moat] = WATER
    g[:, :, 2][moat] = WATER

    stone = np.where((x + y) & 1 == 0, STONE_A, STONE_B).astype(np.uint8)
    stone2 = np.where((x ^ y) & 2 == 0, STONE_B, STONE_C).astype(np.uint8)

    def wall_ring(lo, hi, thickness, z0, z1, mat):
        ring = ((d >= lo) & (d < lo + thickness)) & (np.maximum(np.abs(x - cx), np.abs(y - cy)) < hi)
        for z in range(z0, z1):
            g[:, :, z][ring] = mat[ring]

    # Outer curtain wall: thick ring with an internal gallery corridor
    # (hollow passage — the surface-rich structure real walls have),
    # height 4..40, crenellated top.
    wall = (d >= 91) & (d < 100)
    for z in range(4, 40):
        g[:, :, z][wall] = stone[wall]
    gallery = (d >= 94) & (d < 97)
    for z in range(10, 22):
        g[:, :, z][gallery] = 0
    for z in range(26, 34):
        g[:, :, z][gallery] = 0
    merlon = wall & (((x + y) >> 2) & 1 == 0)
    for z in range(40, 46):
        g[:, :, z][merlon] = stone[merlon]

    # Gate: carve an opening in the south wall.
    gate = (np.abs(x - cx) < 8) & (y < cy) & wall
    for z in range(4, 24):
        g[:, :, z][gate] = 0
    # Wooden gate posts.
    posts = (np.abs(np.abs(x - cx) - 8) < 2) & (y < cy) & wall
    for z in range(4, 26):
        g[:, :, z][posts] = WOOD

    # Corner towers: cylinders at the four wall corners.
    r2 = lambda px, py: (x - px) ** 2 + (y - py) ** 2
    for tx in (cx - 96, cx + 96):
        for ty in (cy - 96, cy + 96):
            body = r2(tx, ty) < 14 * 14
            for z in range(4, 64):
                g[:, :, z][body] = stone2[body]
            cap = r2(tx, ty) < 16 * 16
            for z in range(64, 68):
                g[:, :, z][cap] = stone[cap]
            # conical roof
            for z in range(68, 92):
                rr = max(1, 16 - (z - 66))
                cone = r2(tx, ty) < rr * rr
                g[:, :, z][cone] = ROOF
            spire = r2(tx, ty) < 2
            for z in range(92, 96):
                g[:, :, z][spire] = GOLD

    # Central keep: box with corner turrets and a roof.
    keep = (np.abs(x - cx) < 30) & (np.abs(y - cy) < 30)
    shell = keep & ~((np.abs(x - cx) < 24) & (np.abs(y - cy) < 24))
    for z in range(4, 80):
        g[:, :, z][shell] = stone[shell]
    for z in range(4, 10):  # solid base
        g[:, :, z][keep] = stone[keep]
    kmerlon = keep & ~((np.abs(x - cx) < 26) & (np.abs(y - cy) < 26)) & ((x ^ y) & 4 == 0)
    for z in range(80, 86):
        g[:, :, z][kmerlon] = stone[kmerlon]
    # Keep roof pyramid.
    for z in range(80, 108):
        half = max(1, 24 - (z - 80))
        roof = (np.abs(x - cx) < half) & (np.abs(y - cy) < half)
        g[:, :, z][roof] = ROOF

    # Windows in the keep (carve).
    win = shell & (((x - cx + 60) % 12 < 2) | ((y - cy + 60) % 12 < 2))
    for z in range(30, 36):
        g[:, :, z][win] = 0
    for z in range(54, 60):
        g[:, :, z][win] = 0

    # ---- round-4 density additions (VERDICT r3 item 7) -----------------

    # Keep interior: four wooden floors with a stair hole, plus interior
    # partition walls making rooms on each storey.
    interior = (np.abs(x - cx) < 24) & (np.abs(y - cy) < 24)
    stair = (np.abs(x - cx - 14) < 5) & (np.abs(y - cy - 14) < 5)
    part = interior & (
        ((np.abs(x - cx) < 1) & (np.abs(y - cy) > 6))
        | ((np.abs(y - cy) < 1) & (np.abs(x - cx) > 6)))
    for z0 in (22, 40, 58):
        for z in (z0, z0 + 1):
            g[:, :, z][interior & ~stair] = WOOD
        for z in range(z0 + 2, z0 + 14):
            if z < 78:
                g[:, :, z][part] = stone2[part]
        # Doorways through the partitions.
        door = part & ((np.abs(x - cx - 12) < 3) | (np.abs(y - cy + 12) < 3))
        for z in range(z0 + 2, min(z0 + 9, 78)):
            g[:, :, z][door] = 0

    # Inner ward wall: a second crenellated ring with a walkway.
    inner = (d >= 57) & (d < 61)
    for z in range(4, 26):
        g[:, :, z][inner] = stone2[inner]
    imerlon = inner & (((x - y) >> 2) & 1 == 0)
    for z in range(26, 30):
        g[:, :, z][imerlon] = stone2[imerlon]
    igate = (np.abs(x - cx) < 6) & (y < cy) & inner
    for z in range(4, 18):
        g[:, :, z][igate] = 0

    # Bailey houses between the inner ward and the curtain wall: hollow
    # stone shells with pitched roofs and door/window carves, at eight
    # compass positions.
    for k, (hx_, hy_) in enumerate(
            [(-78, -30), (-78, 30), (78, -30), (78, 30),
             (-30, -78), (30, -78), (-30, 78), (30, 78),
             (-44, 0), (44, 0), (0, -44), (0, 44)]):  # inner-ward stores
        px, py = cx + hx_, cy + hy_
        hw, hd, hh = 11, 8, 14  # half-width, half-depth, wall top
        box = (np.abs(x - px) < hw) & (np.abs(y - py) < hd)
        shell_h = box & ~((np.abs(x - px) < hw - 2) & (np.abs(y - py) < hd - 2))
        for z in range(4, 4 + hh):
            g[:, :, z][shell_h] = stone[shell_h]
        for z in range(4, 6):  # wooden floor
            g[:, :, z][box] = WOOD
        door_h = shell_h & (np.abs(x - px) < 3) & (y < py)
        for z in range(4, 12):
            g[:, :, z][door_h] = 0
        # Pitched roof along x.
        for z in range(4 + hh, 4 + hh + hd + 2):
            half = hd + 2 - (z - 4 - hh)
            if half <= 0:
                break
            roof_m = (np.abs(x - px) < hw + 1) & (np.abs(y - py) < half)
            g[:, :, z][roof_m] = ROOF

    # Trees + rock outcrops on the hills outside the moat (two staggered
    # rings — a small forest) and an orchard row on the bailey terrace:
    # deterministic trig placement, trunks + blocky canopies.
    r2g = lambda px, py: (x - px) ** 2 + (y - py) ** 2
    spots = []
    for k in range(24):
        ang = k * (2.0 * np.pi / 24.0) + 0.4
        spots.append((117 + 8 * ((k * 7) % 3), ang, k % 5 == 4))
    for k in range(20):
        ang = k * (2.0 * np.pi / 20.0) + 0.13
        spots.append((108 + 14 * ((k * 5) % 3), ang, k % 6 == 5))
    for k in range(10):
        ang = k * (2.0 * np.pi / 10.0) + 0.9
        spots.append((74, ang, False))  # orchard on the terrace
    for rad, ang, is_rock in spots:
        px = int(cx + rad * np.cos(ang))
        py = int(cy + rad * np.sin(ang))
        if not (7 <= px < size - 7 and 7 <= py < size - 7):
            continue
        if 90 <= max(abs(px - cx), abs(py - cy)) <= 113:
            continue  # keep the wall and moat clear
        zb = int(h[px, py])
        if is_rock:
            rock = r2g(px, py) < 5 * 5
            for z in range(zb, min(zb + 4, size)):
                g[:, :, z][rock] = stone2[rock]
            continue
        trunk = r2g(px, py) < 2 * 2
        for z in range(zb, min(zb + 10, size)):
            g[:, :, z][trunk] = WOOD
        for z in range(zb + 8, min(zb + 19, size)):
            rr = 7 - abs(z - (zb + 13))
            if rr <= 0:
                continue
            can = r2g(px, py) < rr * rr
            g[:, :, z][can] = np.where(((x + y + z) & 1) == 0, GRASS_A,
                                       GRASS_B).astype(np.uint8)[can]

    # A hamlet on the hills outside the moat: six cottages.
    for k in range(6):
        ang = k * (2.0 * np.pi / 6.0) + 0.22
        px = int(cx + 121 * np.cos(ang))
        py = int(cy + 121 * np.sin(ang))
        if not (12 <= px < size - 12 and 12 <= py < size - 12):
            continue
        if max(abs(px - cx), abs(py - cy)) <= 113:
            continue
        zb = int(h[px, py])
        hw, hd, hh = 8, 6, 10
        box = (np.abs(x - px) < hw) & (np.abs(y - py) < hd)
        shell_c = box & ~((np.abs(x - px) < hw - 2) & (np.abs(y - py) < hd - 2))
        for z in range(zb, min(zb + hh, size)):
            g[:, :, z][shell_c] = stone2[shell_c]
        for z in range(zb + hh, min(zb + hh + hd + 2, size)):
            half = hd + 2 - (z - zb - hh)
            if half <= 0:
                break
            roof_m = (np.abs(x - px) < hw + 1) & (np.abs(y - py) < half)
            g[:, :, z][roof_m] = ROOF

    # Cobble causeway from the gate across the moat to the inner ward.
    path = (np.abs(x - cx) < 5) & (y < cy - 56) & (y > 8)
    for z in range(4, 6):
        g[:, :, z][path] = stone[path]
    return g


def make_teapot_vox(size: int = 64) -> np.ndarray:
    """Dense color grid of a stylised teapot, vox orientation (z = up)."""
    g = np.zeros((size, size, size), dtype=np.uint8)
    s = size
    xs = (np.arange(s) + 0.5) / s * 2 - 1  # [-1, 1)
    x, y, z = np.meshgrid(xs, xs, xs, indexing="ij")
    zc = z + 0.25  # body center below mid-height

    # Body: squashed superellipsoid.
    body = ((x / 0.62) ** 2 + (y / 0.62) ** 2) ** 1.2 + (zc / 0.48) ** 2 < 1.0
    # Hollow it slightly (open top).
    inner = ((x / 0.5) ** 2 + (y / 0.5) ** 2) ** 1.2 + ((zc - 0.12) / 0.4) ** 2 < 1.0
    body &= ~(inner & (zc > 0.25))
    # Lid + knob.
    lid = (x**2 + y**2 < 0.35**2) & (np.abs(zc - 0.45) < 0.06)
    knob = (x**2 + y**2 + (zc - 0.58) ** 2) < 0.09**2
    # Spout: bent cone along +x.
    sx = x - 0.45
    spout_axis = zc - 0.1 - 0.8 * np.maximum(sx, 0)
    spout = (sx > 0) & (sx < 0.5) & ((y**2 + spout_axis**2) < (0.11 - 0.12 * sx) ** 2)
    # Handle: torus segment in the xz plane at -x.
    hx = x + 0.62
    ring = (np.sqrt(hx**2 + zc**2) - 0.28) ** 2 + y**2 < 0.055**2
    handle = ring & (hx > -0.1)

    g[body] = STONE_A  # porcelain white-ish -> reuse stone
    g[spout | handle] = GOLD
    g[lid] = ROOF
    g[knob] = GOLD
    return g


# ---------------------------------------------------------------------------
# Scene composition helpers (the canonical + stress workloads)
# ---------------------------------------------------------------------------


