"""Real-time GI denoiser: temporal accumulation + à-trous (port of
:mod:`dust_tpu.ops.denoise`, the half-resolution path of the frame).

The history is kept exactly as the reference keeps it, one (H, W, 3)
array of 32-bit words per pixel (here int32 tensors holding the bits),
because its quantisation changes the numbers:

    w0: RGB9E5 accumulated colour (shared exponent)
    w1: fast-history luminance f16 (bits 16:32) | history length x4 u8
        (bits 8:16) | hit distance log-u8 (bits 0:8)
    w2: view depth f16 (bits 16:32; -1 = no surface) | oct normal u8 x2
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dust_tpu_torch.config import DenoiserSettings
from dust_tpu_torch.ops import packing as pk
from dust_tpu_torch.ops.fp import as_i32, as_u32, bits_f16, f16_bits

__all__ = ["DenoiserState", "make_denoiser_state", "denoise",
           "downsample_inputs", "upsample_bilateral"]

_C = 3
_HD_MAX = 60000.0


def _exp2i(e):
    """2**e for integer e in [-126, 127], built from float32 bits."""
    return ((e + 127) << 23).int().view(torch.float32)


def _pack_rgb9e5(c):
    c = torch.clamp(c, 0.0, 65000.0)
    maxc = torch.clamp(c.amax(dim=-1), min=1e-8)
    bits = maxc.view(torch.int32).long()
    e = torch.clamp((bits >> 23) - 126, -15, 16)
    m = torch.clamp(torch.round(c * _exp2i(9 - e)[..., None]).long(), 0, 511)
    return ((e + 15) << 27) | (m[..., 0] << 18) | (m[..., 1] << 9) | m[..., 2]


def _unpack_rgb9e5(w):
    w = as_u32(w)
    e = ((w >> 27) & 31) - 15
    scale = _exp2i(e - 9)
    m = torch.stack([(w >> 18) & 511, (w >> 9) & 511, w & 511], dim=-1)
    return m.float() * scale[..., None]


def _pack_history(color, fast, hd, length, depth, normal):
    w0 = _pack_rgb9e5(color)
    len_q = torch.clamp(torch.round(length * 4.0), 0, 255).long()
    hd_q = torch.clamp(torch.round(
        torch.log2(1.0 + torch.clamp(hd, 0.0, _HD_MAX)) * 16.0), 0, 255).long()
    w1 = (f16_bits(fast) << 16) | (len_q << 8) | hd_q
    oct_ = torch.clamp(torch.round(pk.encode_oct_normal(normal) * 255.0),
                       0, 255).long()
    w2 = (f16_bits(depth) << 16) | (oct_[..., 0] << 8) | oct_[..., 1]
    return as_i32(torch.stack([w0, w1, w2], dim=-1))


def _unpack_history(h):
    w0, w1, w2 = as_u32(h[..., 0]), as_u32(h[..., 1]), as_u32(h[..., 2])
    return dict(
        color=_unpack_rgb9e5(w0),
        fast=bits_f16(w1 >> 16),
        length=((w1 >> 8) & 0xFF).float() * 0.25,
        hd=torch.exp2((w1 & 0xFF).float() * (1.0 / 16.0)) - 1.0,
        depth=bits_f16(w2 >> 16),
        oct=torch.stack([(w2 >> 8) & 0xFF, w2 & 0xFF],
                        dim=-1).float() * (1.0 / 255.0),
    )


class DenoiserState(NamedTuple):
    history: torch.Tensor  # (H, W, 3) int32 (u32 bits, layout above)


def make_denoiser_state(height: int, width: int, device) -> DenoiserState:
    h = torch.zeros((height, width, _C), dtype=torch.int32, device=device)
    h[..., 2] = as_i32(torch.tensor(0xBC00 << 16))  # depth f16(-1)
    return DenoiserState(history=h)


def _project(view_proj, pos, width: int, height: int):
    """World -> pixel coords under the (reverse-Z) view-proj. The clip
    coordinates round as the reference's ``einsum`` over [x, y, z, 1]
    rounds them, summing its four products in pairs: a pixel centre at
    the image edge reprojects onto the in-bounds limit, so the last bit
    decides whether it keeps its history."""
    x, y, z = pos.unbind(-1)
    clip = [(x * view_proj[k, 0] + y * view_proj[k, 1])
            + (z * view_proj[k, 2] + view_proj[k, 3]) for k in range(4)]
    w = clip[3]
    wd = torch.where(w.abs() < 1e-12, 1e-12, w)
    x = (clip[0] / wd * 0.5 + 0.5) * width
    y = (0.5 - clip[1] / wd * 0.5) * height
    return torch.stack([x, y], dim=-1), w


def _fetch_history(history, xy):
    """The four packed bilinear corner rows around ``xy`` and the (fx, fy)
    fractions (edge-clamped)."""
    h, w = history.shape[:2]
    right = torch.cat([history[:, 1:], history[:, -1:]], dim=1)
    down = torch.cat([history[1:], history[-1:]], dim=0)
    downright = torch.cat([down[:, 1:], down[:, -1:]], dim=1)
    x = torch.clamp(xy[..., 0] - 0.5, 0.0, w - 1.0)
    y = torch.clamp(xy[..., 1] - 0.5, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).long(), max=w - 2)
    y0 = torch.clamp(torch.floor(y).long(), max=h - 2)
    fx = x - x0
    fy = y - y0
    flat = y0 * w + x0
    corners = tuple(t.reshape(h * w, _C)[flat]
                    for t in (history, right, down, downright))
    return corners, fx, fy


def _local_moments(img):
    """3×3 neighbourhood mean and std (edge-replicated box sums)."""
    def box3(a, axis):
        n = a.shape[axis]
        lo = torch.cat([a.narrow(axis, 0, 1), a.narrow(axis, 0, n - 1)], axis)
        hi = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                       axis)
        return lo + a + hi

    s1 = box3(box3(img, 0), 1) / 9.0
    s2 = box3(box3(img * img, 0), 1) / 9.0
    var = torch.clamp(s2 - s1 * s1, min=0.0)
    return s1, torch.sqrt(var)


def _luma(c):
    return c[..., 0] * 0.25 + c[..., 1] * 0.5 + c[..., 2] * 0.25


def _pool2(x):
    """2×2 sum pool, stride 2, over the two leading axes."""
    return x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]


def downsample_inputs(radiance, hitdist, depth, normal, world_pos, motion):
    """2× validity-weighted downsample of the denoiser inputs."""
    valid = torch.isfinite(depth)
    w = valid.float()
    ws = _pool2(w)
    inv = 1.0 / torch.clamp(ws, min=1.0)

    def mean(x):
        if x.dim() == 2:
            return _pool2(torch.where(valid, x, 0.0) * w) * inv
        xm = torch.where(valid[..., None], x, 0.0)
        return _pool2(xm * w[..., None]) * inv[..., None]

    rad = mean(radiance)
    hd = mean(hitdist)
    d = torch.where(ws > 0, mean(depth), float("inf"))
    nrm = mean(normal)
    nlen = pk.norm3(nrm, keepdim=True)
    nrm = torch.where(nlen > 0.3, nrm / torch.clamp(nlen, min=1e-6),
                      nrm.new_tensor([0.0, 0.0, 1.0]))
    return rad, hd, d, nrm, mean(world_pos), mean(motion)


_K_BILIN = (0.25, 0.75, 0.75, 0.25)
_K_NEAREST = (0.0, 1.0, 1.0, 0.0)


def _up2_axis(x, k, axis):
    """2× upsample along ``axis`` with the 4-tap kernel ``k``: output 2i
    reads {i-1: k0, i: k2}, output 2i+1 reads {i: k1, i+1: k3}; taps
    outside the image read zero."""
    n = x.shape[axis]
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    prev = torch.cat([zero, x.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), zero], axis)
    even = prev * k[0] + x * k[2]
    odd = x * k[1] + nxt * k[3]
    out = torch.stack([even, odd], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return out.reshape(shape)


def _up2(x, k):
    return _up2_axis(_up2_axis(x, k, 0), k, 1)


def upsample_bilateral(img_half, hd_half, depth_half, normal_half,
                       depth_full, normal_full):
    """Joint-bilateral 2× upsample of the half-res denoised indirect:
    bilinear where the interpolated geometry matches the full-res
    G-buffer, the nearest half texel at geometric edges."""
    H, W = depth_full.shape
    d_h = torch.clamp(depth_half, max=1e9)[..., None]
    depth_full = torch.clamp(depth_full, max=1e9)
    pack = torch.cat([img_half, hd_half[..., None], d_h, normal_half,
                      torch.ones_like(d_h)], dim=-1)  # (h2, w2, 9)
    up_b = _up2(pack, _K_BILIN)[:H, :W]
    up_n = _up2(pack[..., :4], _K_NEAREST)[:H, :W]
    up_b = up_b / torch.clamp(up_b[..., 8:9], min=1e-6)
    ok = (((up_b[..., 4] - depth_full).abs()
           < 0.1 * torch.clamp(depth_full, min=1.0))
          & ((up_b[..., 5:8] * normal_full).sum(dim=-1) > 0.85))
    out = torch.where(ok[..., None], up_b[..., 0:3], up_n[..., 0:3])
    hd = torch.where(ok, up_b[..., 3], up_n[..., 3])
    return out, hd


def _shift(a, sy: int, sx: int, lo: int = 0, hi: int | None = None):
    """Edge-clamped 2D shift of the rows [lo, hi) (default: all):
    out[y, x] = a[clamp(y - sy), clamp(x - sx)]."""
    h, w = a.shape[:2]
    hi = h if hi is None else hi
    ys = torch.clamp(torch.arange(lo, hi, device=a.device) - sy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=a.device) - sx, 0, w - 1)
    return a[ys][:, xs]


def _powi(x, n: int):
    """x**n for a positive integer n by repeated squaring."""
    result = None
    bit = x
    while n:
        if n & 1:
            result = bit if result is None else result * bit
        n >>= 1
        if n:
            bit = bit * bit
    return result


def denoise(state: DenoiserState, radiance, hitdist, depth, normal,
            world_pos, motion, prev_view_proj, settings: DenoiserSettings,
            rows=None):
    """One denoiser step. Returns (denoised_rgb, hitdist, new_state).

    ``rows``: the sharded frame's ``(lo, hi, gather)``: the step computes
    the image rows [lo, hi) alone. ``state`` then holds those rows of the
    history, ``radiance`` the rows [max(lo - 1, 0), min(hi + 1, H)) (the
    3×3 moments read one row around), every other input the rows [lo,
    hi), and ``gather(x)`` returns the whole image from every rank's rows
    ``x``; so do the results. The history fetch reads any row under
    camera motion and the à-trous step 2^k rows 2^k away: each reads a
    gathered image."""
    if rows is None:
        lo, hi, gather = 0, depth.shape[0], None
        history = state.history
    else:
        lo, hi, gather = rows
        history = gather(state.history)
    height, width = history.shape[0], depth.shape[1]
    valid_px = torch.isfinite(depth)

    # ---- temporal reprojection -----------------------------------------
    prev_xy, prev_w = _project(prev_view_proj, world_pos + motion, width,
                               height)
    in_bounds = ((prev_xy[..., 0] >= 0.5) & (prev_xy[..., 0] <= width - 0.5)
                 & (prev_xy[..., 1] >= 0.5) & (prev_xy[..., 1] <= height - 0.5)
                 & (prev_w > 0))
    corners, fx, fy = _fetch_history(history, prev_xy)
    wb = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)

    wsum = torch.zeros_like(fx)
    hist = torch.zeros(fx.shape + (6,), device=fx.device)
    for c, w0 in zip(corners, wb):
        u = _unpack_history(c)
        c_nrm = pk.decode_oct_normal(u["oct"])
        ok = ((u["depth"] > 0.0)
              & ((u["depth"] - prev_w).abs()
                 < 0.1 * torch.clamp(prev_w, min=1.0))
              & ((c_nrm * normal).sum(dim=-1) > 0.8))
        w = w0 * ok.float()
        vals = torch.cat([u["color"], u["fast"][..., None], u["hd"][..., None],
                          u["length"][..., None]], dim=-1)
        hist = hist + vals * w[..., None]
        wsum = wsum + w

    valid_hist = in_bounds & valid_px & (wsum > 1e-3)
    inv_w = 1.0 / torch.clamp(wsum, min=1e-3)
    hist_color = hist[..., 0:3] * inv_w[..., None]
    hist_fast = hist[..., 3] * inv_w
    hist_hd = hist[..., 4] * inv_w
    hist_len = hist[..., 5] * inv_w

    # ---- history clamping ------------------------------------------------
    mu, sigma = _local_moments(radiance)
    own = slice(lo - max(lo - 1, 0), hi - max(lo - 1, 0))
    mu, sigma, radiance = mu[own], sigma[own], radiance[own]
    gamma = settings.clamp_sigma
    clamped = torch.clamp(hist_color, mu - gamma * sigma, mu + gamma * sigma)
    hist_color = torch.where(valid_hist[..., None], clamped, hist_color)
    n0 = torch.where(valid_hist, torch.clamp(
        hist_len, max=float(settings.max_accumulated_frames - 1)), 0.0)

    # ---- anti-lag via the fast history -----------------------------------
    luma_cur = _luma(radiance)
    nf = torch.where(valid_hist, torch.clamp(
        hist_len, max=float(settings.fast_max_accumulated_frames - 1)), 0.0)
    fast = hist_fast + (luma_cur - hist_fast) / (nf + 1.0)
    slow_luma = _luma(hist_color)
    sig_l = _luma(sigma)
    deviation = (fast - slow_luma).abs() / (
        sig_l * settings.antilag_sigma
        + torch.clamp(torch.maximum(fast, slow_luma), min=1e-3)
        * settings.antilag_relative
        + 1e-6)
    antilag = torch.square(torch.clamp(1.0 - deviation, 0.05, 1.0))
    n = n0 * antilag

    alpha = 1.0 / (n + 1.0)
    acc_color = hist_color + (radiance - hist_color) * alpha[..., None]
    acc_color = torch.where(valid_px[..., None], acc_color, radiance)
    acc_hd = torch.where(valid_px, hist_hd + (hitdist - hist_hd) * alpha,
                         hitdist)
    new_len = torch.where(valid_px, n + 1.0, 0.0)

    # ---- spatial à-trous -------------------------------------------------
    hd_norm = torch.clamp(acc_hd / (acc_hd + 4.0), 0.05, 1.0) \
        * settings.hitdist_blur_scale
    conv = torch.sqrt(1.0 / torch.clamp(new_len, min=1.0))
    filtered = acc_color
    inv_d2 = 1.0 / (settings.depth_sigma * settings.depth_sigma)
    kernel = [(dy, dx, 0.125 if (dx == 0 or dy == 0) else 0.0625)
              for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dx, dy) != (0, 0)]
    n_sigma = settings.normal_sigma
    int_sigma = float(n_sigma).is_integer()
    depth_s = torch.where(valid_px, depth, 1e10)
    inv_hd = 1.0 / (hd_norm + 1e-3)
    valid_f = valid_px.float()
    for it in range(settings.atrous_iterations):
        step = 1 << it
        wsum_a = torch.full(depth.shape, 0.25, device=depth.device)
        csum = filtered * 0.25
        lum_f = _luma(filtered)
        inv_lum_sig = 1.0 / (settings.luminance_sigma * conv * hd_norm + 1e-3)
        guide = torch.cat([filtered, lum_f[..., None], depth_s[..., None],
                           normal, valid_f[..., None]], dim=-1)  # (H, W, 9)
        if gather is not None:
            guide = gather(guide)
        for dy, dx, kw in kernel:
            g_q = _shift(guide, -dy * step, -dx * step, lo, hi)
            c_q, l_q, d_q = g_q[..., 0:3], g_q[..., 3], g_q[..., 4]
            n_q, v_q = g_q[..., 5:8], g_q[..., 8]
            log_w = (-(depth_s - d_q).abs() / torch.clamp(depth_s, min=1.0)
                     * (inv_d2 * 8.0) * inv_hd
                     - (lum_f - l_q).abs() * inv_lum_sig)
            ndot = torch.clamp((normal * n_q).sum(dim=-1), min=0.0)
            w_n = _powi(ndot, int(n_sigma)) if int_sigma else ndot ** n_sigma
            wgt = kw * torch.exp(torch.clamp(log_w, min=-40.0)) * w_n * v_q
            csum = csum + c_q * wgt[..., None]
            wsum_a = wsum_a + wgt
        filtered = csum / wsum_a[..., None]

    out = torch.where(valid_px[..., None], filtered, radiance)
    new_hist = _pack_history(
        torch.where(valid_px[..., None], acc_color, 0.0),
        torch.where(valid_px, fast, 0.0),
        acc_hd,
        new_len,
        torch.where(valid_px, torch.clamp(depth, max=_HD_MAX), -1.0),
        torch.where(valid_px[..., None], normal,
                    normal.new_tensor([0.0, 0.0, 1.0])),
    )
    return out, acc_hd, DenoiserState(history=new_hist)
