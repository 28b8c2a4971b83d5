// The denoiser step for Hopper (sm_90a): temporal accumulation and the
// à-trous filter of ops/denoise.py, one thread per pixel.
//
// denoise_temporal_kernel does the whole of denoise_plain before the à-trous
// loop for the rows [lo, lo + rows) of a width-wide image: the reprojection
// under the previous view-projection (_project), the four bilinear history
// corners unpacked (_unpack_history, decode_oct_normal) with their depth and
// normal tests, the 3x3 moments of the radiance (_local_moments), the history
// clamp, the anti-lag, the accumulation and the new packed history
// (_pack_history). It writes the new history, the accumulated colour with its
// luma (what the first pass filters), the accumulated hit distance, the
// pixel's depth and normal (what every pass reads of a neighbour) and the two
// per-pixel terms every pass reads of its own pixel (1 / (hd_norm + 1e-3) and
// 1 / (luminance_sigma * conv * hd_norm + 1e-3)).
//
// denoise_atrous_kernel is one pass of the à-trous loop at a step: the eight
// edge-clamped taps at +-step in the kernel list's order, their depth, luma
// and normal weights, the sums and the division. It writes the filtered
// colour with its luma for the next pass, or, on the last pass, the step's
// output where(valid, filtered, radiance). The neighbours' colour, depth and
// normal are read through L1/L2 (16 B + 16 B a tap, float4 loads).
//
// They replace no TPU kernel: the reference runs the denoiser as XLA ops
// (dust_tpu/ops/denoise.py). Here they take the place of some 1,470 PyTorch
// ops a 3-pass step.
//
// Bits. Both kernels are held torch.equal to denoise_plain run as PyTorch ops
// on the card, so each line below repeats one PyTorch CUDA op: one float32
// rounding per op, no contraction (built with -fmad=false); a tensor divided
// by a Python number is a multiply by its float32 reciprocal (inv_9, inv_255);
// a Python number in an op is rounded to float32 first; a 3-vector's sum is
// (x + z) + y, as PyTorch's CUDA reduction over a last axis of 3 pairs it;
// torch.clamp and torch.maximum propagate NaN; torch.round is rintf, the
// float16 cast __float2half_rn, and exp / exp2 / log2 / sqrt are the
// libdevice functions PyTorch's kernels call (expf, exp2f, log2f, sqrtf).
//
// What bounds them: bytes. The temporal kernel must read a pixel's inputs
// (radiance 12 B, hit distance 4, depth 4, normal, world position and motion
// 12 each) and its share of the history (12 B), and write the new history
// (12 B), the colour and luma (16), the hit distance (4), depth and normal
// (16) and the two terms (8): 124 B a pixel. A pass reads its own pixel's
// colour, depth and normal (32 B) and terms (8), and writes the colour (16 B);
// the last pass writes the 12-byte output in its place and reads the radiance
// (12 B) too. Neither kernel's name holds "hdda": the benchmark counts those
// kernels as the traversal.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The launch arguments, passed to the kernels by value (ops/denoise.py
// builds them with ctypes and hands the launch functions a pointer).

struct TemporalArgs {
  const int* history;      // (height, width, 3) packed words, whole image
  const float* radiance;   // (rad_rows, width, 3): image rows from rad_lo
  const float* hitdist;    // (rows, width)
  const float* depth;      // (rows, width)
  const float* normal;     // (rows, width, 3)
  const float* world_pos;  // (rows, width, 3)
  const float* motion;     // (rows, width, 3)
  const float* view_proj;  // (4, 4) the previous frame's
  int* new_history;        // (rows, width, 3)
  float4* filt;            // (rows, width): accumulated colour, its luma
  float* acc_hd;           // (rows, width)
  float4* geom;            // (rows, width): depth, normal
  float2* terms;           // (rows, width): inv_hd, inv_lum_sig
  int lo;                  // first image row of the step
  int rows;
  int width;
  int height;              // the history's (the image's) rows
  int rad_lo;              // first image row of radiance
  int rad_rows;
  float clamp_sigma;
  float max_len;           // max_accumulated_frames - 1
  float fast_max_len;      // fast_max_accumulated_frames - 1
  float antilag_sigma;
  float antilag_relative;
  float hitdist_blur_scale;
  float luminance_sigma;
  float inv_9;             // 1 / 9 in float32
  float inv_255;           // 1 / 255
  float w_hi;              // width - 0.5
  float h_hi;              // height - 0.5
};

struct AtrousArgs {
  const float4* filt_in;   // (height, width): colour and luma, whole image
  const float4* geom;      // (height, width): depth, normal, whole image
  const float2* terms;     // (rows, width)
  const float* radiance;   // (rad_rows, width, 3) from rad_lo (last pass)
  float4* filt_out;        // (rows, width), or null on the last pass
  float* out;              // (rows, width, 3) on the last pass, else null
  int lo;
  int rows;
  int width;
  int height;
  int rad_lo;
  int step;
  int normal_power;        // normal_sigma, a positive integer
  float depth_scale;       // 8 / depth_sigma^2 in float32
};

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// ---- PyTorch's CUDA ops, one rounding each ---------------------------------

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.clamp with tensor bounds.
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// torch.maximum.
__device__ __forceinline__ float maximum(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float sum3(float x, float y, float z) {
  return (x + z) + y;
}

// denoise._luma.
__device__ __forceinline__ float luma(float r, float g, float b) {
  return (r * 0.25f + g * 0.5f) + b * 0.25f;
}

// denoise._exp2i: 2**e from float32 bits.
__device__ __forceinline__ float exp2i(int e) {
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ unsigned f16_bits(float x) {
  return static_cast<unsigned>(__half_as_ushort(__float2half_rn(x)));
}

__device__ __forceinline__ float bits_f16(unsigned b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}

// torch.clamp(torch.round(x), lo, hi).long(): the clamp on the float.
__device__ __forceinline__ long long round_clamp(float x, float hi) {
  return static_cast<long long>(clamp(rintf(x), 0.0f, hi));
}

// packing.decode_oct_normal of the (oct_x, oct_y) in [0, 1]^2.
__device__ __forceinline__ void decode_oct(float ox, float oy, float n[3]) {
  const float px = ox * 2.0f - 1.0f;
  const float py = oy * 2.0f - 1.0f;
  const float z = (1.0f - fabsf(px)) - fabsf(py);
  const float t = clamp(-z, 0.0f, 1.0f);
  const float x = px - t * (px >= 0.0f ? 1.0f : -1.0f);
  const float y = py - t * (py >= 0.0f ? 1.0f : -1.0f);
  const float len = sqrtf(sum3(x * x, y * y, z * z));
  n[0] = x / len;
  n[1] = y / len;
  n[2] = z / len;
}

// packing.encode_oct_normal into [0, 1]^2.
__device__ __forceinline__ void encode_oct(const float v[3], float* ox,
                                           float* oy) {
  const float s = (fabsf(v[0]) + fabsf(v[1])) + fabsf(v[2]);
  const float x = v[0] / s, y = v[1] / s, z = v[2] / s;
  float ex, ey;
  if (z >= 0.0f) {
    ex = x;
    ey = y;
  } else {
    ex = (1.0f - fabsf(y)) * (x >= 0.0f ? 1.0f : -1.0f);
    ey = (1.0f - fabsf(x)) * (y >= 0.0f ? 1.0f : -1.0f);
  }
  *ox = ex * 0.5f + 0.5f;
  *oy = ey * 0.5f + 0.5f;
}

// denoise._pack_rgb9e5, the word's low 32 bits.
__device__ __forceinline__ unsigned pack_rgb9e5(const float color[3]) {
  float c[3];
  for (int k = 0; k < 3; ++k) c[k] = clamp(color[k], 0.0f, 65000.0f);
  // amax propagates NaN.
  float top = c[0];
  for (int k = 1; k < 3; ++k)
    top = (isnan(top) || isnan(c[k])) ? NAN : fmaxf(top, c[k]);
  const float maxc = clamp_min(top, 1e-8f);
  const long long bits = __float_as_int(maxc);
  const long long e = min(max((bits >> 23) - 126, -15LL), 16LL);
  const float scale = exp2i(static_cast<int>(9 - e));
  long long m[3];
  for (int k = 0; k < 3; ++k)
    m[k] = min(max(static_cast<long long>(rintf(c[k] * scale)), 0LL), 511LL);
  return static_cast<unsigned>(((e + 15) << 27) | (m[0] << 18) | (m[1] << 9) |
                               m[2]);
}

// ---- the temporal step -----------------------------------------------------

__global__ void __launch_bounds__(kBlockX* kBlockY)
    denoise_temporal_kernel(TemporalArgs a) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= a.width || i >= a.rows) return;
  const int W = a.width;
  const long long p = static_cast<long long>(i) * W + x;
  const float depth = a.depth[p];
  const bool valid_px = isfinite(depth);
  float nrm[3], pos[3], rad[3];
  for (int k = 0; k < 3; ++k) {
    nrm[k] = a.normal[3 * p + k];
    pos[k] = a.world_pos[3 * p + k] + a.motion[3 * p + k];
  }

  // _project: the clip coordinates' four products summed in pairs.
  const float* vp = a.view_proj;
  float clip[4];
  for (int k = 0; k < 4; ++k)
    clip[k] = (pos[0] * vp[4 * k] + pos[1] * vp[4 * k + 1]) +
              (pos[2] * vp[4 * k + 2] + vp[4 * k + 3]);
  const float prev_w = clip[3];
  const float wd = fabsf(prev_w) < 1e-12f ? 1e-12f : prev_w;
  const float px = ((clip[0] / wd) * 0.5f + 0.5f) * static_cast<float>(W);
  const float py =
      (0.5f - (clip[1] / wd) * 0.5f) * static_cast<float>(a.height);
  const bool in_bounds = px >= 0.5f && px <= a.w_hi && py >= 0.5f &&
                         py <= a.h_hi && prev_w > 0.0f;

  // _fetch_history: the four corners, edge-clamped.
  const float hx = clamp(px - 0.5f, 0.0f, static_cast<float>(W) - 1.0f);
  const float hy =
      clamp(py - 0.5f, 0.0f, static_cast<float>(a.height) - 1.0f);
  const long long x0 = min(static_cast<long long>(floorf(hx)),
                           static_cast<long long>(W - 2));
  const long long y0 = min(static_cast<long long>(floorf(hy)),
                           static_cast<long long>(a.height - 2));
  const float fx = hx - static_cast<float>(x0);
  const float fy = hy - static_cast<float>(y0);
  const float wb[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                       (1.0f - fx) * fy, fx * fy};
  const float near_w = 0.1f * clamp_min(prev_w, 1.0f);

  float hist[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float wsum = 0.0f;
  for (int c = 0; c < 4; ++c) {
    const long long q =
        ((y0 + (c >> 1)) * W + x0 + (c & 1)) * 3;
    const unsigned w0 = static_cast<unsigned>(a.history[q]);
    const unsigned w1 = static_cast<unsigned>(a.history[q + 1]);
    const unsigned w2 = static_cast<unsigned>(a.history[q + 2]);
    float vals[6];
    const float scale = exp2i(static_cast<int>((w0 >> 27) & 31) - 15 - 9);
    vals[0] = static_cast<float>((w0 >> 18) & 511) * scale;
    vals[1] = static_cast<float>((w0 >> 9) & 511) * scale;
    vals[2] = static_cast<float>(w0 & 511) * scale;
    vals[3] = bits_f16(w1 >> 16);
    vals[4] = exp2f(static_cast<float>(w1 & 0xFF) * 0.0625f) - 1.0f;
    vals[5] = static_cast<float>((w1 >> 8) & 0xFF) * 0.25f;
    const float c_depth = bits_f16(w2 >> 16);
    float c_nrm[3];
    decode_oct(static_cast<float>((w2 >> 8) & 0xFF) * a.inv_255,
               static_cast<float>(w2 & 0xFF) * a.inv_255, c_nrm);
    const bool ok =
        c_depth > 0.0f && fabsf(c_depth - prev_w) < near_w &&
        sum3(c_nrm[0] * nrm[0], c_nrm[1] * nrm[1], c_nrm[2] * nrm[2]) > 0.8f;
    const float w = wb[c] * (ok ? 1.0f : 0.0f);
    for (int k = 0; k < 6; ++k) hist[k] = hist[k] + vals[k] * w;
    wsum = wsum + w;
  }
  const bool valid_hist = in_bounds && valid_px && wsum > 1e-3f;
  const float inv_w = 1.0f / clamp_min(wsum, 1e-3f);
  float hist_color[3];
  for (int k = 0; k < 3; ++k) hist_color[k] = hist[k] * inv_w;
  const float hist_fast = hist[3] * inv_w;
  const float hist_hd = hist[4] * inv_w;
  const float hist_len = hist[5] * inv_w;

  // _local_moments: box sums over rows, then columns, lo + a + hi.
  const int y = a.lo + i;
  const int ly = y - a.rad_lo;
  const int rows3[3] = {max(ly - 1, 0), ly, min(ly + 1, a.rad_rows - 1)};
  const int cols3[3] = {max(x - 1, 0), x, min(x + 1, W - 1)};
  float b1[3][3], b2[3][3];  // [column][channel]
  for (int j = 0; j < 3; ++j) {
    for (int k = 0; k < 3; ++k) {
      float v[3];
      for (int r = 0; r < 3; ++r)
        v[r] = a.radiance[(static_cast<long long>(rows3[r]) * W + cols3[j]) *
                              3 + k];
      b1[j][k] = (v[0] + v[1]) + v[2];
      b2[j][k] = (v[0] * v[0] + v[1] * v[1]) + v[2] * v[2];
    }
  }
  for (int k = 0; k < 3; ++k)
    rad[k] = a.radiance[(static_cast<long long>(ly) * W + x) * 3 + k];
  float mu[3], sigma[3];
  for (int k = 0; k < 3; ++k) {
    mu[k] = ((b1[0][k] + b1[1][k]) + b1[2][k]) * a.inv_9;
    const float s2 = ((b2[0][k] + b2[1][k]) + b2[2][k]) * a.inv_9;
    sigma[k] = sqrtf(clamp_min(s2 - mu[k] * mu[k], 0.0f));
  }

  // The history clamp.
  for (int k = 0; k < 3; ++k) {
    const float gs = sigma[k] * a.clamp_sigma;
    const float clamped = clamp_t(hist_color[k], mu[k] - gs, mu[k] + gs);
    hist_color[k] = valid_hist ? clamped : hist_color[k];
  }
  const float n0 = valid_hist ? clamp_max(hist_len, a.max_len) : 0.0f;

  // The anti-lag via the fast history.
  const float luma_cur = luma(rad[0], rad[1], rad[2]);
  const float nf = valid_hist ? clamp_max(hist_len, a.fast_max_len) : 0.0f;
  const float fast = hist_fast + (luma_cur - hist_fast) / (nf + 1.0f);
  const float slow_luma = luma(hist_color[0], hist_color[1], hist_color[2]);
  const float sig_l = luma(sigma[0], sigma[1], sigma[2]);
  const float deviation =
      fabsf(fast - slow_luma) /
      ((sig_l * a.antilag_sigma +
        clamp_min(maximum(fast, slow_luma), 1e-3f) * a.antilag_relative) +
       1e-6f);
  const float lag = clamp(1.0f - deviation, 0.05f, 1.0f);
  const float n = n0 * (lag * lag);

  const float alpha = 1.0f / (n + 1.0f);
  float acc[3];
  for (int k = 0; k < 3; ++k)
    acc[k] = valid_px ? hist_color[k] + (rad[k] - hist_color[k]) * alpha
                      : rad[k];
  const float hitdist = a.hitdist[p];
  const float acc_hd =
      valid_px ? hist_hd + (hitdist - hist_hd) * alpha : hitdist;
  const float new_len = valid_px ? n + 1.0f : 0.0f;

  // What every à-trous pass reads.
  const float hd_norm =
      clamp(acc_hd / (acc_hd + 4.0f), 0.05f, 1.0f) * a.hitdist_blur_scale;
  const float conv = sqrtf(1.0f / clamp_min(new_len, 1.0f));
  a.terms[p] = make_float2(
      1.0f / (hd_norm + 1e-3f),
      1.0f / ((a.luminance_sigma * conv) * hd_norm + 1e-3f));
  a.filt[p] = make_float4(acc[0], acc[1], acc[2], luma(acc[0], acc[1], acc[2]));
  a.geom[p] = make_float4(depth, nrm[0], nrm[1], nrm[2]);
  a.acc_hd[p] = acc_hd;

  // _pack_history.
  float color_in[3];
  for (int k = 0; k < 3; ++k) color_in[k] = valid_px ? acc[k] : 0.0f;
  const unsigned h0 = pack_rgb9e5(color_in);
  const long long len_q = round_clamp(new_len * 4.0f, 255.0f);
  const long long hd_q = round_clamp(
      log2f(1.0f + clamp(acc_hd, 0.0f, 60000.0f)) * 16.0f, 255.0f);
  const unsigned h1 = static_cast<unsigned>(
      (static_cast<long long>(f16_bits(valid_px ? fast : 0.0f)) << 16) |
      (len_q << 8) | hd_q);
  const float n_in[3] = {valid_px ? nrm[0] : 0.0f, valid_px ? nrm[1] : 0.0f,
                         valid_px ? nrm[2] : 1.0f};
  float ox, oy;
  encode_oct(n_in, &ox, &oy);
  const long long oct_x = round_clamp(ox * 255.0f, 255.0f);
  const long long oct_y = round_clamp(oy * 255.0f, 255.0f);
  const float d_in = valid_px ? clamp_max(depth, 60000.0f) : -1.0f;
  const unsigned h2 = static_cast<unsigned>(
      (static_cast<long long>(f16_bits(d_in)) << 16) | (oct_x << 8) | oct_y);
  a.new_history[3 * p] = static_cast<int>(h0);
  a.new_history[3 * p + 1] = static_cast<int>(h1);
  a.new_history[3 * p + 2] = static_cast<int>(h2);
}

// ---- one à-trous pass ------------------------------------------------------

// denoise._powi: x**n by repeated squaring, in its order.
__device__ __forceinline__ float powi(float x, int n) {
  float result = 0.0f, bit = x;
  bool have = false;
  while (n) {
    if (n & 1) {
      result = have ? result * bit : bit;
      have = true;
    }
    n >>= 1;
    if (n) bit = bit * bit;
  }
  return result;
}

__global__ void __launch_bounds__(kBlockX* kBlockY)
    denoise_atrous_kernel(AtrousArgs a) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= a.width || i >= a.rows) return;
  const int W = a.width;
  const int y = a.lo + i;
  const long long own = static_cast<long long>(y) * W + x;
  const long long p = static_cast<long long>(i) * W + x;
  const float4 f = a.filt_in[own];
  const float4 g = a.geom[own];
  const float2 t = a.terms[p];
  const bool valid = isfinite(g.x);
  const float depth_s = valid ? g.x : 1e10f;
  const float depth_c = clamp_min(depth_s, 1.0f);

  float wsum = 0.25f;
  float cs[3] = {f.x * 0.25f, f.y * 0.25f, f.z * 0.25f};
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    const int dy = k / 3 - 1, dx = k % 3 - 1;
    const float kw = (dx == 0 || dy == 0) ? 0.125f : 0.0625f;
    const int yq = min(max(y + dy * a.step, 0), a.height - 1);
    const int xq = min(max(x + dx * a.step, 0), W - 1);
    const long long q = static_cast<long long>(yq) * W + xq;
    const float4 fq = a.filt_in[q];
    const float4 gq = a.geom[q];
    const bool valid_q = isfinite(gq.x);
    const float d_q = valid_q ? gq.x : 1e10f;
    const float log_w = (-fabsf(depth_s - d_q)) / depth_c * a.depth_scale *
                            t.x -
                        fabsf(f.w - fq.w) * t.y;
    const float ndot =
        clamp_min(sum3(g.y * gq.y, g.z * gq.z, g.w * gq.w), 0.0f);
    const float w_n = powi(ndot, a.normal_power);
    const float wgt = expf(clamp_min(log_w, -40.0f)) * kw * w_n *
                      (valid_q ? 1.0f : 0.0f);
    cs[0] = cs[0] + fq.x * wgt;
    cs[1] = cs[1] + fq.y * wgt;
    cs[2] = cs[2] + fq.z * wgt;
    wsum = wsum + wgt;
  }
  const float r = cs[0] / wsum, gr = cs[1] / wsum, b = cs[2] / wsum;
  if (a.filt_out != nullptr) {
    a.filt_out[p] = make_float4(r, gr, b, luma(r, gr, b));
    return;
  }
  const long long rp = (static_cast<long long>(y - a.rad_lo) * W + x) * 3;
  a.out[3 * p] = valid ? r : a.radiance[rp];
  a.out[3 * p + 1] = valid ? gr : a.radiance[rp + 1];
  a.out[3 * p + 2] = valid ? b : a.radiance[rp + 2];
}

dim3 grid(int width, int rows) {
  return dim3((width + kBlockX - 1) / kBlockX, (rows + kBlockY - 1) / kBlockY);
}

}  // namespace

extern "C" int denoise_temporal_launch(const void* args, void* stream) {
  const TemporalArgs& a = *static_cast<const TemporalArgs*>(args);
  if (a.rows <= 0 || a.width <= 0) return 0;
  denoise_temporal_kernel<<<grid(a.width, a.rows), dim3(kBlockX, kBlockY), 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int denoise_atrous_launch(const void* args, void* stream) {
  const AtrousArgs& a = *static_cast<const AtrousArgs*>(args);
  if (a.rows <= 0 || a.width <= 0) return 0;
  denoise_atrous_kernel<<<grid(a.width, a.rows), dim3(kBlockX, kBlockY), 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
