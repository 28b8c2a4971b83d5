// The G-buffer and the final gather for Hopper (sm_90a): four kernels, two
// around the primary trace and two around the AO and final-gather traces,
// each one thread per ray.
//
// primary_rays_kernel writes the camera rays [lo, lo + count) of a
// width x height image in the order the trace takes them (8x128-pixel tiles
// when `tiled`, raster order otherwise): the direction as camera_ray_dirs
// in ops/camera.py computes it on the card, and the camera position as the
// origin. Its plain version is camera.primary_rays_plain.
//
// gbuffer_resolve_kernel reads a ray's trace result (t, inst, row, bit) and
// the ray, and writes every field of the G-buffer dict of
// shade.resolve_hits_plain (hit, inst, depth, albedo, normal, motion,
// voxel_id, world_pos, palette_idx) and, when the sky's tables are given,
// sky_out: (sky + sun radiance of the normalised direction) / 3.14, as
// sky.primary_sky computes it. The instance affines are read for the ray's
// own instance; the plain version computes every instance's and selects one,
// which gives the selected lane the same arithmetic.
//
// gather_dirs_kernel writes the gather rays' directions [lo, lo + count) in
// the trace's order: the cosine blue-noise texel of the ray's pixel rotated
// into the G-buffer normal's frame, (0, 1, 0) on a primary miss, and the AO
// trace's t_max. Its plain version is shade.gather_dirs_plain.
//
// gather_resolve_kernel reads the AO and final-gather trace results, the
// gather rays and the dense GI cache, and writes the frame's radiance, hit
// distance and indirect light (illum) as shade.resolve_gather_plain
// computes them: the rough hit's entry face, the cache row's radiance and
// albedo, the bounce off it, and the sky of the rays that leave the scene;
// for the hash frame's enqueue also the face, the sample count and the
// leaf's centre. Its core, cache_read, is the cache read of any rough hit.
//
// They replace no TPU kernel: the reference computes these stages with XLA
// ops (dust_tpu/render/pipeline.py steps 1 and 3, dust_tpu/ops/shade.py).
// Here they take the place of some 570 PyTorch ops of the primary stage and
// some 520 of the gather stage a frame: 38 and 27 ms of card time at
// 3840x2160.
//
// Bits. Every kernel is held torch.equal to its plain version run as
// PyTorch ops on the card, so each line below repeats one PyTorch CUDA op:
// one float32 rounding per op, no contraction (built with -fmad=false);
// ops/fp.py's fma as (float)((double)a * (double)b + (double)c); a tensor
// divided by a Python number as PyTorch's CUDA kernel computes it, times the
// reciprocal rounded to float32 (inv_w, inv_h, inv_255, inv_pi, inv_1023,
// inv_12_92, inv_1_055); the sum over a 3-vector in the order of PyTorch's
// CUDA reduction, (x + z) + y, and over a 4-vector (x + z) + (y + w);
// torch.linalg.cross as its kernel is contracted, a * b - c * d as
// fma(a, b, -(c * d)); the sky model past the arccos rounded to bfloat16
// after every op, with the libdevice functions PyTorch's kernels call
// (expf, acosf, sqrtf, sinf, powf).
//
// What bounds them: bytes. The resolve must read the trace result (16 B a
// ray), the ray (24 B) and one random voxel word (a 32-byte sector), and
// write the G-buffer (hit 1 B; inst, voxel_id, palette_idx 8 B each; depth
// 4 B; albedo 16 B; normal, motion, world_pos 12 B each) and sky_out (12 B):
// 165 B a ray. The rays kernel writes 24 B a ray. The gather kernels need
// less on a primary miss than on a hit. The directions read the hit (1 B)
// and write the direction and t_max (16 B), and on a hit read the normal
// (12 B) and a noise texel (from a 192 KiB layer that stays in cache): 17 B
// a miss, 29 B a hit. The resolve reads the hit (1 B) and writes radiance,
// hit distance and illum (28 B); a miss reads sky_out (12 B): 41 B; a hit
// reads both trace results (20 B), the ray (24 B) and direct (12 B): 85 B;
// a final-gather hit also its random cache row (a 32-byte sector). The hash
// frame's enqueue writes 20 B more a ray, from the ray of every ray. No
// kernel's name holds "hdda": the benchmark counts those kernels as the
// traversal.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

// The launch arguments, passed to the kernels by value (ops/gbuffer.py
// builds them with ctypes and hands the launch functions a pointer).

struct RaysArgs {
  const float* view_cols;     // (3, 3)
  const float* position;      // (3,)
  const float* tan_half_fov;  // ()
  float* origin;              // (count, 3)
  float* dir;                 // (count, 3)
  long long lo;
  long long count;
  int width;
  int height;
  int tiled;
  float inv_w;   // 1 / width in float32
  float inv_h;   // 1 / height
  float aspect;  // width / height in float32
};

// The sky model (sky.SkyModelState) and the XYZ -> ACEScg matrix it ends in;
// configs null: no sky.
struct SkyArgs {
  const float* configs;          // (3, 9)
  const float* radiances;        // (3,)
  const float* ld;               // (3, 6)
  const float* sun_dir;          // (3,)
  const float* solar_intensity;  // (3,)
  const float* solar_radius;     // ()
  float xyz_to_acescg[9];
};

struct ResolveArgs {
  const float* t;  // (n,) the trace result
  const int* inst;
  const int* row;
  const int* bit;
  const float* origin;  // (n, 3)
  const float* dir;     // (n, 3)
  const long long* leaf_base;     // (I,) first flat leaf row of each instance
  const int* voxel_attr;          // (va_rows, 16)
  const float* world_to_obj;      // (I, 3, 4)
  const float* obj_to_world;      // (I, 3, 4)
  const float* prev_obj_to_world; // (I, 3, 4)
  SkyArgs sky;             // configs null: no sky_out
  bool* hit;               // (n,)
  long long* inst_out;     // (n,)
  float* depth;            // (n,)
  float* albedo;           // (n, 4)
  float* normal;           // (n, 3)
  float* motion;           // (n, 3)
  long long* voxel_id;     // (n,)
  float* world_pos;        // (n, 3)
  long long* palette_idx;  // (n,)
  float* sky_out;          // (n, 3)
  float inv_255;
  float inv_pi;  // 1 / 3.14
  long long va_rows;
  int n;
};

struct GatherDirsArgs {
  const float* normal;  // (count, 3) the G-buffer's
  const bool* hit;      // (count,)
  const float* noise;   // (noise_h, noise_w, 3) the cosine blue noise's layer
  float* gi_dir;        // (count, 3)
  float* ao_t_max;      // (count,)
  long long lo;
  long long count;
  int width;
  int height;
  int tiled;
  int noise_h;
  int noise_w;
  int shift_x;  // (offset x + rand) % noise_w
  int shift_y;  // (offset y + rand) % noise_h
  float ao_threshold;
};

// What the cache read of a rough hit needs: the instance affines, the dense
// GI cache's layout and rows, and the colour constants of the bounce.
struct CacheArgs {
  const float* world_to_obj;  // (I, 3, 4)
  const float* obj_to_world;  // (I, 3, 4)
  const long long* layout;    // (I, 2): each instance's first cell, cell cap
  const int* table;           // (6 * cells, 3) the cache's rows
  long long cells;
  float acescg_to_srgb[9];
  float srgb_to_acescg[9];
  float inv_1023;
  float inv_12_92;
  float inv_1_055;
};

struct GatherResolveArgs {
  const float* fg_t;  // (n,) the final-gather trace result
  const int* fg_inst;
  const int* fg_row;
  const float* ao_t;  // (n,) the AO trace result
  const int* ao_inst;
  const float* origin;   // (n, 3) the gather rays
  const float* dir;      // (n, 3)
  const bool* hit;       // (n,) the primary hit
  const float* direct;   // (n, 3)
  const float* sky_out;  // (n, 3)
  const float* debug_illum;  // (n, 3) replaces illum where hit; null: none
  CacheArgs cache;
  SkyArgs sky;
  float* radiance;  // (n, 3)
  float* hitdist;   // (n,)
  float* illum;     // (n, 3)
  int* face;        // (n,) the hash frame's enqueue; null in the dense frame
  float* count;     // (n,)
  float* center;    // (n, 3)
  int bounce;       // contribution_secondary_spatial_hash
  int skylight;     // contribution_secondary_skylight
  int n;
};

namespace {

constexpr int kThreads = 256;

// ---- PyTorch's CUDA ops, one rounding each ---------------------------------

// ops/fp.py fma: the float32 product is exact in float64, one float64 sum,
// then float32.
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) +
                            static_cast<double>(c));
}

// A float32 value rounded to bfloat16 and back (the result of a bf16 op).
__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x.sum(dim=-1) over (N, 3) on the card: two threads over the axis (x and z,
// then y), combined by a shuffle.
__device__ __forceinline__ float sum3(float x, float y, float z) {
  return (x + z) + y;
}

// x.sum(dim=-1) over (N, 4) on the card: (x + z) + (y + w).
__device__ __forceinline__ float sum4(float x, float y, float z, float w) {
  return (x + z) + (y + w);
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(sum3(x * x, y * y, z * z));
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float sign(float v) {
  return static_cast<float>((0.0f < v) - (v < 0.0f));
}

// shade._inst_xform for one instance's (3, 4) affine m.
__device__ __forceinline__ void xform(const float* m, const float p[3],
                                      bool translate, float out[3]) {
  for (int k = 0; k < 3; ++k) {
    const float* r = m + 4 * k;
    float o = fma64(r[2], p[2], fma64(r[0], p[0], r[1] * p[1]));
    if (translate) o = o + r[3];
    out[k] = o;
  }
}

// utils/color.apply_mat3.
__device__ __forceinline__ void mat3(const float* m, const float v[3],
                                     float out[3]) {
  for (int k = 0; k < 3; ++k)
    out[k] = v[0] * m[3 * k] + v[1] * m[3 * k + 1] + v[2] * m[3 * k + 2];
}

// packing.cubed_normalize: the dominant axis' sign (amax propagates NaN).
__device__ __forceinline__ void cubed_normalize(const float v[3],
                                                float out[3]) {
  float mag[3];
  for (int k = 0; k < 3; ++k) mag[k] = fabsf(v[k]);
  const float top = (isnan(mag[0]) || isnan(mag[1]) || isnan(mag[2]))
                        ? NAN
                        : fmaxf(fmaxf(mag[0], mag[1]), mag[2]);
  for (int k = 0; k < 3; ++k)
    out[k] = sign(v[k]) * static_cast<float>(mag[k] >= top);
}

// packing.normal_to_face_id of an axis-aligned normal (torch.round is
// round-half-even, .int() truncates).
__device__ __forceinline__ int face_id(const float n[3]) {
  const float s = clamp(sum3(n[0], n[1], n[2]), 0.0f, 1.0f);
  return static_cast<int>(rintf(s)) +
         static_cast<int>(rintf(fabsf(n[2]))) * 4 +
         static_cast<int>(rintf(fabsf(n[1]))) * 2;
}

// The pixel (x, y) of ray r of a width x height image in the trace's order:
// 8x128-pixel tiles when `tiled`, r = ((tx * H/8 + ty) * 8 + iy) * 128 + ix;
// raster order otherwise.
__device__ __forceinline__ void pixel_of(long long r, int width, int height,
                                         int tiled, long long* x,
                                         long long* y) {
  if (tiled) {
    const long long ix = r % 128, q = r / 128;
    const long long iy = q % 8, tile = q / 8;
    const long long rows = height / 8;
    *x = (tile / rows) * 128 + ix;
    *y = (tile % rows) * 8 + iy;
  } else {
    *x = r % width;
    *y = r / width;
  }
}

// ---- primary rays ----------------------------------------------------------

__global__ void __launch_bounds__(kThreads) primary_rays_kernel(RaysArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.count) return;
  long long x, y;
  pixel_of(a.lo + i, a.width, a.height, a.tiled, &x, &y);
  const float u = (static_cast<float>(x) + 0.5f) * a.inv_w;
  const float v = (static_cast<float>(y) + 0.5f) * a.inv_h;
  const float tan = *a.tan_half_fov;
  const float cx = ((2.0f * u - 1.0f) * a.aspect) * tan;
  const float cy = (1.0f - 2.0f * v) * tan;
  const float* m = a.view_cols;
  for (int k = 0; k < 3; ++k) {
    a.dir[3 * i + k] = m[3 * k] * cx + m[3 * k + 1] * cy - m[3 * k + 2];
    a.origin[3 * i + k] = a.position[k];
  }
}

// ---- the sky ---------------------------------------------------------------

// sky.sky_radiance of a direction d (ACEScg).
__device__ void sky_radiance(const SkyArgs& a, const float d[3],
                             float out[3]) {
  const float* s = a.sun_dir;
  const float cos_theta = clamp(d[1], 0.0f, 1.0f);
  const float cos_gamma =
      clamp(d[0] * s[0] + d[1] * s[1] + d[2] * s[2], -1.0f, 1.0f);
  const float gamma = acosf(cos_gamma);
  const float ct = bf(cos_theta), cg = bf(cos_gamma), g = bf(gamma);
  const float ct_off = bf(ct + static_cast<float>(0.01));
  const float ray_m = bf(cg * cg);
  const float zenith = bf(sqrtf(ct));
  float xyz[3];
  for (int ch = 0; ch < 3; ++ch) {
    float c[9];
    for (int k = 0; k < 9; ++k) c[k] = bf(a.configs[9 * ch + k]);
    const float exp_m = bf(expf(bf(c[4] * g)));
    const float mie_d =
        bf(bf(1.0f + bf(c[8] * c[8])) - bf(bf(2.0f * c[8]) * cg));
    const float mie = bf(bf(1.0f + ray_m) / bf(mie_d * bf(sqrtf(mie_d))));
    const float f =
        bf(1.0f + bf(c[0] * bf(expf(bf(c[1] / ct_off)))));
    float h = bf(c[2] + bf(c[3] * exp_m));
    h = bf(h + bf(c[5] * ray_m));
    h = bf(h + bf(c[6] * mie));
    h = bf(h + bf(c[7] * zenith));
    xyz[ch] = bf(f * h) * a.radiances[ch] * 683.0f;
  }
  mat3(a.xyz_to_acescg, xyz, out);
  if (!(s[1] > 0.0f)) out[0] = out[1] = out[2] = 0.0f;
}

// sky.sun_radiance of a normalised direction d (ACEScg).
__device__ void sun_radiance(const SkyArgs& a, const float d[3],
                             float out[3]) {
  const float* s = a.sun_dir;
  const float cos_gamma = d[0] * s[0] + d[1] * s[1] + d[2] * s[2];
  const float sin_r = sinf(*a.solar_radius);
  const float ar2 = (1.0f / (sin_r * sin_r)) * 1.0f;
  const float singamma = 1.0f - cos_gamma * cos_gamma;
  const float sc2 = 1.0f - ar2 * singamma * singamma;
  const float sc = sqrtf(clamp_min(sc2, 0.0f));
  float xyz[3];
  for (int ch = 0; ch < 3; ++ch) {
    const float* ld = a.ld + 6 * ch;
    float dark = ld[0] + ld[1] * sc;
    float cur = sc;
    for (int k = 0; k < 4; ++k) {
      cur = cur * sc;
      dark = dark + ld[2 + k] * cur;
    }
    xyz[ch] = a.solar_intensity[ch] * dark;
  }
  mat3(a.xyz_to_acescg, xyz, out);
  if (!(cos_gamma >= 0.0f && d[1] >= 0.0f && sc2 > 0.0f))
    out[0] = out[1] = out[2] = 0.0f;
}

// ---- G-buffer resolve ------------------------------------------------------

__global__ void __launch_bounds__(kThreads) gbuffer_resolve_kernel(
    ResolveArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int inst_raw = a.inst[i];
  const bool hit = inst_raw >= 0;
  const long long inst = hit ? inst_raw : 0;
  const long long bit = max(a.bit[i], 0);
  const long long vid =
      (a.leaf_base[inst] + max(a.row[i], 0)) * 64 + bit;
  const long long vrow = min(max(vid >> 4, 0LL), a.va_rows - 1);
  const long long rgba =
      static_cast<long long>(a.voxel_attr[vrow * 16 + (vid & 15)]) &
      0xFFFFFFFFLL;

  float o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = a.origin[3 * i + k];
    d[k] = a.dir[3 * i + k];
  }
  const float t_hit = a.t[i];
  const float t = hit ? t_hit : 0.0f;
  float o_obj[3], d_obj[3], hit_obj[3], hit_w[3];
  xform(a.world_to_obj + 12 * inst, o, true, o_obj);
  xform(a.world_to_obj + 12 * inst, d, false, d_obj);
  for (int k = 0; k < 3; ++k) {
    hit_obj[k] = fma64(d_obj[k], t, o_obj[k]);
    hit_w[k] = fma64(d[k], t, o[k]);
  }

  // The leaf origin from the hit point: 0.05 voxels into the hit voxel,
  // floored, less the in-leaf offset, snapped to the 4-voxel lattice.
  const long long off[3] = {(bit >> 4) & 3, (bit >> 2) & 3, bit & 3};
  const float dlen = clamp_min(norm3(d_obj[0], d_obj[1], d_obj[2]),
                               static_cast<float>(1e-20));
  float rel[3];
  for (int k = 0; k < 3; ++k) {
    const float p_in = fma64(d_obj[k] / dlen, static_cast<float>(0.05),
                             hit_obj[k]);
    const long long vhat = static_cast<long long>(floorf(p_in));
    const long long leaf = ((vhat - off[k] + 2) >> 2) << 2;
    const float center =
        (static_cast<float>(leaf) + static_cast<float>(off[k])) + 0.5f;
    rel[k] = hit_obj[k] - center;
  }
  float n_obj[3], n_w[3];
  cubed_normalize(rel, n_obj);
  xform(a.obj_to_world + 12 * inst, n_obj, false, n_w);
  const float nlen =
      clamp_min(norm3(n_w[0], n_w[1], n_w[2]), static_cast<float>(1e-8));

  float prev_w[3];
  xform(a.prev_obj_to_world + 12 * inst, hit_obj, true, prev_w);

  const long long palette = (rgba >> 24) & 0xFF;
  a.hit[i] = hit;
  a.inst_out[i] = inst;
  a.depth[i] = hit ? t_hit : __int_as_float(0x7f800000);
  reinterpret_cast<float4*>(a.albedo)[i] =
      hit ? make_float4(static_cast<float>(rgba & 0xFF) * a.inv_255,
                        static_cast<float>((rgba >> 8) & 0xFF) * a.inv_255,
                        static_cast<float>((rgba >> 16) & 0xFF) * a.inv_255,
                        255.0f * a.inv_255)
          : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  for (int k = 0; k < 3; ++k) {
    a.normal[3 * i + k] = hit ? n_w[k] / nlen : 0.0f;
    a.motion[3 * i + k] = hit ? prev_w[k] - hit_w[k] : 0.0f;
    a.world_pos[3 * i + k] = hit ? hit_w[k] : 0.0f;
  }
  a.voxel_id[i] = hit ? (bit << 24) | (palette << 16) | (inst & 0xFFFF) : 0;
  a.palette_idx[i] = palette;

  if (a.sky.configs == nullptr) return;
  const float len = norm3(d[0], d[1], d[2]);
  const float dn[3] = {d[0] / len, d[1] / len, d[2] / len};
  float sky[3], sun[3];
  sky_radiance(a.sky, dn, sky);
  sun_radiance(a.sky, dn, sun);
  for (int k = 0; k < 3; ++k)
    a.sky_out[3 * i + k] = (sky[k] + sun[k]) * a.inv_pi;
}

// ---- gather directions -----------------------------------------------------

// packing.rotate_vector_by_normal: t from the +z frame into n's, by the
// shortest-arc quaternion (its 4-term sum (x + z) + (y + w); the cross
// product as PyTorch's kernel contracts it, a * b - c * d as
// fma(a, b, -(c * d))).
__device__ void rotate_by_normal(const float n[3], const float t[3],
                                 float out[3]) {
  float q[4] = {-n[1], n[0], 0.0f, 1.0f + n[2]};
  const float len = sqrtf(sum4(q[0] * q[0], q[1] * q[1], q[2] * q[2],
                               q[3] * q[3]));
  for (int k = 0; k < 4; ++k) q[k] = q[k] / len;
  if (n[2] < -0.99999f) {
    q[0] = -1.0f;
    q[1] = q[2] = q[3] = 0.0f;
  }
  const float dot = sum3(q[0] * t[0], q[1] * t[1], q[2] * t[2]);
  const float w = q[3] * q[3] - sum3(q[0] * q[0], q[1] * q[1], q[2] * q[2]);
  const float cross[3] = {__fmaf_rn(q[1], t[2], -(q[2] * t[1])),
                          __fmaf_rn(q[2], t[0], -(q[0] * t[2])),
                          __fmaf_rn(q[0], t[1], -(q[1] * t[0]))};
  for (int k = 0; k < 3; ++k)
    out[k] = ((2.0f * dot) * q[k] + w * t[k]) + (2.0f * q[3]) * cross[k];
}

__global__ void __launch_bounds__(kThreads) gather_dirs_kernel(
    GatherDirsArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.count) return;
  long long x, y;
  pixel_of(a.lo + i, a.width, a.height, a.tiled, &x, &y);
  // noise.bn_fetch's texel: the layer shifted by (shift_y, shift_x) and
  // tiled over the image.
  const float* tex = a.noise + 3 * (((y + a.shift_y) % a.noise_h) *
                                        a.noise_w +
                                    (x + a.shift_x) % a.noise_w);
  float t[3], n[3], dir[3];
  for (int k = 0; k < 3; ++k) {
    t[k] = tex[k] * 2.0f - 1.0f;
    n[k] = a.normal[3 * i + k];
  }
  rotate_by_normal(n, t, dir);
  const bool hit = a.hit[i];
  const float miss[3] = {0.0f, 1.0f, 0.0f};
  for (int k = 0; k < 3; ++k) a.gi_dir[3 * i + k] = hit ? dir[k] : miss[k];
  a.ao_t_max[i] = hit ? a.ao_threshold : -1.0f;
}

// ---- gather resolve --------------------------------------------------------

// The cache read of a rough hit (ray o + t d of instance inst, leaf row
// row; miss lanes take instance 0 and t = 0) and what it yields.
struct CacheRead {
  long long inst;
  float d_obj[3];    // the direction in the instance's space
  float hit_obj[3];  // the hit point there
  int face;          // shade.entry_face
  bool found;        // valid and a cached row
  float count;       // its samples (0 unless found)
  float bounce[3];   // srgb_to_acescg(acescg_to_srgb(cached) * albedo)
};

// shade.entry_face, gi_cache.dense_index and dense_get (gated by `valid`),
// the row's albedo through srgb_eotf, and the bounce of the cached
// radiance off it.
__device__ CacheRead cache_read(const CacheArgs& c, int inst_raw, int row,
                                float t_hit, const float o[3],
                                const float d[3], bool valid) {
  CacheRead r;
  const bool hit = inst_raw >= 0;
  r.inst = hit ? inst_raw : 0;
  const float t = hit ? t_hit : 0.0f;
  const float* w2o = c.world_to_obj + 12 * r.inst;
  float o_obj[3];
  xform(w2o, o, true, o_obj);
  xform(w2o, d, false, r.d_obj);
  for (int k = 0; k < 3; ++k) r.hit_obj[k] = fma64(r.d_obj[k], t, o_obj[k]);

  // The entry axis is the one nearest the block grid; the face opposes the
  // ray.
  float fr[3];
  for (int k = 0; k < 3; ++k) {
    const float v = r.hit_obj[k] * 0.25f;
    fr[k] = fabsf(v - rintf(v));
  }
  const bool ax_y = fr[1] <= fr[0] && fr[1] <= fr[2];
  const bool ax_z = !ax_y && fr[2] <= fr[0] && fr[2] <= fr[1];
  const float axes[3] = {static_cast<float>(!ax_y && !ax_z),
                         static_cast<float>(ax_y), static_cast<float>(ax_z)};
  float n_obj[3], n_w[3], n_face[3];
  for (int k = 0; k < 3; ++k) n_obj[k] = -sign(r.d_obj[k]) * axes[k];
  xform(c.obj_to_world + 12 * r.inst, n_obj, false, n_w);
  cubed_normalize(n_w, n_face);
  r.face = face_id(n_face);

  // Rows past the instance's cell cap read the zero padding tail.
  const long long base = c.layout[2 * r.inst], cap = c.layout[2 * r.inst + 1];
  const long long leaf = max(row, 0);
  const long long f = min(max(r.face, 0), 5);
  const long long idx = leaf < cap ? f * c.cells + base + min(leaf, cap - 1)
                                   : c.cells * 6 - 1;
  const unsigned* w = reinterpret_cast<const unsigned*>(c.table) + 3 * idx;
  const unsigned w0 = w[0], w1 = w[1], w2 = w[2];
  const float count = static_cast<float>(w1 >> 16);
  r.found = valid && count > 0.0f;
  r.count = r.found ? count : 0.0f;
  const float rad[3] = {
      __half2float(__ushort_as_half(static_cast<unsigned short>(w0))),
      __half2float(__ushort_as_half(static_cast<unsigned short>(w0 >> 16))),
      __half2float(__ushort_as_half(static_cast<unsigned short>(w1)))};
  float cached[3], srgb[3];
  for (int k = 0; k < 3; ++k) cached[k] = r.found ? rad[k] : 0.0f;
  mat3(c.acescg_to_srgb, cached, srgb);
  // unpack_r10g10b10a2, then colour.srgb_eotf.
  const unsigned code[3] = {(w2 >> 22) & 1023, (w2 >> 12) & 1023,
                            (w2 >> 2) & 1023};
  for (int k = 0; k < 3; ++k) {
    const float e = static_cast<float>(code[k]) * c.inv_1023;
    const float lin =
        e < 0.04045f ? e * c.inv_12_92
                     : powf((fabsf(e) + 0.055f) * c.inv_1_055, 2.4f);
    srgb[k] = srgb[k] * lin;
  }
  mat3(c.srgb_to_acescg, srgb, r.bounce);
  return r;
}

__global__ void __launch_bounds__(kThreads) gather_resolve_kernel(
    GatherResolveArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const bool hit = a.hit[i];
  const bool ao_hit = a.ao_inst[i] >= 0;
  const int fg_inst = a.fg_inst[i];
  const bool fg_active = hit && !ao_hit;
  const bool fg_hit = fg_active && fg_inst >= 0;
  const bool sky_ray = fg_active && !(fg_inst >= 0);
  const float fg_t = a.fg_t[i];
  float o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = a.origin[3 * i + k];
    d[k] = a.dir[3 * i + k];
  }
  const CacheRead r =
      cache_read(a.cache, fg_inst, a.fg_row[i], fg_t, o, d, fg_hit);

  // illum as the frame adds it to zeros: 0.0 + -0.0 is 0.0.
  float illum[3] = {0.0f, 0.0f, 0.0f};
  if (a.bounce)
    for (int k = 0; k < 3; ++k)
      illum[k] = illum[k] + (fg_hit ? r.bounce[k] : 0.0f);
  if (a.skylight) {
    float sky[3] = {0.0f, 0.0f, 0.0f};
    if (sky_ray) sky_radiance(a.sky, d, sky);
    for (int k = 0; k < 3; ++k)
      illum[k] = illum[k] + (sky_ray ? sky[k] : 0.0f);
  }
  // The debug view (debug_visualize_spatial_hash) shows the cache instead.
  if (a.debug_illum != nullptr)
    for (int k = 0; k < 3; ++k)
      illum[k] = hit ? a.debug_illum[3 * i + k] : illum[k];
  float hd = ao_hit ? a.ao_t[i] : 0.0f;
  hd = fg_hit ? fg_t : hd;
  a.hitdist[i] = hit ? hd : 100000.0f;
  for (int k = 0; k < 3; ++k) {
    a.radiance[3 * i + k] =
        hit ? a.direct[3 * i + k] + illum[k] : a.sky_out[3 * i + k];
    a.illum[3 * i + k] = illum[k];
  }
  if (a.face == nullptr) return;

  // The hash frame's enqueue: the face, the count and
  // shade.entry_leaf_center (0.05 voxels into the leaf, floored to the
  // 4-voxel lattice).
  a.face[i] = r.face;
  a.count[i] = r.count;
  const float dlen = clamp_min(norm3(r.d_obj[0], r.d_obj[1], r.d_obj[2]),
                               static_cast<float>(1e-20));
  float center_obj[3], center[3];
  for (int k = 0; k < 3; ++k) {
    const float p_in = fma64(r.d_obj[k] / dlen, static_cast<float>(0.05),
                             r.hit_obj[k]);
    center_obj[k] = floorf(p_in * 0.25f) * 4.0f + 2.0f;
  }
  xform(a.cache.obj_to_world + 12 * r.inst, center_obj, true, center);
  for (int k = 0; k < 3; ++k) a.center[3 * i + k] = center[k];
}

int blocks(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int primary_rays_launch(const void* args, void* stream) {
  const RaysArgs& a = *static_cast<const RaysArgs*>(args);
  if (a.count <= 0) return 0;
  primary_rays_kernel<<<blocks(a.count), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gbuffer_resolve_launch(const void* args, void* stream) {
  const ResolveArgs& a = *static_cast<const ResolveArgs*>(args);
  if (a.n <= 0) return 0;
  gbuffer_resolve_kernel<<<blocks(a.n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_dirs_launch(const void* args, void* stream) {
  const GatherDirsArgs& a = *static_cast<const GatherDirsArgs*>(args);
  if (a.count <= 0) return 0;
  gather_dirs_kernel<<<blocks(a.count), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_resolve_launch(const void* args, void* stream) {
  const GatherResolveArgs& a = *static_cast<const GatherResolveArgs*>(args);
  if (a.n <= 0) return 0;
  gather_resolve_kernel<<<blocks(a.n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
