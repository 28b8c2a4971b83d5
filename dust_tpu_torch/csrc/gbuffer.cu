// The primary stage's G-buffer for Hopper (sm_90a): two kernels around the
// primary trace, each one thread per ray.
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
// They replace no TPU kernel: the reference computes this stage with XLA
// ops (dust_tpu/render/pipeline.py step 1, dust_tpu/ops/shade.py
// resolve_hits). Here they take the place of some 570 PyTorch ops a frame
// (camera rays, tiling, resolve_hits, sky): 38 ms of card time at 3840x2160.
//
// Bits. Both kernels are held torch.equal to their plain versions run as
// PyTorch ops on the card, so each line below repeats one PyTorch CUDA op:
// one float32 rounding per op, no contraction (built with -fmad=false);
// ops/fp.py's fma as (float)((double)a * (double)b + (double)c); a tensor
// divided by a Python number as PyTorch's CUDA kernel computes it, times the
// reciprocal rounded to float32 (inv_w, inv_h, inv_255, inv_pi); the
// sum over a 3-vector in the order of PyTorch's CUDA reduction, (x + z) + y;
// the sky model past the arccos rounded to bfloat16 after every op, with
// the libdevice functions PyTorch's kernels call (expf, acosf, sqrtf, sinf).
//
// What bounds them: bytes. The resolve must read the trace result (16 B a
// ray), the ray (24 B) and one random voxel word (a 32-byte sector), and
// write the G-buffer (hit 1 B; inst, voxel_id, palette_idx 8 B each; depth
// 4 B; albedo 16 B; normal, motion, world_pos 12 B each) and sky_out (12 B):
// 165 B a ray. The rays kernel writes 24 B a ray. Neither kernel's name
// holds "hdda": the benchmark counts those kernels as the traversal.

#include <cuda_bf16.h>
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
  // The sky (sky.SkyModelState); sky_configs null: no sky_out.
  const float* sky_configs;      // (3, 9)
  const float* sky_radiances;    // (3,)
  const float* sky_ld;           // (3, 6)
  const float* sun_dir;          // (3,)
  const float* solar_intensity;  // (3,)
  const float* solar_radius;     // ()
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
  float xyz_to_acescg[9];
  float inv_255;
  float inv_pi;  // 1 / 3.14
  long long va_rows;
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

// ---- primary rays ----------------------------------------------------------

__global__ void __launch_bounds__(kThreads) primary_rays_kernel(RaysArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.count) return;
  const long long r = a.lo + i;
  long long x, y;
  if (a.tiled) {  // r = ((tx * H/8 + ty) * 8 + iy) * 128 + ix
    const long long ix = r % 128, q = r / 128;
    const long long iy = q % 8, tile = q / 8;
    const long long rows = a.height / 8;
    x = (tile / rows) * 128 + ix;
    y = (tile % rows) * 8 + iy;
  } else {
    x = r % a.width;
    y = r / a.width;
  }
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

// ---- G-buffer resolve ------------------------------------------------------

// sky.sky_radiance of a normalised direction d (ACEScg).
__device__ void sky_radiance(const ResolveArgs& a, const float d[3],
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
    for (int k = 0; k < 9; ++k) c[k] = bf(a.sky_configs[9 * ch + k]);
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
    xyz[ch] = bf(f * h) * a.sky_radiances[ch] * 683.0f;
  }
  mat3(a.xyz_to_acescg, xyz, out);
  if (!(s[1] > 0.0f)) out[0] = out[1] = out[2] = 0.0f;
}

// sky.sun_radiance of a normalised direction d (ACEScg).
__device__ void sun_radiance(const ResolveArgs& a, const float d[3],
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
    const float* ld = a.sky_ld + 6 * ch;
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
  float rel[3], mag[3];
  for (int k = 0; k < 3; ++k) {
    const float p_in = fma64(d_obj[k] / dlen, static_cast<float>(0.05),
                             hit_obj[k]);
    const long long vhat = static_cast<long long>(floorf(p_in));
    const long long leaf = ((vhat - off[k] + 2) >> 2) << 2;
    const float center =
        (static_cast<float>(leaf) + static_cast<float>(off[k])) + 0.5f;
    rel[k] = hit_obj[k] - center;
    mag[k] = fabsf(rel[k]);
  }
  // packing.cubed_normalize: amax propagates NaN.
  const float top = (isnan(mag[0]) || isnan(mag[1]) || isnan(mag[2]))
                        ? NAN
                        : fmaxf(fmaxf(mag[0], mag[1]), mag[2]);
  float n_obj[3], n_w[3];
  for (int k = 0; k < 3; ++k)
    n_obj[k] = sign(rel[k]) * static_cast<float>(mag[k] >= top);
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

  if (a.sky_configs == nullptr) return;
  const float len = norm3(d[0], d[1], d[2]);
  const float dn[3] = {d[0] / len, d[1] / len, d[2] / len};
  float sky[3], sun[3];
  sky_radiance(a, dn, sky);
  sun_radiance(a, dn, sun);
  for (int k = 0; k < 3; ++k)
    a.sky_out[3 * i + k] = (sky[k] + sun[k]) * a.inv_pi;
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
