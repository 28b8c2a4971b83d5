// HDDA voxel traversal for Hopper (sm_90a): two kernels around one
// device function, traverse<MODE>, the port of _traverse_core.
//
// hdda_kernel replaces the TPU kernel dust_tpu/ops/pallas_trace.py::
// _make_scene_kernel (launched by _trace_pallas_scene, pallas_call at
// pallas_trace.py:1305). It computes what that kernel computes, lane for
// lane: per ray and per instance (in the caller's sweep order) the world
// ray goes to object space, is normalised, clipped to the model AABB and
// to the closest hit so far, marches the L1 skip field / L2 block bitmap
// to a candidate block, resolves the leaf row by popcount rank, runs the
// 4x4x4 micro DDA over the leaf mask and merges the closest hit. An
// instance whose clipped range is empty for the ray (s_min >= s_stop) is
// skipped, traversal and merge: the counterpart of the reference's
// per-tile cull gate, exact because traversal starts only if s_min <
// s_stop. Its plain PyTorch version is hdda_plain in ops/hdda.py.
//
// hdda_instance_kernel replaces the single-instance TPU kernel
// _make_kernel (launched by _trace_pallas, pallas_call at :1335, and
// _trace_pallas_ao_fg, pallas_call at :1397): traverse<MODE> alone on
// object-space rays with unit directions and s bounds the caller computed
// (no affine, no box clip, no normalisation, no merge; the loop route of
// the scene trace does those in PyTorch). Outputs are in s units. Its
// plain version is hdda_instance_plain in ops/hdda.py.
//
// What bounds the single-instance kernel: bytes on the loop route's
// mostly empty launches, the walk's latency on the rest. The loop route
// launches it over every ray of the frame once per instance, and only
// 0-7% of them (up to 94% in the surfel pass) have a non-empty range in
// the instance's box. Every ray must still have s_min and s_stop read and
// three outputs written, 20 bytes (0.0124 ms for a 1080p frame at 3.35
// TB/s); an active ray also reads its origin and direction. The design is
// the range test first: a thread reads s_min and s_stop, and a ray with
// s_min >= s_stop writes the miss outputs and ends there, so a warp of
// empty rays moves 20 bytes a ray, not 44. On the 1080p launches with
// under 1% of rays active that took 32-53% off, on the busiest 14-31%
// (PERF.md, section 6). The rays that walk keep one thread each in the
// caller's ray order, as in the scene kernel. Compacting them into full
// warps first (a queue filled by one ballot per warp, then a persistent
// grid; or inside each block) was measured slower: a launch's active rays
// lie together in the frame, so its warps were already mostly full or
// empty, and a busy launch lasts as long as its slowest block (57-63 of
// 60-64 us in precise), whose walks no schedule of whole rays shortens.
//
// Modes: PRECISE, AO_THRESHOLD, ROUGH, AO_FG (template parameter).
//
// Iteration caps are per ray, as they are per lane on the TPU: `rounds`
// rounds (64 in the scene kernel, the caller's in the instance kernel),
// MARCH_CAP march iterations per round (each one L1 step plus SUBSTEPS
// in-cell block steps), MICRO_CAP micro steps, and after the
// micro loop the voxel it stopped on is tested even if the cap stopped
// it there. Built with -fmad=false: the only fused multiply-adds are the
// explicit __fmaf_rn calls, placed where the reference's XLA build
// contracts them and mirrored in the plain version.
//
// What bounds the scene kernel on this card: latency, not bytes or FLOPs.
// A launch must move about 48 bytes per ray (56 in AO_FG) plus the 0.6 MB
// of tables, 0.030 ms at 3.35 TB/s, and does a few dozen float operations
// per step;
// each step needs a table word before it can choose the next one. Measured
// per ray on the 1080p frames (PERF.md, section 5): 69-97% of rays enter no
// instance, walks are 6-13 steps at the median and at most 30-303, warps
// keep 22-48% of their lanes busy, and the stress frame's sun-shadow
// (AO_FG) launch is one ray: it lies in a block face plane parallel to the
// sun, advances by the 1e-4 nudge per step, and walks two instances to
// the round cap (40,960 steps, 6.2 of the launch's 6.4 ms).
//
// The design, one thread per ray in the caller's ray order (the frame's
// 8x128-pixel tiles, so a warp walks neighbouring pixels), is chosen for
// that latency: every value a step reads is in a register. The micro DDA
// picks its axis by branches rather than by a run-time array index, so the
// ray and the walk state never go to local memory, where every step would
// load them again (no stack frame; keeping them in registers took 0-53%
// off the launch times). Tables stay in the 50 MB L2 and are
// read through the read-only path (__ldg); they need no shared memory and
// no size limit. Persistent warps that refill finished lanes from a ray
// queue were measured slower in most modes (their turn overhead and 95
// registers cost more than the idle lanes), and so was computing the
// block exit before the L1 word arrives (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-3f;      // micro-DDA exit epsilon
constexpr float kStepEps = 1e-4f;  // cell-sampling nudge
constexpr int kRounds = 64;
constexpr int kMarchCap = 160;
constexpr int kMicroCap = 12;
// Threads per block of the single-instance kernel.
constexpr int kInstanceThreads = 128;

enum Mode { PRECISE = 0, AO_THRESHOLD = 1, ROUGH = 2, AO_FG = 3 };

template <int MODE> struct Traits;
template <> struct Traits<PRECISE> { static constexpr int kSub = 3; static constexpr bool kCarry = true; };
template <> struct Traits<AO_THRESHOLD> { static constexpr int kSub = 1; static constexpr bool kCarry = false; };
template <> struct Traits<ROUGH> { static constexpr int kSub = 5; static constexpr bool kCarry = false; };
template <> struct Traits<AO_FG> { static constexpr int kSub = 2; static constexpr bool kCarry = true; };

struct Params {
  const int* l1;          // (M, 512) packed L1 nibbles
  const int4* l2;         // (M, 4096) [w0, w1, rank0, rank1]
  const int2* mask;       // (M, rows) [lo, hi]
  int rows;               // mask rows per model (CL * 1024)
  const int* inst_model;  // (I,) model slot per swept instance
  const int* inst_ids;    // (I,) output instance id per swept instance
  const float* aff;       // (I, 12) world -> object rows
  const float* aabb;      // (M, 6) min xyz, max xyz
  int n_inst;
  const float* origin;    // (N, 3)
  const float* dir;       // (N, 3)
  const float* t_min;     // (N,)
  const float* t_max;     // (N,)
  const float* t_ao;      // (N,) AO_FG only
  float* t0;              // t, or ao_t
  int* i0;                // inst, or ao_inst
  float* t1;              // fg_t (AO_FG)
  int* i1;                // fg_inst (AO_FG)
  int* row;               // row, or fg_row
  int* bit;               // bit (not AO_FG)
  int n;
};

struct InstanceParams {
  const int* l1;          // (512,) one model's packed L1 nibbles
  const int4* l2;         // (4096,) [w0, w1, rank0, rank1]
  const int2* mask;       // (rows,) [lo, hi]
  const float* origin;    // (N, 3) object space
  const float* dir;       // (N, 3) object space, unit
  const float* s_min;     // (N,)
  const float* s_stop;    // (N,)
  const float* s_ao;      // (N,) AO_FG only
  float* s0;              // hit_s, or ao_s
  float* s1;              // fg_s (AO_FG)
  int* row;               // row, or fg_row
  int* bit;               // bit (not AO_FG)
  int n;
  int rounds;
};

struct Ray {
  float o[3], d[3], r[3], p01[3];
  int sgn[3];
};

struct CoreOut {
  float s0;   // hit_s, or ao_s
  float s1;   // fg_s (AO_FG)
  int row;
  int bit;
};

__device__ __forceinline__ float safe_rcp(float v) {
  return fabsf(v) < 1e-20f ? (v < 0.0f ? -1e20f : 1e20f) : 1.0f / v;
}

__device__ __forceinline__ int floor_clamp(float x, float scale, int hi) {
  int v = (int)floorf(x * scale);
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool bit_set(int word, int b) {
  return ((static_cast<uint32_t>(word) >> (b & 31)) & 1u) != 0u;
}

__device__ __forceinline__ int popcount_below(int word, int b) {
  uint32_t m = (1u << (b & 31)) - 1u;
  return __popc(static_cast<uint32_t>(word) & m);
}

// Entry/exit of the box [lo, hi] along the ray.
__device__ __forceinline__ void slab3(const Ray& ray, const float lo[3],
                                      const float hi[3], float* t_in,
                                      float* t_out) {
  float a[3], b[3];
  for (int k = 0; k < 3; ++k) {
    a[k] = (lo[k] - ray.o[k]) * ray.r[k];
    b[k] = (hi[k] - ray.o[k]) * ray.r[k];
  }
  *t_in = fmaxf(fmaxf(fminf(a[0], b[0]), fminf(a[1], b[1])), fminf(a[2], b[2]));
  *t_out = fminf(fminf(fmaxf(a[0], b[0]), fmaxf(a[1], b[1])), fmaxf(a[2], b[2]));
}

// Reciprocals, exit-face offsets and step signs of a unit direction.
__device__ __forceinline__ void set_direction(Ray& ray) {
  for (int j = 0; j < 3; ++j) {
    ray.r[j] = safe_rcp(ray.d[j]);
    ray.p01[j] = ray.d[j] > 0.0f ? 1.0f : 0.0f;
    ray.sgn[j] = ray.d[j] > 0.0f ? 1 : -1;
  }
}

__device__ __forceinline__ void position(const Ray& ray, float s, float p[3]) {
  for (int k = 0; k < 3; ++k) p[k] = __fmaf_rn(ray.d[k], s, ray.o[k]);
}

__device__ __forceinline__ void block_slab(const Ray& ray, const int cb[3],
                                           float* t_in, float* t_out) {
  float lo[3], hi[3];
  for (int k = 0; k < 3; ++k) {
    lo[k] = cb[k] * 4.0f;
    hi[k] = lo[k] + 4.0f;
  }
  slab3(ray, lo, hi, t_in, t_out);
}

// Candidate block of a frozen march sample: L2 word, word index, bit in
// word, block coordinates.
__device__ __forceinline__ void cand_info(const Ray& ray, float s, int w0, int w1,
                                          int* word, int* widx, int* wbit,
                                          int cb[3]) {
  float p[3];
  position(ray, s + kStepEps, p);
  int c1[3];
  for (int k = 0; k < 3; ++k) {
    c1[k] = floor_clamp(p[k], 1.0f / 16.0f, 15);
    cb[k] = floor_clamp(p[k], 0.25f, 63);
  }
  int cl = (c1[0] * 16 + c1[1]) * 16 + c1[2];
  int local = ((cb[0] & 3) << 4) | ((cb[1] & 3) << 2) | (cb[2] & 3);
  *word = local < 32 ? w0 : w1;
  *widx = cl * 2 + (local >> 5);
  *wbit = local & 31;
}

// 4x4x4 Amanatides-Woo walk of one candidate block. Freezes on the first
// occupied voxel; after MICRO_CAP steps, or on leaving the block, the voxel
// it stands on is tested. Returns whether that voxel is occupied.
__device__ __forceinline__ bool micro_walk(const Ray& ray, int2 mk, float s,
                                           float s_min, const int cb[3],
                                           float blk_out, float* s_f,
                                           int* bit_f) {
  float s_m = fmaxf(s, s_min);
  float pm[3];
  position(ray, s_m, pm);
  int m[3];
  float tm[3];
  for (int k = 0; k < 3; ++k) {
    m[k] = clampi((int)floorf(pm[k]), cb[k] * 4, cb[k] * 4 + 3);
    tm[k] = fabsf(ray.d[k]) < 1e-20f
                ? 1e30f
                : ((float)m[k] + ray.p01[k] - ray.o[k]) * ray.r[k];
  }
  for (int it = 0; it < kMicroCap; ++it) {
    int b = ((m[0] & 3) << 4) | ((m[1] & 3) << 2) | (m[2] & 3);
    bool occ = b < 32 ? bit_set(mk.x, b) : bit_set(mk.y, b - 32);
    if (occ) break;
    float s_next = fminf(fminf(tm[0], tm[1]), tm[2]);
    if (s_next + kEps >= blk_out) break;
    // The axis by explicit branches, so that no array is indexed at run
    // time and the ray and the walk stay in registers.
    if (tm[0] <= tm[1] && tm[0] <= tm[2]) {
      m[0] += ray.sgn[0];
      tm[0] = tm[0] + fabsf(ray.r[0]);
    } else if (tm[1] <= tm[2]) {
      m[1] += ray.sgn[1];
      tm[1] = tm[1] + fabsf(ray.r[1]);
    } else {
      m[2] += ray.sgn[2];
      tm[2] = tm[2] + fabsf(ray.r[2]);
    }
    s_m = s_next;
  }
  int b = ((m[0] & 3) << 4) | ((m[1] & 3) << 2) | (m[2] & 3);
  *s_f = s_m;
  *bit_f = b;
  return b < 32 ? bit_set(mk.x, b) : bit_set(mk.y, b - 32);
}

// One instance's traversal of one ray (object space, unit direction).
template <int MODE>
__device__ CoreOut traverse(const Ray& ray, const int* __restrict__ l1,
                            const int4* __restrict__ l2,
                            const int2* __restrict__ mask, float s_min,
                            float s_stop, float s_ao, int rounds) {
  constexpr bool kCarry = Traits<MODE>::kCarry;
  const float inf = __int_as_float(0x7f800000);
  const float box_lo[3] = {0.0f, 0.0f, 0.0f};
  const float box_hi[3] = {256.0f, 256.0f, 256.0f};
  float g0, g1;
  slab3(ray, box_lo, box_hi, &g0, &g1);
  const float s_end = fminf(g1, s_stop);
  float s = fmaxf(g0 + kStepEps, s_min);
  bool active = (g0 < g1) && (s < s_end);

  CoreOut out = {inf, inf, -1, -1};
  int hit_word = 0;
  int w0 = 0, w1 = 0, rr0 = 0, rr1 = 0, reg_cl = -1;

  for (int rnd = 0; rnd < rounds && active; ++rnd) {
    if (!kCarry) {
      w0 = 0;
      w1 = 0;
      reg_cl = -1;
    }
    // ---- march to a candidate block --------------------------------
    bool cand = false;
    for (int it = 0; it < kMarchCap && active && !cand; ++it) {
      float se = s + kStepEps;
      float p[3];
      position(ray, se, p);
      int c1[3], bb[3];
      for (int k = 0; k < 3; ++k) {
        c1[k] = floor_clamp(p[k], 1.0f / 16.0f, 15);
        bb[k] = floor_clamp(p[k], 0.25f, 63);
      }
      bool inb = se < s_end;
      int cl = (c1[0] * 16 + c1[1]) * 16 + c1[2];
      int dist = (__ldg(l1 + (cl >> 3)) >> ((cl & 7) * 4)) & 15;
      bool occ1 = dist == 0 && inb;
      if (occ1 && cl != reg_cl) {
        int4 w = __ldg(l2 + cl);
        w0 = w.x;
        w1 = w.y;
        if (kCarry) {
          rr0 = w.z;
          rr1 = w.w;
        }
        reg_cl = cl;
      }
      int local = ((bb[0] & 3) << 4) | ((bb[1] & 3) << 2) | (bb[2] & 3);
      if (occ1 && bit_set(local < 32 ? w0 : w1, local & 31)) {
        cand = true;
        break;
      }
      // Occupied cell: one block; empty cell at distance d: leave the
      // (2d-1)^3 empty box. Only the exit plane of each axis matters.
      float df = (float)(dist > 1 ? dist : 1);
      float wsize = occ1 ? 4.0f : (2.0f * df - 1.0f) * 16.0f;
      float e[3];
      for (int k = 0; k < 3; ++k) {
        float f = occ1 ? bb[k] * 4.0f : ((float)c1[k] - (df - 1.0f)) * 16.0f;
        e[k] = fabsf((f + ray.p01[k] * wsize - ray.o[k]) * ray.r[k]);
      }
      s = fmaxf(fminf(fminf(e[0], e[1]), e[2]), s + kStepEps);
      if (s >= s_end) {
        active = false;
        break;
      }
      // In-cell block sub-steps while the next sample stays in the cell
      // whose words are loaded.
      for (int ss = 0; ss < Traits<MODE>::kSub; ++ss) {
        float se2 = s + kStepEps;
        float q[3];
        position(ray, se2, q);
        int b2[3];
        for (int k = 0; k < 3; ++k) b2[k] = floor_clamp(q[k], 0.25f, 63);
        int cl2 = ((b2[0] >> 2) * 16 + (b2[1] >> 2)) * 16 + (b2[2] >> 2);
        if (cl2 != reg_cl || !(se2 < s_end)) break;
        int local2 = ((b2[0] & 3) << 4) | ((b2[1] & 3) << 2) | (b2[2] & 3);
        if (bit_set(local2 < 32 ? w0 : w1, local2 & 31)) {
          cand = true;
          break;
        }
        float e2[3];
        for (int k = 0; k < 3; ++k)
          e2[k] = fabsf((b2[k] * 4.0f + ray.p01[k] * 4.0f - ray.o[k]) * ray.r[k]);
        s = fmaxf(fminf(fminf(e2[0], e2[1]), e2[2]), s + kStepEps);
        if (s >= s_end) {
          active = false;
          break;
        }
      }
    }
    if (!cand) continue;  // dead, or the march cap: next round resumes

    int cword, cwidx, cbit, cb[3];
    cand_info(ray, s, w0, w1, &cword, &cwidx, &cbit, cb);
    float blk_in, blk_out;
    block_slab(ray, cb, &blk_in, &blk_out);

    if (MODE == ROUGH) {
      // Hit at the block entry; the leaf row resolves after the loop.
      if (blk_in >= s_min && blk_in <= s_end) {
        out.s0 = fmaxf(blk_in, 0.0f);
        out.row = cwidx;
        out.bit = cbit;
        hit_word = cword;
        active = false;
      } else {
        s = fmaxf(blk_out, s + kStepEps);
        active = s < s_end;
      }
      continue;
    }

    int rank;
    if (kCarry) {
      rank = (cwidx & 1) == 0 ? rr0 : rr1;
    } else {
      int4 w = __ldg(l2 + (cwidx >> 1));
      rank = (cwidx & 1) == 0 ? w.z : w.w;
    }
    const int row = rank + popcount_below(cword, cbit);

    if (MODE == AO_FG) {
      // 1. threshold inside the block: AO entry report, done.
      if (s <= s_ao && s_ao <= blk_out) {
        out.s0 = s;
        active = false;
        continue;
      }
      // 3. block past the threshold: rough final-gather hit, or skip it.
      if (s > s_ao) {
        if (blk_in >= s_ao && blk_in <= s_end) {
          out.s1 = fmaxf(blk_in, 0.0f);
          out.row = row;
          active = false;
        } else {
          s = fmaxf(blk_out, s + kStepEps);
          active = s < s_end;
        }
        continue;
      }
      if (!(s < s_end)) {
        active = false;
        continue;
      }
      // 2. block below the threshold: micro DDA, a voxel hit is AO.
      int2 mk = __ldg(mask + row);
      float s_f;
      int bit_f;
      if (micro_walk(ray, mk, s, s_min, cb, blk_out, &s_f, &bit_f)) {
        out.s0 = s_f;
        active = false;
      } else {
        s = fmaxf(blk_out, s + kStepEps);
        active = s < s_end;
      }
      continue;
    }

    if (MODE == AO_THRESHOLD) {
      // Entry report when the committed tmax lies inside the block.
      if (s <= s_ao && s_ao <= blk_out && s <= s_end) {
        out.s0 = s;
        out.row = row;
        out.bit = 255;
        active = false;
        continue;
      }
    }
    int2 mk = __ldg(mask + row);
    float s_f;
    int bit_f;
    if (micro_walk(ray, mk, s, s_min, cb, blk_out, &s_f, &bit_f)) {
      if (s_f <= s_end) {  // past the range: done without a hit
        out.s0 = s_f;
        out.row = row;
        out.bit = bit_f;
      }
      active = false;
      continue;
    }
    s = fmaxf(blk_out, s + kStepEps);
    active = s < s_end;
  }

  if (MODE == ROUGH) {
    if (out.row >= 0) {
      int4 w = __ldg(l2 + (out.row >> 1));
      int rank = (out.row & 1) == 0 ? w.z : w.w;
      out.row = rank + popcount_below(hit_word, out.bit);
    }
    out.bit = -1;
  }
  return out;
}

template <int MODE>
__device__ void trace_ray(const Params& p, int i) {
  const float inf = __int_as_float(0x7f800000);
  const float ow[3] = {p.origin[3 * i], p.origin[3 * i + 1], p.origin[3 * i + 2]};
  const float dw[3] = {p.dir[3 * i], p.dir[3 * i + 1], p.dir[3 * i + 2]};
  const float tn = p.t_min[i];
  const float tx0 = p.t_max[i];
  const float ta = MODE == AO_FG ? p.t_ao[i] : 0.0f;

  float best_t = inf, fg_t = inf;
  int best_i = -1, best_row = -1, best_bit = -1, fg_i = -1;
  for (int k = 0; k < p.n_inst; ++k) {
    const int m = __ldg(p.inst_model + k);
    const int oid = __ldg(p.inst_ids + k);
    float a[12];
    for (int j = 0; j < 12; ++j) a[j] = __ldg(p.aff + 12 * k + j);
    Ray ray;
    float dv[3];
    for (int j = 0; j < 3; ++j) {
      const float* r = a + 4 * j;
      ray.o[j] = __fmaf_rn(r[2], ow[2], __fmaf_rn(r[0], ow[0], r[1] * ow[1])) + r[3];
      dv[j] = __fmaf_rn(r[2], dw[2], __fmaf_rn(r[0], dw[0], r[1] * dw[1]));
    }
    const float dlen = fmaxf(
        sqrtf(__fmaf_rn(dv[2], dv[2], __fmaf_rn(dv[0], dv[0], dv[1] * dv[1]))), 1e-20f);
    const float inv = 1.0f / dlen;
    for (int j = 0; j < 3; ++j) ray.d[j] = dv[j] * inv;
    set_direction(ray);
    // Closest-so-far cap; in AO_FG the far accumulator bounds the walk.
    const float tx = fminf(tx0, MODE == AO_FG ? fg_t : best_t);
    float box_lo[3], box_hi[3];
    for (int j = 0; j < 3; ++j) {
      box_lo[j] = __ldg(p.aabb + 6 * m + j);
      box_hi[j] = __ldg(p.aabb + 6 * m + 3 + j);
    }
    float lo, hi;
    slab3(ray, box_lo, box_hi, &lo, &hi);
    const float s_min = fmaxf(tn * dlen, lo);
    const float s_stop = fminf(tx * dlen, hi);
    // Empty range: no traversal, nothing to merge (the cull gate).
    if (s_min >= s_stop) continue;
    // AO_THRESHOLD's quirk plane is the committed tmax, never box-clipped.
    const float s_ao = MODE == AO_FG ? ta * dlen : tx * dlen;
    CoreOut c = traverse<MODE>(ray, p.l1 + 512 * m, p.l2 + 4096 * m,
                               p.mask + (size_t)p.rows * m, s_min, s_stop, s_ao,
                               kRounds);
    if (MODE == AO_FG) {
      const float ao_new = c.s0 * inv;
      const float fg_new = c.s1 * inv;
      if (ao_new < best_t) {
        best_t = ao_new;
        best_i = oid;
      }
      if (fg_new < fg_t) {
        fg_t = fg_new;
        fg_i = oid;
        best_row = c.row;
      }
    } else {
      const float t_new = c.s0 * inv;
      if (t_new < best_t) {
        best_t = t_new;
        best_i = oid;
        best_row = c.row;
        best_bit = c.bit;
      }
    }
  }
  p.t0[i] = best_t;
  p.i0[i] = best_i;
  p.row[i] = best_row;
  if (MODE == AO_FG) {
    p.t1[i] = fg_t;
    p.i1[i] = fg_i;
  } else {
    p.bit[i] = best_bit;
  }
}

// ---- kernel and launch ------------------------------------------------------

template <int MODE>
__global__ void __launch_bounds__(128) hdda_kernel(Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n) trace_ray<MODE>(p, i);
}

// The single-instance kernel: the range test first. A ray with s_min >=
// s_stop cannot walk (traverse starts at s >= s_min and stops at s_stop), so
// it gets the miss outputs without its origin and direction being read; a
// NaN bound fails the test and walks, as it would have.
template <int MODE>
__global__ void __launch_bounds__(kInstanceThreads) hdda_instance_kernel(
    InstanceParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const float s_min = p.s_min[i];
  const float s_stop = p.s_stop[i];
  if (s_min >= s_stop) {  // traverse's outputs for an empty range
    p.s0[i] = __int_as_float(0x7f800000);
    p.row[i] = -1;
    if (MODE == AO_FG) {
      p.s1[i] = __int_as_float(0x7f800000);
    } else {
      p.bit[i] = -1;
    }
    return;
  }
  Ray ray;
  for (int j = 0; j < 3; ++j) {
    ray.o[j] = p.origin[3 * i + j];
    ray.d[j] = p.dir[3 * i + j];
  }
  set_direction(ray);
  // AO_THRESHOLD's quirk plane is s_stop itself on this route (the caller
  // keeps s_stop at the committed tmax); AO_FG takes s_ao as given.
  const float s_ao = MODE == AO_FG ? p.s_ao[i] : s_stop;
  const CoreOut c = traverse<MODE>(ray, p.l1, p.l2, p.mask, s_min, s_stop,
                                   s_ao, p.rounds);
  p.s0[i] = c.s0;
  p.row[i] = c.row;
  if (MODE == AO_FG) {
    p.s1[i] = c.s1;
  } else {
    p.bit[i] = c.bit;
  }
}

}  // namespace

extern "C" int hdda_launch(int mode, const void* l1, const void* l2,
                           const void* mask, int n_models, int rows,
                           const void* inst_model, const void* inst_ids,
                           const void* aff, const void* aabb, int n_inst,
                           const void* origin, const void* dir,
                           const void* t_min, const void* t_max,
                           const void* t_ao, void* t0, void* i0, void* t1,
                           void* i1, void* row, void* bit, int n,
                           void* stream) {
  (void)n_models;
  Params p;
  p.l1 = static_cast<const int*>(l1);
  p.l2 = static_cast<const int4*>(l2);
  p.mask = static_cast<const int2*>(mask);
  p.rows = rows;
  p.inst_model = static_cast<const int*>(inst_model);
  p.inst_ids = static_cast<const int*>(inst_ids);
  p.aff = static_cast<const float*>(aff);
  p.aabb = static_cast<const float*>(aabb);
  p.n_inst = n_inst;
  p.origin = static_cast<const float*>(origin);
  p.dir = static_cast<const float*>(dir);
  p.t_min = static_cast<const float*>(t_min);
  p.t_max = static_cast<const float*>(t_max);
  p.t_ao = static_cast<const float*>(t_ao);
  p.t0 = static_cast<float*>(t0);
  p.i0 = static_cast<int*>(i0);
  p.t1 = static_cast<float*>(t1);
  p.i1 = static_cast<int*>(i1);
  p.row = static_cast<int*>(row);
  p.bit = static_cast<int*>(bit);
  p.n = n;
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case PRECISE: hdda_kernel<PRECISE><<<blocks, threads, 0, s>>>(p); break;
    case AO_THRESHOLD: hdda_kernel<AO_THRESHOLD><<<blocks, threads, 0, s>>>(p); break;
    case ROUGH: hdda_kernel<ROUGH><<<blocks, threads, 0, s>>>(p); break;
    case AO_FG: hdda_kernel<AO_FG><<<blocks, threads, 0, s>>>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hdda_instance_launch(int mode, const void* l1, const void* l2,
                                    const void* mask, const void* origin,
                                    const void* dir, const void* s_min,
                                    const void* s_stop, const void* s_ao,
                                    void* s0, void* s1, void* row, void* bit,
                                    int n, int rounds, void* stream) {
  InstanceParams p;
  p.l1 = static_cast<const int*>(l1);
  p.l2 = static_cast<const int4*>(l2);
  p.mask = static_cast<const int2*>(mask);
  p.origin = static_cast<const float*>(origin);
  p.dir = static_cast<const float*>(dir);
  p.s_min = static_cast<const float*>(s_min);
  p.s_stop = static_cast<const float*>(s_stop);
  p.s_ao = static_cast<const float*>(s_ao);
  p.s0 = static_cast<float*>(s0);
  p.s1 = static_cast<float*>(s1);
  p.row = static_cast<int*>(row);
  p.bit = static_cast<int*>(bit);
  p.n = n;
  p.rounds = rounds;
  if (n <= 0) return 0;
  const int threads = kInstanceThreads;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case PRECISE: hdda_instance_kernel<PRECISE><<<blocks, threads, 0, s>>>(p); break;
    case AO_THRESHOLD: hdda_instance_kernel<AO_THRESHOLD><<<blocks, threads, 0, s>>>(p); break;
    case ROUGH: hdda_instance_kernel<ROUGH><<<blocks, threads, 0, s>>>(p); break;
    case AO_FG: hdda_instance_kernel<AO_FG><<<blocks, threads, 0, s>>>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
