// The spatial-hash GI cache's working-set probe and batched insert for
// Hopper (sm_90a).
//
// The table is one (capacity / 4, 16) int32 array of 64-byte probe-group
// rows, four slots of [fingerprint, LogLuv radiance, last frame, sample
// count] each (ops/spatial_hash.py). Kernels, in the order a frame runs
// them:
//
// spatial_hash_probe_kernel, one thread per working-set key (row = face *
// cells + cell): the key of the cell's centre, its one group-row read, the
// three-probe match, the LogLuv decode, and the dense-cache row that
// gi_cache.pack_working_set_rows packs from it. Plain version:
// spatial_hash.probe_working_set_plain (hash_get and the packing).
//
// The insert (plain version: spatial_hash.hash_insert_plain):
// * spatial_hash_keys_kernel, one thread per key: its fingerprint and its
//   group, or the group count for a key that is not valid (the sort key);
// * the stable sort by that key stays torch.sort (any stable sort gives the
//   same order);
// * the runs' suffix sums, _segmented_suffix_sums, in three launches that
//   keep _scan's pairing tree. That tree sums aligned power-of-two blocks
//   of the reversed array by a perfect binary tree, and the prefix ending
//   at p - 1 is the fold, from the highest set bit of p to the lowest, of
//   the block of each set bit. So spatial_hash_scan_up_kernel sums each
//   1024-key block's tree in shared memory, spatial_hash_scan_blocks_kernel
//   folds the blocks' totals by the same tree, and spatial_hash_scan_kernel
//   folds each key's prefix from its block's fold and its block's own tree:
//   the same float32 additions in the same order. The same launches count
//   the applied rows before each key, for the max_updates cut;
// * spatial_hash_apply_kernel, one thread per sorted key that applies (the
//   first run of its group): the probe or LRU choice, the running mean, the
//   LogLuv encode, the cut in sorted order, and the new row written into the
//   copy of the table (the whole-table copy stays a torch copy).
//
// spatial_hash_logluv_kernel encodes or decodes LogLuv words alone; the
// frame never calls it: the tests and chip_smoke.py do, to hold the codec
// the probe and the apply share to packing.py on every 32-bit word.
//
// Bits. Every kernel is held torch.equal to its plain version run as
// PyTorch ops on the card, so each line repeats one PyTorch CUDA op: one
// float32 rounding per op, no contraction (built with -fmad=false);
// ops/fp.py's fma as (float)((double)a * (double)b + (double)c); a tensor
// divided by a Python number as times the float32-rounded reciprocal
// (inv_cell, inv_ln2); clamp as fmaxf / fminf that pass NaN on; float to
// integer conversions truncating; the libdevice expf and logf that
// PyTorch's exp and log kernels call. The unsigned 32-bit hashes that the
// plain version runs in int64 masked to 32 bits are uint32 arithmetic here.
// The LogLuv constants are handed in from packing.py, so both sides use the
// same ones.
//
// What bounds them: bytes. A probed key reads its group row (64 B) and its
// cell's centre and validity and writes its 12-byte row; an inserted key
// reads its key (16 B), its value (12 B) and its validity (1 B). No kernel's
// name holds "hdda": the benchmark counts those kernels as the traversal.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The LogLuv constants of ops/packing.py (float32 values).
struct LogLuv {
  float acescg_to_xyz[9];  // row-major
  float xyz_to_acescg[9];
  float inv_409_6;  // packing._INV_409_6
  float ln2;        // packing._LN2
  float inv_ln2;    // 1 / ln2 rounded to float32 (the division by _LN2)
  float u4, u6, u9, u16;  // packing._U_SCALE
};

// The launch arguments (ops/spatial_hash.py builds them with ctypes and
// hands the launch functions a pointer).

struct ProbeArgs {
  const int* table;                  // (ngroups, 16)
  const float* centers;              // (cells, 3) world-space leaf centres
  const unsigned char* valid_cells;  // (cells,)
  const int* albedo;                 // (rows,), or null: keep out's column 2
  int* out;                          // (rows, 3) working-set rows
  long long cells;
  long long lo;  // the rows [lo, hi) are probed
  long long hi;
  long long ngroups;
  float inv_cell;  // 1 / cell_size in float32
  LogLuv luv;
};

struct InsertArgs {
  const int* table;            // (ngroups, 16), read
  int* out;                    // (ngroups, 16), the copy written
  const int* qpos;             // (n, 3)
  const int* face;             // (n,)
  const unsigned char* valid;  // (n,), or null: every key
  const float* value;          // (n, 3)
  int* gkey;                   // (n,) group, or ngroups if not valid
  int* fp;                     // (n,) fingerprint bits
  const int* s_gkey;           // (n,) gkey sorted
  const long long* order;      // (n,) the stable sort's permutation
  float4* tree_v;              // (2 * nfull,) block totals, then their tree
  unsigned char* tree_f;       // (2 * nfull,)
  float4* block_fold;          // (nfull,) each block prefix's fold
  int* block_count;            // (nblocks,) applied keys in each block
  int* block_before;           // (nblocks,) applied keys in earlier blocks
  int* applied;                // (1,) applied keys in all
  float4* sums;                // (n,) each sorted key's run suffix sum
  int* rank;                   // (n,) applied keys at or before the key
  long long n;
  long long ngroups;
  long long cap;  // max_updates, or -1 for none
  int frame_index;
  LogLuv luv;
};

struct LogLuvArgs {
  const int* words;  // (n,) decode: words -> rgb
  float* rgb;        // (n, 3)
  int* out_words;    // (n,) encode: rgb -> out_words (words null)
  long long n;
  LogLuv luv;
};

namespace {

constexpr int kThreads = 256;
constexpr int kScanLog = 10;
constexpr int kScanBlock = 1 << kScanLog;       // keys a scan block
constexpr int kScanThreads = kScanBlock / 2;    // two keys a thread
constexpr int kBlocksThreads = 1024;
constexpr float kMaxSampleCount = 404.0f;

// ---- float32 ops as PyTorch's CUDA kernels round them ----------------

__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ unsigned f16_bits(float x) {
  return __half_as_ushort(__float2half_rn(x));
}

// ---- hashing (spatial_hash.glsl, uint32) ------------------------------

__device__ __forceinline__ uint32_t pcg(uint32_t v) {
  const uint32_t state = v * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ uint32_t xxhash32(uint32_t p) {
  uint32_t h = p + 374761393u;
  h = ((h << 17) | (h >> 15)) * 668265263u;
  h = (h ^ (h >> 15)) * 2246822519u;
  h = (h ^ (h >> 13)) * 3266489917u;
  return h ^ (h >> 16);
}

// key_fingerprint and key_location >> 2 of (q0, q1, q2, face).
__device__ __forceinline__ void hash_key(int q0, int q1, int q2, int face,
                                         long long ngroups, uint32_t* fp,
                                         uint32_t* group) {
  uint32_t h = xxhash32(static_cast<uint32_t>(q0));
  h = xxhash32(static_cast<uint32_t>(q1) + h);
  h = xxhash32(static_cast<uint32_t>(q2) + h);
  h = xxhash32(static_cast<uint32_t>(face) + h);
  *fp = h > 1u ? h : 1u;
  uint32_t l = pcg(static_cast<uint32_t>(q0));
  l = pcg(static_cast<uint32_t>(q1) + l);
  l = pcg(static_cast<uint32_t>(q2) + l);
  l = pcg(static_cast<uint32_t>(face) + l);
  *group = static_cast<uint32_t>(l % static_cast<uint64_t>(ngroups));
}

// ---- LogLuv (packing.encode_logluv / decode_logluv) -------------------

__device__ void decode_logluv(uint32_t packed, const LogLuv& c,
                              float rgb[3]) {
  const uint32_t le = packed >> 18;
  const float y = expf(
      fma64(static_cast<float>(le) + 0.5f, c.inv_409_6, -20.0f) * c.ln2);
  const float ua = static_cast<float>((packed >> 9) & 0x1FFu) + 0.5f;
  const float va = static_cast<float>(packed & 0x1FFu) + 0.5f;
  const float inv_denom = 1.0f / (fma64(ua, c.u6, -(va * c.u16)) + 12.0f);
  const float x_c = (ua * c.u9) * inv_denom;
  const float y_c = (va * c.u4) * inv_denom;
  const float s = y / clamp_min(y_c, static_cast<float>(1e-9));
  const float big_x = s * x_c;
  const float big_z = s * ((1.0f - x_c) - y_c);
  const float* m = c.xyz_to_acescg;
  for (int i = 0; i < 3; ++i) {
    const float v =
        fma64(big_z, m[3 * i + 2], fma64(big_x, m[3 * i], y * m[3 * i + 1]));
    rgb[i] = le == 0 ? 0.0f : clamp_min(v, 0.0f);
  }
}

__device__ uint32_t encode_logluv(const float rgb[3], const LogLuv& c) {
  const float* m = c.acescg_to_xyz;
  float xyz[3];
  for (int i = 0; i < 3; ++i)
    xyz[i] = fma64(rgb[2], m[3 * i + 2],
                   fma64(rgb[1], m[3 * i + 1], rgb[0] * m[3 * i]));
  const float x = xyz[0], y = xyz[1], z = xyz[2];
  const float log_y =
      static_cast<float>(409.6) *
      (logf(clamp_min(y, static_cast<float>(1e-30))) * c.inv_ln2 + 20.0f);
  const long long le = static_cast<long long>(clamp(log_y, 0.0f, 16383.0f));
  const float denom = fma64(3.0f, (x + y) + z, fma64(12.0f, y, -2.0f * x));
  const float inv_denom = 1.0f / clamp_min(denom, static_cast<float>(1e-30));
  const long long ue = static_cast<long long>(
      clamp(820.0f * ((4.0f * x) * inv_denom), 0.0f, 511.0f));
  const long long ve = static_cast<long long>(
      clamp(820.0f * ((9.0f * y) * inv_denom), 0.0f, 511.0f));
  const long long packed = (le << 18) | (ue << 9) | ve;
  return le == 0 ? 0u : static_cast<uint32_t>(packed);
}

// One 64-byte group row.
struct Row {
  int w[16];
};

__device__ __forceinline__ Row load_row(const int* table, long long group) {
  const int4* p = reinterpret_cast<const int4*>(table + 16 * group);
  Row r;
  for (int k = 0; k < 4; ++k) {
    const int4 q = p[k];
    r.w[4 * k] = q.x;
    r.w[4 * k + 1] = q.y;
    r.w[4 * k + 2] = q.z;
    r.w[4 * k + 3] = q.w;
  }
  return r;
}

// ---- the working-set probe --------------------------------------------

__global__ void __launch_bounds__(kThreads)
    spatial_hash_probe_kernel(const ProbeArgs a) {
  const long long r =
      a.lo + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.hi) return;
  const long long cell = r % a.cells;
  const int face = static_cast<int>(r / a.cells);
  int q[3];
  for (int k = 0; k < 3; ++k)
    q[k] = static_cast<int>(truncf(a.centers[3 * cell + k] * a.inv_cell));
  uint32_t fp, group;
  hash_key(q[0], q[1], q[2], face, a.ngroups, &fp, &group);
  const Row g = load_row(a.table, group);
  const uint32_t f0 = static_cast<uint32_t>(g.w[0]);
  const uint32_t f1 = static_cast<uint32_t>(g.w[4]);
  const uint32_t f2 = static_cast<uint32_t>(g.w[8]);
  // Probe i is reached only past occupied non-matches.
  const bool me0 = f0 == fp || f0 == 0u;
  const bool me1 = f1 == fp || f1 == 0u;
  const bool hit0 = f0 == fp;
  const bool hit1 = f1 == fp && !me0;
  const bool hit2 = f2 == fp && !me0 && !me1;
  const bool found = hit0 || hit1 || hit2;
  // The probe's slot, its words picked by value (no indexed row, which
  // would live in local memory).
  const int rad_word = hit0 ? g.w[1] : (hit1 ? g.w[5] : g.w[9]);
  const int count_word = hit0 ? g.w[3] : (hit1 ? g.w[7] : g.w[11]);
  float rgb[3];
  decode_logluv(static_cast<uint32_t>(rad_word), a.luv, rgb);
  const int count = found && a.valid_cells[cell] ? count_word : 0;
  const long long cnt = count < 0 ? 0 : (count > 404 ? 404 : count);
  const unsigned w0 = f16_bits(found ? rgb[0] : 0.0f) |
                      (f16_bits(found ? rgb[1] : 0.0f) << 16);
  const long long w1 =
      static_cast<long long>(f16_bits(found ? rgb[2] : 0.0f)) | (cnt << 16);
  a.out[3 * r] = static_cast<int>(w0);
  a.out[3 * r + 1] = static_cast<int>(static_cast<uint32_t>(w1));
  if (a.albedo != nullptr) a.out[3 * r + 2] = a.albedo[r];
}

// ---- the insert ---------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    spatial_hash_keys_kernel(const InsertArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= a.n) return;
  uint32_t fp, group;
  hash_key(a.qpos[3 * i], a.qpos[3 * i + 1], a.qpos[3 * i + 2], a.face[i],
           a.ngroups, &fp, &group);
  const bool valid = a.valid == nullptr || a.valid[i] != 0;
  a.gkey[i] = valid ? static_cast<int>(group) : static_cast<int>(a.ngroups);
  a.fp[i] = static_cast<int>(fp);
}

// _combine of the segmented-sum operator: (af | bf, bf ? bv : av + bv).
__device__ __forceinline__ float4 combine(float4 av, bool bf, float4 bv) {
  return bf ? bv
            : make_float4(av.x + bv.x, av.y + bv.y, av.z + bv.z,
                          av.w + bv.w);
}

// Offset of tree level L (kScanBlock >> L entries) in a block's shared
// arrays.
__device__ __forceinline__ int level_offset(int level) {
  return 2 * kScanBlock - ((2 * kScanBlock) >> level);
}

// Reversed key r (the scan's element): its segment flag and value, and
// whether forward key n - 1 - r is an applied one (the first of its group).
// The flag of r > 0 is the forward successor's run start.
__device__ void scan_element(const InsertArgs& a, long long r, bool* flag,
                             float4* v, bool* applies) {
  if (r >= a.n) {
    *flag = false;
    *v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *applies = false;
    return;
  }
  const long long j = a.n - 1 - r;
  const int g = a.s_gkey[j];
  const bool valid = g < a.ngroups;
  const long long src = a.order[j];
  *v = valid ? make_float4(a.value[3 * src], a.value[3 * src + 1],
                           a.value[3 * src + 2], 1.0f)
             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (r == 0) {
    *flag = true;
  } else {
    const int g1 = a.s_gkey[j + 1];
    *flag = g1 < a.ngroups &&
            (g1 != g || a.fp[a.order[j + 1]] != a.fp[src]);
  }
  *applies = valid && (j == 0 || a.s_gkey[j - 1] != g);
}

// Loads the block's keys (two a thread: 2t, 2t + 1) as tree level 0 and
// sums the tree up to its total; returns the thread's applied flags.
__device__ void scan_block_tree(const InsertArgs& a, float4* sv,
                                unsigned char* sf, bool applies[2]) {
  const long long base = static_cast<long long>(blockIdx.x) * kScanBlock;
  for (int k = 0; k < 2; ++k) {
    const int e = 2 * threadIdx.x + k;
    bool f;
    float4 v;
    scan_element(a, base + e, &f, &v, &applies[k]);
    sv[e] = v;
    sf[e] = f;
  }
  for (int level = 1; level <= kScanLog; ++level) {
    __syncthreads();
    const int len = kScanBlock >> level;
    const int src = level_offset(level - 1), dst = level_offset(level);
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int l = src + 2 * j;
      sv[dst + j] = combine(sv[l], sf[l + 1], sv[l + 1]);
      sf[dst + j] = sf[l] | sf[l + 1];
    }
  }
  __syncthreads();
}

// Exclusive sum over the block's threads of `count`; the block's total in
// *total.
__device__ int block_exclusive_sum(int count, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = count;
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += x;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    int w = lane < nwarps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += x;
    }
    if (lane < nwarps) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  *total = warp_sums[(blockDim.x >> 5) - 1];
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  const int out = before + inc - count;
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kScanThreads)
    spatial_hash_scan_up_kernel(const InsertArgs a) {
  __shared__ float4 sv[2 * kScanBlock];
  __shared__ unsigned char sf[2 * kScanBlock];
  bool applies[2];
  scan_block_tree(a, sv, sf, applies);
  int total;
  block_exclusive_sum(applies[0] + applies[1], &total);
  if (threadIdx.x != 0) return;
  a.block_count[blockIdx.x] = total;
  if (static_cast<long long>(blockIdx.x + 1) * kScanBlock <= a.n) {
    a.tree_v[blockIdx.x] = sv[level_offset(kScanLog)];
    a.tree_f[blockIdx.x] = sf[level_offset(kScanLog)];
  }
}

// Offset of level `level` (len >> level entries) of a tree over len leaves
// whose levels follow each other in one array.
__device__ __forceinline__ long long tree_offset(long long len, int level) {
  long long off = 0;
  for (int l = 0; l < level; ++l) off += len >> l;
  return off;
}

// One block: the tree over the full blocks' totals (level 0, written by
// spatial_hash_scan_up_kernel) and each block prefix's fold; the applied
// keys before each block, and in all.
__global__ void __launch_bounds__(kBlocksThreads)
    spatial_hash_scan_blocks_kernel(const InsertArgs a) {
  const long long nfull = a.n >> kScanLog;
  const long long nblocks = (a.n + kScanBlock - 1) >> kScanLog;

  // Applied keys before each block: each thread sums a run of blocks.
  const long long per = (nblocks + blockDim.x - 1) / blockDim.x;
  const long long b0 = threadIdx.x * per;
  const long long b1 = b0 + per < nblocks ? b0 + per : nblocks;
  int own = 0;
  for (long long b = b0; b < b1; ++b) own += a.block_count[b];
  int total;
  int before = block_exclusive_sum(own, &total);
  for (long long b = b0; b < b1; ++b) {
    a.block_before[b] = before;
    before += a.block_count[b];
  }
  if (threadIdx.x == 0) a.applied[0] = total;

  // The tree's levels follow each other in tree_v / tree_f.
  long long src = 0, len = nfull;
  while (len >= 2) {
    const long long dst = src + len;
    for (long long j = threadIdx.x; j < len / 2; j += blockDim.x) {
      const long long l = src + 2 * j;
      a.tree_v[dst + j] = combine(a.tree_v[l], a.tree_f[l + 1],
                                  a.tree_v[l + 1]);
      a.tree_f[dst + j] = a.tree_f[l] | a.tree_f[l + 1];
    }
    __syncthreads();
    src = dst;
    len /= 2;
  }
  for (long long j = threadIdx.x; j < nfull; j += blockDim.x) {
    const unsigned long long p = j + 1;
    const int top = 63 - __clzll(p);
    float4 acc = a.tree_v[tree_offset(nfull, top)];
    for (int level = top - 1; level >= 0; --level) {
      if (!((p >> level) & 1ull)) continue;
      const long long e = tree_offset(nfull, level) +
                          static_cast<long long>(p >> level) - 1;
      acc = combine(acc, a.tree_f[e], a.tree_v[e]);
    }
    a.block_fold[j] = acc;
  }
}

__global__ void __launch_bounds__(kScanThreads)
    spatial_hash_scan_kernel(const InsertArgs a) {
  __shared__ float4 sv[2 * kScanBlock];
  __shared__ unsigned char sf[2 * kScanBlock];
  bool applies[2];
  scan_block_tree(a, sv, sf, applies);
  int total;
  const int before =
      block_exclusive_sum(applies[0] + applies[1], &total) +
      a.block_before[blockIdx.x];
  const long long base = static_cast<long long>(blockIdx.x) * kScanBlock;
  for (int k = 0; k < 2; ++k) {
    const long long r = base + 2 * threadIdx.x + k;
    if (r >= a.n) return;
    const unsigned long long p = r + 1;
    const unsigned long long q = p >> kScanLog;
    bool have = q > 0;
    float4 acc = have ? a.block_fold[q - 1]
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int level = kScanLog - 1; level >= 0; --level) {
      if (!((p >> level) & 1ull)) continue;
      const int e = level_offset(level) +
                    static_cast<int>((p >> level) - 1 -
                                     (static_cast<unsigned long long>(
                                          blockIdx.x) << (kScanLog - level)));
      acc = have ? combine(acc, sf[e], sv[e]) : sv[e];
      have = true;
    }
    const long long j = a.n - 1 - r;
    a.sums[j] = acc;
    a.rank[j] = a.applied[0] - (before + (k == 1 ? applies[0] : 0));
  }
}

__global__ void __launch_bounds__(kThreads)
    spatial_hash_apply_kernel(const InsertArgs a) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= a.n) return;
  const int g = a.s_gkey[j];
  if (g >= a.ngroups || (j > 0 && a.s_gkey[j - 1] == g)) return;
  if (a.cap >= 0 && a.rank[j] > a.cap) return;
  const uint32_t fp = static_cast<uint32_t>(a.fp[a.order[j]]);
  const float4 t = a.sums[j];
  const float k = t.w;
  const float kc = clamp_min(k, 1.0f);
  const float vbar[3] = {t.x / kc, t.y / kc, t.z / kc};

  Row cur = load_row(a.table, g);
  const uint32_t f0 = static_cast<uint32_t>(cur.w[0]);
  const uint32_t f1 = static_cast<uint32_t>(cur.w[4]);
  const uint32_t f2 = static_cast<uint32_t>(cur.w[8]);
  const bool me0 = f0 == fp || f0 == 0u;
  const bool me1 = f1 == fp || f1 == 0u;
  const bool me2 = f2 == fp || f2 == 0u;
  const int lf0 = cur.w[2], lf1 = cur.w[6], lf2 = cur.w[10];
  const int lru = lf0 <= min(lf1, lf2) ? 0 : (lf1 <= lf2 ? 1 : 2);
  const int probe = me0 ? 0 : (me1 ? 1 : (me2 ? 2 : lru));

  const bool same = static_cast<uint32_t>(cur.w[4 * probe]) == fp;
  const float c0 =
      clamp_max(static_cast<float>(same ? cur.w[4 * probe + 3] : 0),
                kMaxSampleCount - 1.0f);
  float r0[3];
  decode_logluv(static_cast<uint32_t>(cur.w[4 * probe + 1]), a.luv, r0);
  const float ck = c0 + k;
  const float den = clamp_min(ck, 1.0f);
  float rad[3];
  for (int i = 0; i < 3; ++i)
    rad[i] = fma64(same ? r0[i] : 0.0f, c0, vbar[i] * k) / den;
  cur.w[4 * probe] = static_cast<int>(fp);
  cur.w[4 * probe + 1] = static_cast<int>(encode_logluv(rad, a.luv));
  cur.w[4 * probe + 2] = a.frame_index;
  cur.w[4 * probe + 3] = static_cast<int>(clamp_max(ck, kMaxSampleCount));
  int4* o = reinterpret_cast<int4*>(a.out + 16 * static_cast<long long>(g));
  for (int q = 0; q < 4; ++q)
    o[q] = make_int4(cur.w[4 * q], cur.w[4 * q + 1], cur.w[4 * q + 2],
                     cur.w[4 * q + 3]);
}

// ---- the codec alone ----------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    spatial_hash_logluv_kernel(const LogLuvArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= a.n) return;
  if (a.words != nullptr) {
    decode_logluv(static_cast<uint32_t>(a.words[i]), a.luv, a.rgb + 3 * i);
  } else {
    a.out_words[i] = static_cast<int>(encode_logluv(a.rgb + 3 * i, a.luv));
  }
}

int blocks(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace

extern "C" int spatial_hash_probe_launch(const void* args, void* stream) {
  const ProbeArgs& a = *static_cast<const ProbeArgs*>(args);
  if (a.hi <= a.lo) return 0;
  spatial_hash_probe_kernel<<<blocks(a.hi - a.lo, kThreads), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One kernel of the insert a call, by `step`: 0 the keys; then, after the
// caller's sort, 1-3 the three scan launches and 4 the apply.
extern "C" int spatial_hash_insert_launch(const void* args, int step,
                                          void* stream) {
  const InsertArgs& a = *static_cast<const InsertArgs*>(args);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.n <= 0) return 0;
  const int nblocks = blocks(a.n, kScanBlock);
  switch (step) {
    case 0:
      spatial_hash_keys_kernel<<<blocks(a.n, kThreads), kThreads, 0, s>>>(a);
      break;
    case 1:
      spatial_hash_scan_up_kernel<<<nblocks, kScanThreads, 0, s>>>(a);
      break;
    case 2:
      spatial_hash_scan_blocks_kernel<<<1, kBlocksThreads, 0, s>>>(a);
      break;
    case 3:
      spatial_hash_scan_kernel<<<nblocks, kScanThreads, 0, s>>>(a);
      break;
    case 4:
      spatial_hash_apply_kernel<<<blocks(a.n, kThreads), kThreads, 0, s>>>(
          a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatial_hash_logluv_launch(const void* args, void* stream) {
  const LogLuvArgs& a = *static_cast<const LogLuvArgs*>(args);
  if (a.n <= 0) return 0;
  spatial_hash_logluv_kernel<<<blocks(a.n, kThreads), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
