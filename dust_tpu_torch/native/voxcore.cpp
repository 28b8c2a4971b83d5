// voxcore: native scene-build kernels (C++17, no dependencies).
//
// The reference's asset pipeline runs its hot loops in native Rust —
// Tree::set_value over millions of voxels and the ModelIndexCollector
// prefix sums (crates/vox/src/loader.rs:251-297, rayon-parallel at :371).
// These are the host-side equivalents: the dense-grid voxel pass, material
// compaction and the chebyshev skip-field transform, exposed through a C
// ABI for ctypes. Their plain numpy versions, which the tests hold these
// against, are VoxTree.from_voxels + collect_material_indices and
// render/scene.py's dilation loop.
//
// Build (dust_tpu_torch/native/__init__.py, at first use):
//   g++ -O3 -shared -fPIC -std=c++17 -pthread -o libvoxcore_<tag>.so voxcore.cpp
// No -march=native: the library is built on whatever host runs it.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {
constexpr int kBlocksPerAxis = 64;
constexpr int kNumBlocks = kBlocksPerAxis * kBlocksPerAxis * kBlocksPerAxis;

inline int64_t block_lin(int x, int y, int z) {
  // Collector linear order: bx + by*64 + bz*64*64 (collector.rs:33-40).
  return (x >> 2) + ((int64_t)(y >> 2) << 6) + ((int64_t)(z >> 2) << 12);
}
inline int bit_index(int x, int y, int z) {
  // (x<<4)|(y<<2)|z within the 4^3 leaf (hit.rint:30-32).
  return ((x & 3) << 4) | ((y & 3) << 2) | (z & 3);
}

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? (int)std::min(n, 16u) : 4;
}
}  // namespace

extern "C" {

// Builds per-block occupancy masks + compacted materials from a voxel
// list (engine orientation). Duplicates: last write wins, like the dense
// grid in the reference collector.
//
// Outputs (caller-allocated):
//   occupancy:  kNumBlocks u64, mask per block (0 = empty)
//   block_ptr:  kNumBlocks u32, exclusive prefix sum of popcounts
//   materials:  >= number of unique voxels u8, compacted palette indices
// Returns the number of compacted material entries (== unique voxels),
// or -1 on invalid input.
int64_t voxcore_build_leaves(const int32_t* coords, const uint8_t* palette_idx,
                             int64_t n, uint64_t* occupancy,
                             uint32_t* block_ptr, uint8_t* materials) {
  std::memset(occupancy, 0, kNumBlocks * sizeof(uint64_t));

  // Dense 256^3 one-based grid (2 B x 256^3 = 32 MiB) — same strategy as the
  // reference
  // collector; last-write-wins duplicate handling for free.
  std::vector<uint16_t> grid((size_t)256 * 256 * 256, 0);
  for (int64_t i = 0; i < n; i++) {
    int x = coords[i * 3], y = coords[i * 3 + 1], z = coords[i * 3 + 2];
    if ((unsigned)x > 255u || (unsigned)y > 255u || (unsigned)z > 255u) return -1;
    size_t cell = ((size_t)block_lin(x, y, z) << 6) | bit_index(x, y, z);
    grid[cell] = (uint16_t)(palette_idx[i] + 1);
  }

  // Per-block masks + counts (parallel over strided blocks; each block is
  // written by one thread, so the output does not depend on the count).
  std::vector<uint32_t> counts(kNumBlocks, 0);
  int nt = hw_threads();
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++) {
    threads.emplace_back([&, t]() {
      for (int b = t; b < kNumBlocks; b += nt) {
        uint64_t mask = 0;
        const uint16_t* cells = &grid[(size_t)b << 6];
        for (int k = 0; k < 64; k++)
          if (cells[k]) mask |= 1ull << k;
        occupancy[b] = mask;
        counts[b] = (uint32_t)__builtin_popcountll(mask);
      }
    });
  }
  for (auto& th : threads) th.join();

  uint32_t sum = 0;
  for (int b = 0; b < kNumBlocks; b++) {
    block_ptr[b] = sum;
    sum += counts[b];
  }

  // Compact materials in (block, bit) order.
  threads.clear();
  for (int t = 0; t < nt; t++) {
    threads.emplace_back([&, t]() {
      for (int b = t; b < kNumBlocks; b += nt) {
        uint64_t mask = occupancy[b];
        const uint16_t* cells = &grid[(size_t)b << 6];
        uint32_t out = block_ptr[b];
        while (mask) {
          int k = __builtin_ctzll(mask);
          mask &= mask - 1;
          materials[out++] = (uint8_t)(cells[k] - 1);
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  return (int64_t)sum;
}

// Chebyshev (L-inf) distance transform over a 64^3 occupancy field,
// clamped to max_dist. dist[occupied] = 0. Two-pass sweep (exact for
// chebyshev metric via 26-neighbour min-propagation).
void voxcore_chebyshev(const uint8_t* occupied, int32_t* dist, int32_t max_dist) {
  const int N = kBlocksPerAxis;
  auto at = [N](int x, int y, int z) { return (x * N + y) * N + z; };
  for (int i = 0; i < kNumBlocks; i++)
    dist[i] = occupied[i] ? 0 : max_dist;

  // Two-pass 26-neighbour chamfer (weights all 1) is exact for the
  // chebyshev metric. Forward pass relaxes against the 13 neighbours
  // earlier in lexicographic scan order; backward pass the other 13.
  int fwd[13][3];
  int nf = 0;
  for (int dx = -1; dx <= 1; dx++)
    for (int dy = -1; dy <= 1; dy++)
      for (int dz = -1; dz <= 1; dz++) {
        if (dx < 0 || (dx == 0 && (dy < 0 || (dy == 0 && dz < 0)))) {
          fwd[nf][0] = dx; fwd[nf][1] = dy; fwd[nf][2] = dz; nf++;
        }
      }

  auto relax = [&](int x, int y, int z, bool forward) {
    int32_t best = dist[at(x, y, z)];
    if (best == 0) return;
    for (int k = 0; k < 13; k++) {
      int nx = x + (forward ? fwd[k][0] : -fwd[k][0]);
      int ny = y + (forward ? fwd[k][1] : -fwd[k][1]);
      int nz = z + (forward ? fwd[k][2] : -fwd[k][2]);
      if ((unsigned)nx >= (unsigned)N || (unsigned)ny >= (unsigned)N ||
          (unsigned)nz >= (unsigned)N)
        continue;
      int32_t c = dist[at(nx, ny, nz)] + 1;
      if (c < best) best = c;
    }
    dist[at(x, y, z)] = std::min(best, max_dist);
  };

  for (int x = 0; x < N; x++)
    for (int y = 0; y < N; y++)
      for (int z = 0; z < N; z++)
        relax(x, y, z, true);
  for (int x = N - 1; x >= 0; x--)
    for (int y = N - 1; y >= 0; y--)
      for (int z = N - 1; z >= 0; z--)
        relax(x, y, z, false);
}

}  // extern "C"
