// The novelty score of a batch of states against the visited tables, and the
// tables' update, by direct gathers and scatters.
//
// Replaces XLA code of the JAX package, not a TPU kernel:
// pushworld_tpu/ops/novelty.py novelty_score_and_update (lines 106-160),
// whose plain PyTorch form (pushworld_tpu_torch/ops/novelty.py
// novelty_score_and_update_reference) builds (B, S) bucket indicator rows X
// (moved atoms) and Y (all atoms) and makes two (B, S) x (S, S) bf16 GEMMs
// and several elementwise passes over the S x S pair table: at the
// production pair_bits 24 (S = 4,096, a 32 MiB table) ~69 GFLOP and >= 5
// passes over 32 MiB an iteration, although a state has at most n atoms.
//
// What it computes, as the GEMM form does (hash collisions included):
//   novelty 1  some moved object i is at a cell that seen_pos[i] lacks;
//   novelty 2  else, some bucket l of a moved atom and some bucket k of any
//              atom of the state, k != l, with pair_table[k, l] == 0 (X and
//              Y are SETS of buckets: ny - Y @ T - Y * (1 - diag) counts
//              exactly the k in Y \ {l} with T[k, l] == 0);
//   novelty 3  else, and for every invalid lane.
// The update, for every valid state: seen_pos[i, cell_i] = 1 for each moved
// i, and T[k, l] = T[l, k] = 1 for each k in X and l in Y (the diagonal
// included).  Every write stores 1, so racing writes cannot change the
// result.  States are scored against the tables as of the batch's start:
// the score and the update are two launches in stream order.
//
// Bound.  A state reads n cells of seen_pos and at most n^2 cells of the
// table (2 bytes each) and writes as many: a few KB for the search's 1,024
// states, so the launch is the bound.
//
// Design.  One warp a state: lane i holds object i's atom (its cell, its
// bucket by the JAX package's _atom_hash, moved or not) in shared memory,
// the lanes go over the n^2 (i, j) pairs, and a warp vote gives each flag.
// The table keeps its bf16 layout (0x3F80 = 1.0), read and written as raw
// 16-bit words.  n <= 32 (one lane an object).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxObjects = 32;
constexpr int kWarps = 8;  // states a CTA
constexpr uint16_t kOne = 0x3F80;  // bf16 1.0

__device__ __forceinline__ unsigned atom_hash(unsigned i, unsigned p, unsigned side_mask) {
  unsigned h = (i * 0x9E3779B1u) ^ (p * 0xC2B2AE3Du);
  h *= 0x165667B1u;
  h ^= h >> 15;
  return h & side_mask;
}

struct Atoms {
  int cell[kMaxObjects];
  unsigned bucket[kMaxObjects];
  bool moved[kMaxObjects];
};

// Lane i < n fills atom i of state b; returns the lane's own (cell, moved).
__device__ __forceinline__ void load_atoms(Atoms& at, const int* states, const uint8_t* moved, int b, int n,
                                           int H, int W, unsigned side_mask, int lane) {
  if (lane < n) {
    const int x = states[(static_cast<size_t>(b) * n + lane) * 2];
    const int y = states[(static_cast<size_t>(b) * n + lane) * 2 + 1];
    int cell = y * W + x;
    cell = cell < 0 ? 0 : (cell > H * W - 1 ? H * W - 1 : cell);
    at.cell[lane] = cell;
    at.bucket[lane] = atom_hash(static_cast<unsigned>(lane), static_cast<unsigned>(cell), side_mask);
    at.moved[lane] = moved[static_cast<size_t>(b) * n + lane] != 0;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32)
novelty_score_kernel(const int* __restrict__ states, const uint8_t* __restrict__ moved,
                     const uint8_t* __restrict__ valid, const uint8_t* __restrict__ seen_pos,
                     const uint16_t* __restrict__ table, float* __restrict__ out, int B, int n, int H, int W,
                     int side) {
  __shared__ Atoms atoms[kWarps];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  if (!valid[b]) {
    if (lane == 0) out[b] = 3.0f;
    return;
  }
  Atoms& at = atoms[threadIdx.x >> 5];
  load_atoms(at, states, moved, b, n, H, W, static_cast<unsigned>(side - 1), lane);
  const bool unseen = lane < n && at.moved[lane] && !seen_pos[static_cast<size_t>(lane) * H * W + at.cell[lane]];
  if (__any_sync(0xFFFFFFFFu, unseen)) {
    if (lane == 0) out[b] = 1.0f;
    return;
  }
  bool pair_unseen = false;
  for (int p = lane; p < n * n; p += 32) {
    const int i = p / n, j = p % n;  // l = bucket of moved atom i, k = bucket of atom j
    if (!at.moved[i]) continue;
    const unsigned l = at.bucket[i], k = at.bucket[j];
    if (k != l && (table[static_cast<size_t>(k) * side + l] & 0x7FFF) == 0) pair_unseen = true;
  }
  const bool nov2 = __any_sync(0xFFFFFFFFu, pair_unseen);
  if (lane == 0) out[b] = nov2 ? 2.0f : 3.0f;
}

__global__ void __launch_bounds__(kWarps * 32)
novelty_absorb_kernel(const int* __restrict__ states, const uint8_t* __restrict__ moved,
                      const uint8_t* __restrict__ valid, uint8_t* __restrict__ seen_pos,
                      uint16_t* __restrict__ table, int B, int n, int H, int W, int side) {
  __shared__ Atoms atoms[kWarps];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B || !valid[b]) return;
  Atoms& at = atoms[threadIdx.x >> 5];
  load_atoms(at, states, moved, b, n, H, W, static_cast<unsigned>(side - 1), lane);
  if (lane < n && at.moved[lane]) seen_pos[static_cast<size_t>(lane) * H * W + at.cell[lane]] = 1;
  for (int p = lane; p < n * n; p += 32) {
    const int i = p / n, j = p % n;  // k = bucket of moved atom i, l = bucket of atom j
    if (!at.moved[i]) continue;
    const unsigned k = at.bucket[i], l = at.bucket[j];
    table[static_cast<size_t>(k) * side + l] = kOne;
    table[static_cast<size_t>(l) * side + k] = kOne;
  }
}

bool bad_args(int B, int n, int H, int W, int side) {
  return B < 0 || n < 1 || n > kMaxObjects || H < 1 || W < 1 || side < 1 || (side & (side - 1)) != 0;
}

}  // namespace

// The largest number of objects (the states' second dimension) the kernels take.
extern "C" int pw_novelty_max_objects() { return kMaxObjects; }

// out (B,) float32 novelty; reads the tables only.
extern "C" int pw_novelty_score(const void* states, const void* moved, const void* valid, const void* seen_pos,
                                const void* table, void* out, int B, int n, int H, int W, int side,
                                void* stream) {
  if (bad_args(B, n, H, W, side)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  novelty_score_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(states), static_cast<const uint8_t*>(moved), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(seen_pos), static_cast<const uint16_t*>(table), static_cast<float*>(out), B, n,
      H, W, side);
  return static_cast<int>(cudaGetLastError());
}

// Updates seen_pos (n, H*W) bool and table (side, side) bf16 in place.
extern "C" int pw_novelty_absorb(const void* states, const void* moved, const void* valid, void* seen_pos,
                                 void* table, int B, int n, int H, int W, int side, void* stream) {
  if (bad_args(B, n, H, W, side)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  novelty_absorb_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(states), static_cast<const uint8_t*>(moved), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(seen_pos), static_cast<uint16_t*>(table), B, n, H, W, side);
  return static_cast<int>(cudaGetLastError());
}
