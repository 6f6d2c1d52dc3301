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
// result.  Every state is scored against the tables as of the batch's
// start: no score may read a cell that another state of the batch wrote,
// so the score and the update are two launches in stream order.
//
// Bound.  A state reads n cells of seen_pos and at most n^2 cells of the
// table (2 bytes each) and writes as many: a few KB for the search's 1,024
// states, so the launch is the bound, and the chain of dependent loads
// (valid -> positions -> seen_pos -> table cells) is what the design works
// on.
//
// Design.  One warp a state, 8 states a CTA (128 CTAs for the search's
// 1,024 states, so the table's scattered cells spread over the card's SMs),
// lane i holding atom i (its cell, its bucket by the JAX package's
// _atom_hash, moved or not) in registers.  The score reads the valid flag
// alone first (a closed gate costs that load and the fill), then the atom
// (one 8-byte position load and the moved flag), then seen_pos; a ballot
// gives novelty 1, and only the states without it read their table cells,
// lane j reading T[bucket_j, bucket_i] for every moved atom i (the buckets
// shuffled within the warp, every cell's load issued before any is tested).
// It also leaves each valid state's atoms in a record (cell; bucket and
// moved bit), so the update reads its valid flag and its record in one wave
// and goes straight to its writes.  The table keeps its bf16 layout (0x3F80
// = 1.0), read and written as raw 16-bit words.  This is the one-word path,
// n <= 32 (kMaxObjects: one lane an object).
//
// Wide path (n > 32, any n): the same warp a state, lane j holding atoms j,
// j + 32, ... in ceil(n / 32) rounds.  The score writes the state's record
// first; after a __syncwarp (which orders the lanes' memory accesses) every
// lane reads back from the record the atoms that other lanes hold, 32 at a
// time, and tests T[bucket_j, bucket_i] for each of its atoms j against
// every moved atom i, the loads of 8 atoms issued before any is tested.
// The update walks the same pairs from the record.  The decisions are the
// one-word path's, so the result is the GEMM form's, collisions included.
// A state now reads up to n^2 table cells: the chain of dependent loads
// grows with the rounds, and the launch stays the bound only while n^2 is
// small.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PW_STOP
#define PW_STOP(k, v)
#endif

namespace {

constexpr int kMaxObjects = 32;
constexpr int kStates = 8;         // states (warps) a CTA
constexpr uint16_t kOne = 0x3F80;  // bf16 1.0
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kMovedBit = 1u << 31;  // in a record's bucket word

struct Nov {
  const int* states;      // (B, n, 2) int32 (x, y), 8-byte aligned
  const uint8_t* moved;   // (B, n) bool
  const uint8_t* valid;   // (B,) bool
  uint8_t* seen_pos;      // (n, H*W) bool
  uint16_t* table;        // (side, side) bf16
  float* out;             // (B,) novelty
  int2* record;           // (B, n) atoms of the valid states: (cell, bucket | moved bit)
  int B, n, H, W, side;
};

__device__ __forceinline__ unsigned atom_hash(unsigned i, unsigned p, unsigned side_mask) {
  unsigned h = (i * 0x9E3779B1u) ^ (p * 0xC2B2AE3Du);
  h *= 0x165667B1u;
  h ^= h >> 15;
  return h & side_mask;
}

// Atom j of a state, held by lane j of its warp.
struct Atom {
  int cell;
  unsigned bucket;
  bool moved;
};

// The score of state b by its warp (lane j < n: atom j), and its record.
__global__ void __launch_bounds__(kStates * 32) novelty_score_kernel(Nov v) {
  const int j = threadIdx.x & 31;
  const int b = blockIdx.x * kStates + (threadIdx.x >> 5);
  if (b >= v.B) return;
  if (!v.valid[b]) {
    if (j == 0) v.out[b] = 3.0f;
    return;
  }
  PW_STOP(1, b);  // phase: valid flag
  const int HW = v.H * v.W;
  Atom at{0, 0u, false};
  bool unseen = false;
  if (j < v.n) {
    const size_t i = static_cast<size_t>(b) * v.n + j;
    const int2 p = __ldg(reinterpret_cast<const int2*>(v.states) + i);
    const int cell = p.y * v.W + p.x;
    at.cell = cell < 0 ? 0 : (cell > HW - 1 ? HW - 1 : cell);
    at.bucket = atom_hash(static_cast<unsigned>(j), static_cast<unsigned>(at.cell), static_cast<unsigned>(v.side - 1));
    at.moved = __ldg(v.moved + i) != 0;
    unseen = at.moved && v.seen_pos[static_cast<size_t>(j) * HW + at.cell] == 0;
    v.record[i] = make_int2(at.cell, static_cast<int>(at.bucket | (at.moved ? kMovedBit : 0u)));
  }
  PW_STOP(2, static_cast<int>(unseen));  // phase: positions, seen_pos gathers, record
  if (__any_sync(kFull, unseen)) {
    if (j == 0) v.out[b] = 1.0f;
    return;
  }
  bool pair_unseen = false;
  for (int i0 = 0; i0 < v.n; i0 += 8) {
    uint16_t cell[8];
    bool need[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u < v.n ? i0 + u : 0;
      const unsigned l = __shfl_sync(kFull, at.bucket, i);
      const bool mi = __shfl_sync(kFull, static_cast<int>(at.moved), i) != 0;
      need[u] = i0 + u < v.n && j < v.n && mi && at.bucket != l;
      cell[u] = need[u] ? v.table[static_cast<size_t>(at.bucket) * v.side + l] : kOne;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) pair_unseen |= need[u] && (cell[u] & 0x7FFF) == 0;
  }
  const bool nov2 = __any_sync(kFull, pair_unseen);
  if (j == 0) v.out[b] = nov2 ? 2.0f : 3.0f;
}

// The update of state b from its record, by its warp: seen_pos of each
// moved atom, and T[k, l] = T[l, k] = 1 for k a moved atom's bucket and l
// any atom's (lane j holds l).  The valid flag and the record are one wave.
__global__ void __launch_bounds__(kStates * 32) novelty_absorb_kernel(Nov v) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kStates + (threadIdx.x >> 5);
  if (b >= v.B) return;
  const bool live = v.valid[b] != 0;
  const int2 r = lane < v.n ? v.record[static_cast<size_t>(b) * v.n + lane] : make_int2(0, 0);
  if (!live) return;
  PW_STOP(3, r.x);  // phase: update: valid flag, record
  const unsigned bucket = static_cast<unsigned>(r.y) & ~kMovedBit;
  const bool moved = lane < v.n && (static_cast<unsigned>(r.y) & kMovedBit) != 0u;
  if (moved) v.seen_pos[static_cast<size_t>(lane) * v.H * v.W + r.x] = 1;
  for (int i = 0; i < v.n; ++i) {
    const unsigned k = __shfl_sync(kFull, bucket, i);
    const bool mi = __shfl_sync(kFull, static_cast<int>(moved), i) != 0;
    if (mi && lane < v.n) {
      v.table[static_cast<size_t>(k) * v.side + bucket] = kOne;
      v.table[static_cast<size_t>(bucket) * v.side + k] = kOne;
    }
  }
}

bool bad_args(int B, int n, int H, int W, int side) {
  return B < 0 || n < 1 || n > kMaxObjects || H < 1 || W < 1 || side < 1 || (side & (side - 1)) != 0;
}

// ------------------------------------------------------------ wide path

// The score of state b by its warp, any n: lane j takes atoms j, j + 32, ...
__global__ void __launch_bounds__(kStates * 32) novelty_score_wide_kernel(Nov v) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kStates + (threadIdx.x >> 5);
  if (b >= v.B) return;
  if (!v.valid[b]) {
    if (lane == 0) v.out[b] = 3.0f;
    return;
  }
  const int HW = v.H * v.W, n = v.n;
  const size_t row = static_cast<size_t>(b) * n;
  bool unseen = false;
  for (int j = lane; j < n; j += 32) {
    const int2 p = __ldg(reinterpret_cast<const int2*>(v.states) + row + j);
    const int raw = p.y * v.W + p.x;
    const int cell = raw < 0 ? 0 : (raw > HW - 1 ? HW - 1 : raw);
    const unsigned bucket = atom_hash(static_cast<unsigned>(j), static_cast<unsigned>(cell),
                                      static_cast<unsigned>(v.side - 1));
    const bool moved = __ldg(v.moved + row + j) != 0;
    unseen |= moved && v.seen_pos[static_cast<size_t>(j) * HW + cell] == 0;
    v.record[row + j] = make_int2(cell, static_cast<int>(bucket | (moved ? kMovedBit : 0u)));
  }
  if (__any_sync(kFull, unseen)) {
    if (lane == 0) v.out[b] = 1.0f;
    return;
  }
  __syncwarp();  // every lane's record entries are visible to the others
  bool pair_unseen = false;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const bool mine = j < n;
    const unsigned bj = mine ? static_cast<unsigned>(v.record[row + j].y) & ~kMovedBit : 0u;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const unsigned ri = i0 + lane < n ? static_cast<unsigned>(v.record[row + i0 + lane].y) : 0u;
      for (int u0 = 0; u0 < 32 && i0 + u0 < n; u0 += 8) {
        uint16_t cell[8];
        bool need[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const unsigned r = __shfl_sync(kFull, ri, u0 + u);
          const unsigned l = r & ~kMovedBit;
          need[u] = i0 + u0 + u < n && mine && (r & kMovedBit) != 0u && bj != l;
          cell[u] = need[u] ? v.table[static_cast<size_t>(bj) * v.side + l] : kOne;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) pair_unseen |= need[u] && (cell[u] & 0x7FFF) == 0;
      }
    }
  }
  const bool nov2 = __any_sync(kFull, pair_unseen);
  if (lane == 0) v.out[b] = nov2 ? 2.0f : 3.0f;
}

// The update of state b from its record by its warp, any n: seen_pos of each
// moved atom, and T[k, l] = T[l, k] = 1 for k a moved atom's bucket and l
// any atom's (lane j holds atoms j, j + 32, ...).
__global__ void __launch_bounds__(kStates * 32) novelty_absorb_wide_kernel(Nov v) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kStates + (threadIdx.x >> 5);
  if (b >= v.B || !v.valid[b]) return;
  const int n = v.n;
  const size_t row = static_cast<size_t>(b) * n;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const bool mine = j < n;
    const int2 rj = mine ? v.record[row + j] : make_int2(0, 0);
    const unsigned bj = static_cast<unsigned>(rj.y) & ~kMovedBit;
    if (mine && (static_cast<unsigned>(rj.y) & kMovedBit) != 0u)
      v.seen_pos[static_cast<size_t>(j) * v.H * v.W + rj.x] = 1;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const unsigned ri = i0 + lane < n ? static_cast<unsigned>(v.record[row + i0 + lane].y) : 0u;
      for (int u = 0; u < 32 && i0 + u < n; ++u) {
        const unsigned r = __shfl_sync(kFull, ri, u);
        const unsigned k = r & ~kMovedBit;
        if ((r & kMovedBit) != 0u && mine) {
          v.table[static_cast<size_t>(k) * v.side + bj] = kOne;
          v.table[static_cast<size_t>(bj) * v.side + k] = kOne;
        }
      }
    }
  }
}

bool bad_wide_args(int B, int n, int H, int W, int side) {
  return B < 0 || n < 1 || H < 1 || W < 1 || side < 1 || (side & (side - 1)) != 0;
}

}  // namespace

// The largest number of objects (the states' second dimension) the one-word
// path takes; the _wide entries take any number.
extern "C" int pw_novelty_max_objects() { return kMaxObjects; }

// out (B,) float32 novelty; reads the tables only, and writes the record
// (B, n) int2 of each valid state for pw_novelty_absorb_records.
extern "C" int pw_novelty_score_records(const void* states, const void* moved, const void* valid,
                                        const void* seen_pos, const void* table, void* out, void* record, int B,
                                        int n, int H, int W, int side, void* stream) {
  if (bad_args(B, n, H, W, side) || reinterpret_cast<uintptr_t>(states) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(record) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Nov v{static_cast<const int*>(states), static_cast<const uint8_t*>(moved),
              static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(const_cast<void*>(seen_pos)),
              static_cast<uint16_t*>(const_cast<void*>(table)), static_cast<float*>(out),
              static_cast<int2*>(record), B, n, H, W, side};
  novelty_score_kernel<<<(B + kStates - 1) / kStates, kStates * 32, 0, static_cast<cudaStream_t>(stream)>>>(v);
  return static_cast<int>(cudaGetLastError());
}

// Updates seen_pos (n, H*W) bool and table (side, side) bf16 in place from
// the records that pw_novelty_score_records wrote for the same valid flags.
extern "C" int pw_novelty_absorb_records(const void* valid, const void* record, void* seen_pos, void* table,
                                         int B, int n, int H, int W, int side, void* stream) {
  if (bad_args(B, n, H, W, side) || reinterpret_cast<uintptr_t>(record) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Nov v{nullptr, nullptr, static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(seen_pos),
              static_cast<uint16_t*>(table), nullptr, static_cast<int2*>(const_cast<void*>(record)), B, n, H, W,
              side};
  novelty_absorb_kernel<<<(B + kStates - 1) / kStates, kStates * 32, 0, static_cast<cudaStream_t>(stream)>>>(v);
  return static_cast<int>(cudaGetLastError());
}

// The wide path of pw_novelty_score_records, for any n: the same arguments.
extern "C" int pw_novelty_score_records_wide(const void* states, const void* moved, const void* valid,
                                             const void* seen_pos, const void* table, void* out, void* record,
                                             int B, int n, int H, int W, int side, void* stream) {
  if (bad_wide_args(B, n, H, W, side) || reinterpret_cast<uintptr_t>(states) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(record) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Nov v{static_cast<const int*>(states), static_cast<const uint8_t*>(moved),
              static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(const_cast<void*>(seen_pos)),
              static_cast<uint16_t*>(const_cast<void*>(table)), static_cast<float*>(out),
              static_cast<int2*>(record), B, n, H, W, side};
  novelty_score_wide_kernel<<<(B + kStates - 1) / kStates, kStates * 32, 0, static_cast<cudaStream_t>(stream)>>>(v);
  return static_cast<int>(cudaGetLastError());
}

// The wide path of pw_novelty_absorb_records, for any n: the same arguments.
extern "C" int pw_novelty_absorb_records_wide(const void* valid, const void* record, void* seen_pos, void* table,
                                              int B, int n, int H, int W, int side, void* stream) {
  if (bad_wide_args(B, n, H, W, side) || reinterpret_cast<uintptr_t>(record) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Nov v{nullptr, nullptr, static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(seen_pos),
              static_cast<uint16_t*>(table), nullptr, static_cast<int2*>(const_cast<void*>(record)), B, n, H, W,
              side};
  novelty_absorb_wide_kernel<<<(B + kStates - 1) / kStates, kStates * 32, 0, static_cast<cudaStream_t>(stream)>>>(v);
  return static_cast<int>(cudaGetLastError());
}
