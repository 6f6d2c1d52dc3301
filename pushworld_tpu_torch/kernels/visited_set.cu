// Visited set over a packed 64-bit table: probe/insert, probe/delete, the
// search iteration's fused fingerprint + batch dedup + probe/insert, and the
// fingerprint alone.
//
// Replaces the JAX package's XLA code in pushworld_tpu/ops/hashset.py
// (fingerprint, lines 54-80; dedup_batch, lines 83-102; probe_and_insert,
// lines 105-154; probe_delete, lines 157-179); there is no Pallas
// counterpart.  The JAX insert writes key_lo and key_hi with two scatters; on
// a GPU a scatter with duplicate indices has no defined winner, so the
// halves of a key could tear.  Here each slot is ONE 64-bit word
// (hi << 32 | lo; 0 = empty, all ones = tombstone) and a lane claims an
// empty or tombstoned slot with a 64-bit atomicCAS, so keys never tear.
//
// Probing: visited_probe.cuh, shared with frontier.cu's compaction, which
// tombstones the fingerprints it drops itself (so on the search's main path
// the standalone delete is not launched: it serves the public
// probe_delete, the plain compaction's callers and the card tests).  The
// N_PROBES slots of a key's sequence are read in one wave, then scanned in
// probe order: found, or the first free slot claimed with a CAS (insert);
// the first copy of the key tombstoned (delete).
//
// The insert and the delete kernels: a group of 8 threads a key, thread j
// reading slot j of the window (a warp's load is 4 windows of 64 contiguous
// bytes), a ballot for the first thread that decides.  The key and its
// valid flag are loaded together, then the window, then the CAS: three
// round trips in all.  The delete reads its gate (null: open) alone first,
// so a closed gate costs one load.
//
// Bound: bytes.  A lane must move a few dozen bytes (the fused kernel 8N + 1
// in, 9 out; on a sparse table one word read and one written) at random
// 8-byte addresses; there is no arithmetic to speak of.  At the batch the
// search gives (4 * expand = 1,024 lanes) the bound of any of these kernels
// is its launch; what a kernel adds to it is its chain of dependent round
// trips, which the window read cuts to three (flag and key, window, CAS).
//
// Design of the fused kernel.  An iteration used to reach the table through
// about a hundred small launches: an eager fingerprint fold (a dozen
// elementwise kernels per object and 32-bit lane), a sort-based dedup, then
// the insert kernel.  fingerprint_dedup_insert_kernel does all three in one
// launch of ONE CTA of 1,024 threads, thread t taking lanes t, t + 1024, ...:
//   1. the two FxHash-style folds in native uint32 arithmetic (bit-identical
//      to the int64 form of the plain version), keys written out;
//   2. the batch dedup without a sort: a CTA-local open-addressing table of
//      (key, owner) with at least 2n slots.  A valid lane claims a slot for
//      its key with a 64-bit atomicCAS and atomicMins its index into owner;
//      after a CTA barrier lane i is the batch's first occurrence iff
//      owner == i.  The lowest index wins whatever the order of the claims,
//      so the result is deterministic;
//   3. find_or_claim_by_slot (visited_probe.cuh) for the first occurrences,
//      is_new written out.
// With a gate flag that is 0 (the search iteration is a no-op), the kernel
// writes is_new = 0 and returns: keys are not written.
// The dedup table lives in shared memory (2,048 slots, 24 KB, at n = 1,024;
// up to 16,384 slots, 192 KB, for n <= 8,192); a larger batch passes a
// scratch table in device memory and the same code runs on it.  One CTA is
// enough: the work is a few microseconds, and a single CTA needs no grid
// barrier between the claims and the owner reads.
//
// The fingerprint alone (fingerprint_kernel): one thread a state, the fused
// kernel's fold, no table.  It serves a search's root and the
// frontier-sharded search's routing of children to their owners.  Bound:
// 8N bytes read and 8 written a state, far below a launch at the batches
// those callers give (1 to 4,096 states).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "visited_probe.cuh"

// Phase marks for scripts/profile_kernel_phases.py (no-ops here).
#ifndef PW_STOP
#define PW_STOP(k, v)
#endif

namespace {

using pw_probe::first_slot;
using pw_probe::kEmpty;
using pw_probe::kProbes;
using pw_probe::u64;

constexpr int kThreads = 256;
constexpr int kFusedThreads = 1024;
constexpr int kNoOwner = 0x7FFFFFFF;
constexpr int kMaxSharedSlots = 16384;  // 12 bytes each: 192 KB

// Eight threads a key (kProbes lanes: a group of visited_probe.cuh): thread
// t probes key t / 8.  The groups of a warp run in step (full-warp ballots),
// so no thread returns before the probe, and the grid is whole warps.
__global__ void probe_and_insert_kernel(u64* __restrict__ table, const u64* __restrict__ keys,
                                        const uint8_t* __restrict__ valid,
                                        uint8_t* __restrict__ is_new, int n, unsigned int mask) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / kProbes;
  const bool in = i < n;
  const bool v = in && valid[i];
  const u64 key = in ? keys[i] : kEmpty;
  PW_STOP(1, static_cast<int>(key) + v);  // phase: valid and key
  const u64 cur = pw_probe::group_word(table, key, v, mask);
  PW_STOP(2, static_cast<int>(cur));  // phase: window
  const bool found = pw_probe::group_find_or_claim(table, key, v, mask, cur);
  if (in && (threadIdx.x & 7u) == 0u) is_new[i] = v && !found;
}

// The gate (null: open) is read alone first: a closed gate costs one load.
__global__ void probe_delete_kernel(u64* __restrict__ table, const u64* __restrict__ keys,
                                    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ gate, int n,
                                    unsigned int mask) {
  if (gate != nullptr && !*gate) return;  // the whole grid alike
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / kProbes;
  const bool in = i < n;
  const bool v = in && valid[i];
  const u64 key = in ? keys[i] : kEmpty;
  PW_STOP(1, static_cast<int>(key) + v);  // phase: valid and key
  const u64 cur = pw_probe::group_word(table, key, v, mask);
  PW_STOP(2, static_cast<int>(cur));  // phase: window
  pw_probe::group_delete(table, key, v, mask, cur);
}

// One step of a 32-bit fingerprint lane.
__device__ __forceinline__ unsigned int fold(unsigned int h, unsigned int v, unsigned int mult) {
  h = (h ^ v) * mult;
  return h ^ (h >> 13);
}

// The 64-bit fingerprint of one state (n_obj, 2): two folds over the objects'
// flat positions y * width + x, with different seeds, offsets and multipliers.
__device__ __forceinline__ u64 fingerprint(const int* __restrict__ state, int n_obj,
                                           unsigned int width) {
  unsigned int lo = 0x811C9DC5u, hi = 0xCBF29CE4u;
  for (int o = 0; o < n_obj; ++o) {
    const unsigned int flat = static_cast<unsigned int>(state[2 * o + 1]) * width +
                              static_cast<unsigned int>(state[2 * o]);
    lo = fold(lo, flat + 0x9E3779B9u, 0x01000193u);
    hi = fold(hi, flat + 0x27D4EB2Fu, 0x85EBCA6Bu);
  }
  if (lo == 0u && hi == 0u) lo = 1u;                             // the empty word
  if (lo == 0xFFFFFFFFu && hi == 0xFFFFFFFFu) lo = 0xFFFFFFFEu;  // the tombstone
  return static_cast<u64>(hi) << 32 | lo;
}

// states (n, n_obj, 2) int32 -> keys (n,) and is_new (n,).  dedup: slots
// 64-bit keys followed by slots int32 owners, in device memory, or null for
// the CTA's shared memory.  slots is a power of two >= 2n.
__global__ void __launch_bounds__(kFusedThreads)
fingerprint_dedup_insert_kernel(u64* __restrict__ table, const int* __restrict__ states,
                                const uint8_t* __restrict__ valid, const uint8_t* __restrict__ gate,
                                u64* __restrict__ keys, uint8_t* __restrict__ is_new, void* dedup, int n,
                                int n_obj, unsigned int width, unsigned int mask, int slots) {
  extern __shared__ __align__(8) unsigned char smem[];
  if (gate != nullptr && !*gate) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) is_new[i] = 0;
    return;
  }
  u64* dkey = static_cast<u64*>(dedup ? dedup : static_cast<void*>(smem));
  int* owner = reinterpret_cast<int*>(dkey + slots);
  const unsigned int dmask = static_cast<unsigned int>(slots) - 1u;

  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    dkey[s] = kEmpty;
    owner[s] = kNoOwner;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const u64 key = fingerprint(states + static_cast<size_t>(i) * n_obj * 2, n_obj, width);
    keys[i] = key;
    if (!valid[i]) continue;
    // At most n of the >= 2n slots are ever claimed, so a free one is found.
    unsigned int s = first_slot(key, dmask);
    for (int t = 0; t < slots; ++t, s = (s + 1u) & dmask) {
      const u64 old = atomicCAS(dkey + s, kEmpty, key);
      if (old == kEmpty || old == key) {
        atomicMin(owner + s, i);
        break;
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool fresh = false;
    if (valid[i]) {
      const u64 key = keys[i];  // written above by this thread
      // Volatile: the words were written by other threads' atomics.
      const volatile u64* vkey = dkey;
      const volatile int* vowner = owner;
      unsigned int s = first_slot(key, dmask);
      for (int t = 0; t < slots && vkey[s] != key; ++t) s = (s + 1u) & dmask;
      fresh = vowner[s] == i && !pw_probe::find_or_claim_by_slot(table, key, mask);
    }
    is_new[i] = fresh;
  }
}

// states (n, n_obj, 2) int32 -> keys (n,), one thread a state.
__global__ void fingerprint_kernel(const int* __restrict__ states, u64* __restrict__ keys, int n, int n_obj,
                                   unsigned int width) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = fingerprint(states + static_cast<size_t>(i) * n_obj * 2, n_obj, width);
}

}  // namespace

extern "C" int pw_fingerprint(const void* states, void* keys, int n, int n_obj, unsigned int width, void* stream) {
  if (n < 0 || n_obj < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  fingerprint_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(states), static_cast<u64*>(keys), n, n_obj, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pw_probe_and_insert(void* table, const void* keys, const void* valid,
                                   void* is_new, int n, unsigned int mask, void* stream) {
  if (n < 0 || n > INT_MAX / kProbes) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n * kProbes + kThreads - 1) / kThreads;
  probe_and_insert_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<u64*>(table), static_cast<const u64*>(keys),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(is_new), n, mask);
  return static_cast<int>(cudaGetLastError());
}

// gate (a bool scalar on the device) may be null; where it is 0 nothing is
// deleted.
extern "C" int pw_probe_delete(void* table, const void* keys, const void* valid, const void* gate, int n,
                               unsigned int mask, void* stream) {
  if (n < 0 || n > INT_MAX / kProbes) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n * kProbes + kThreads - 1) / kThreads;
  probe_delete_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<u64*>(table), static_cast<const u64*>(keys),
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(gate), n, mask);
  return static_cast<int>(cudaGetLastError());
}

// The largest dedup table (in slots) that the fused kernel keeps in shared
// memory; a batch that needs more passes a table in device memory.
extern "C" int pw_dedup_shared_slots() { return kMaxSharedSlots; }

// dedup: null, or slots * 12 bytes of device scratch (8-byte aligned); the
// kernel clears it.  slots: a power of two >= 2n, at most
// pw_dedup_shared_slots() when dedup is null.
// gate (a bool scalar on the device) may be null.
extern "C" int pw_fingerprint_dedup_insert(void* table, const void* states, const void* valid,
                                           const void* gate, void* keys, void* is_new, void* dedup, int n,
                                           int n_obj, unsigned int width, unsigned int mask,
                                           int slots, void* stream) {
  if (slots < 2 * n || (slots & (slots - 1)) != 0 || (!dedup && slots > kMaxSharedSlots))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dedup ? 0 : static_cast<size_t>(slots) * (sizeof(u64) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fingerprint_dedup_insert_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fingerprint_dedup_insert_kernel<<<1, kFusedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<u64*>(table), static_cast<const int*>(states),
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(gate), static_cast<u64*>(keys),
      static_cast<uint8_t*>(is_new), dedup, n, n_obj, width, mask, slots);
  return static_cast<int>(cudaGetLastError());
}
