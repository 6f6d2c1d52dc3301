// Visited set over a packed 64-bit table: probe/insert, probe/delete, and
// the search iteration's fused fingerprint + batch dedup + probe/insert.
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
// Probing (insert_key, shared by both insert kernels so they cannot drift):
// up to N_PROBES consecutive slots from slot = (lo ^ (hi * 0x9E3779B1)) &
// mask, as the JAX code does: a slot holding the key means "found"; the
// first free slot (empty or tombstone) is claimed; a lost CAS moves on as
// the JAX round loser does.  Lanes still unplaced after the probes are
// reported new.
//
// Bound: bytes.  A lane moves a few dozen bytes (the fused kernel 8N + 1 in,
// 9 out, one table word read and one written) at random 8-byte addresses;
// there is no arithmetic to speak of.  At the batch the search gives (4 *
// expand = 1,024 lanes) the cost of any of these kernels is its launch, so
// nothing inside one can be made faster: what can be saved is launches.
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
//   3. insert_key for the first occurrences, is_new written out.
// The dedup table lives in shared memory (2,048 slots, 24 KB, at n = 1,024;
// up to 16,384 slots, 192 KB, for n <= 8,192); a larger batch passes a
// scratch table in device memory and the same code runs on it.  One CTA is
// enough: the work is a few microseconds, and a single CTA needs no grid
// barrier between the claims and the owner reads.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kProbes = 8;
constexpr u64 kEmpty = 0ull;
constexpr u64 kTomb = ~0ull;
constexpr int kThreads = 256;
constexpr int kFusedThreads = 1024;
constexpr int kNoOwner = 0x7FFFFFFF;
constexpr int kMaxSharedSlots = 16384;  // 12 bytes each: 192 KB

__device__ __forceinline__ unsigned int first_slot(u64 key, unsigned int mask) {
  const unsigned int lo = static_cast<unsigned int>(key);
  const unsigned int hi = static_cast<unsigned int>(key >> 32);
  return (lo ^ (hi * 0x9E3779B1u)) & mask;
}

// Probes the table for key and claims a free slot if it is absent.  Returns
// true iff the key was found.
__device__ __forceinline__ bool insert_key(u64* __restrict__ table, u64 key, unsigned int mask) {
  unsigned int slot = first_slot(key, mask);
  for (int r = 0; r < kProbes; ++r) {
    // L2 read: other lanes of this launch may have claimed the slot.
    const u64 cur = __ldcg(table + slot);
    if (cur == key) return true;
    if (cur == kEmpty || cur == kTomb) {
      const u64 old = atomicCAS(table + slot, cur, key);
      if (old == cur) return false;  // claimed
      if (old == key) return true;
    }
    slot = (slot + 1u) & mask;
  }
  return false;
}

__global__ void probe_and_insert_kernel(u64* __restrict__ table, const u64* __restrict__ keys,
                                        const uint8_t* __restrict__ valid,
                                        uint8_t* __restrict__ is_new, int n, unsigned int mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  is_new[i] = valid[i] && !insert_key(table, keys[i], mask);
}

__global__ void probe_delete_kernel(u64* __restrict__ table, const u64* __restrict__ keys,
                                    const uint8_t* __restrict__ valid, int n, unsigned int mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const u64 key = keys[i];
  unsigned int slot = first_slot(key, mask);
  for (int r = 0; r < kProbes; ++r) {
    if (__ldcg(table + slot) == key) {
      atomicCAS(table + slot, key, kTomb);
      return;
    }
    slot = (slot + 1u) & mask;
  }
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
                                const uint8_t* __restrict__ valid, u64* __restrict__ keys,
                                uint8_t* __restrict__ is_new, void* dedup, int n, int n_obj,
                                unsigned int width, unsigned int mask, int slots) {
  extern __shared__ __align__(8) unsigned char smem[];
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
      fresh = vowner[s] == i && !insert_key(table, key, mask);
    }
    is_new[i] = fresh;
  }
}

}  // namespace

extern "C" int pw_probe_and_insert(void* table, const void* keys, const void* valid,
                                   void* is_new, int n, unsigned int mask, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  probe_and_insert_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<u64*>(table), static_cast<const u64*>(keys),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(is_new), n, mask);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pw_probe_delete(void* table, const void* keys, const void* valid, int n,
                               unsigned int mask, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  probe_delete_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<u64*>(table), static_cast<const u64*>(keys),
      static_cast<const uint8_t*>(valid), n, mask);
  return static_cast<int>(cudaGetLastError());
}

// The largest dedup table (in slots) that the fused kernel keeps in shared
// memory; a batch that needs more passes a table in device memory.
extern "C" int pw_dedup_shared_slots() { return kMaxSharedSlots; }

// dedup: null, or slots * 12 bytes of device scratch (8-byte aligned); the
// kernel clears it.  slots: a power of two >= 2n, at most
// pw_dedup_shared_slots() when dedup is null.
extern "C" int pw_fingerprint_dedup_insert(void* table, const void* states, const void* valid,
                                           void* keys, void* is_new, void* dedup, int n,
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
      static_cast<const uint8_t*>(valid), static_cast<u64*>(keys),
      static_cast<uint8_t*>(is_new), dedup, n, n_obj, width, mask, slots);
  return static_cast<int>(cudaGetLastError());
}
