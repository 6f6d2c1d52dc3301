// Visited-set probe/insert and probe/delete over a packed 64-bit table.
//
// Replaces the JAX package's XLA probe rounds in pushworld_tpu/ops/hashset.py
// (probe_and_insert, lines 105-154; probe_delete, lines 157-179); there is no
// Pallas counterpart.  The JAX insert writes key_lo and key_hi with two
// scatters; on a GPU a scatter with duplicate indices has no defined winner,
// so the halves of a key could tear.  Here each slot is ONE 64-bit word
// (hi << 32 | lo; 0 = empty, all ones = tombstone) and a lane claims an
// empty or tombstoned slot with a 64-bit atomicCAS, so keys never tear.
//
// One thread per key.  Each probes up to N_PROBES consecutive slots from
// slot = (lo ^ (hi * 0x9E3779B1)) & mask, as the JAX code does: a slot
// holding the key means "found"; the first free slot (empty or tombstone)
// is claimed; a lost CAS moves on as the JAX round loser does.  Lanes still
// unplaced after the probes are reported new.
//
// Bound: bytes.  Each lane reads its key and flag, reads one to N_PROBES
// table words at random addresses and writes one word and one flag; there is
// no arithmetic to speak of.  Random 8-byte accesses use a 32-byte sector
// each, so the kernel runs far below the HBM rate at any batch the search
// gives it (4 * expand = 1024 keys); its cost is the launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kProbes = 8;
constexpr unsigned long long kEmpty = 0ull;
constexpr unsigned long long kTomb = ~0ull;
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned int first_slot(unsigned long long key, unsigned int mask) {
  const unsigned int lo = static_cast<unsigned int>(key);
  const unsigned int hi = static_cast<unsigned int>(key >> 32);
  return (lo ^ (hi * 0x9E3779B1u)) & mask;
}

__global__ void probe_and_insert_kernel(unsigned long long* __restrict__ table,
                                        const unsigned long long* __restrict__ keys,
                                        const uint8_t* __restrict__ valid,
                                        uint8_t* __restrict__ is_new, int n,
                                        unsigned int mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!valid[i]) {
    is_new[i] = 0;
    return;
  }
  const unsigned long long key = keys[i];
  unsigned int slot = first_slot(key, mask);
  bool found = false;
  for (int r = 0; r < kProbes; ++r) {
    // L2 read: other lanes of this launch may have claimed the slot.
    const unsigned long long cur = __ldcg(table + slot);
    if (cur == key) {
      found = true;
      break;
    }
    if (cur == kEmpty || cur == kTomb) {
      const unsigned long long old = atomicCAS(table + slot, cur, key);
      if (old == cur) break;  // claimed
      if (old == key) {
        found = true;
        break;
      }
    }
    slot = (slot + 1u) & mask;
  }
  is_new[i] = found ? 0 : 1;
}

__global__ void probe_delete_kernel(unsigned long long* __restrict__ table,
                                    const unsigned long long* __restrict__ keys,
                                    const uint8_t* __restrict__ valid, int n,
                                    unsigned int mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const unsigned long long key = keys[i];
  unsigned int slot = first_slot(key, mask);
  for (int r = 0; r < kProbes; ++r) {
    if (__ldcg(table + slot) == key) {
      atomicCAS(table + slot, key, kTomb);
      return;
    }
    slot = (slot + 1u) & mask;
  }
}

}  // namespace

extern "C" int pw_probe_and_insert(void* table, const void* keys, const void* valid,
                                   void* is_new, int n, unsigned int mask, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  probe_and_insert_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(table), static_cast<const unsigned long long*>(keys),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(is_new), n, mask);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pw_probe_delete(void* table, const void* keys, const void* valid, int n,
                               unsigned int mask, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  probe_delete_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(table), static_cast<const unsigned long long*>(keys),
      static_cast<const uint8_t*>(valid), n, mask);
  return static_cast<int>(cudaGetLastError());
}
