// The visited set's probe, shared by every kernel that reaches the table:
// visited_set.cu's insert, delete and fused insert kernels and frontier.cu's
// compaction (which tombstones the fingerprints it drops), so that their
// probes cannot drift.
//
// The table: one 64-bit word a slot, hi << 32 | lo, 0 = empty, all ones =
// tombstone; 2^bits slots, mask = 2^bits - 1.  A key's probe sequence is the
// kProbes slots (home + r) & mask, r = 0 .. kProbes - 1, from home =
// (lo ^ (hi * 0x9E3779B1)) & mask, as in the JAX package's
// pushworld_tpu/ops/hashset.py (probe_and_insert, lines 105-154;
// probe_delete, lines 157-179).
//
// The window read.  The N_PROBES = 8 words of a key's sequence are loaded
// in one wave, before any of them is compared: one round trip where a
// slot-by-slot probe makes up to 8 dependent ones.  The words are read one
// each (the window wraps at mask, so no vector load may cross the table's
// end), through the L2-coherent path (__ldcg, never __ldg): other lanes of
// the same launch write the table.  Two layouts of the window:
//   - a group of 8 lanes a key (group_find_or_claim, group_delete): lane j
//     of the group reads slot (home + j) & mask, so a warp's load is 4
//     windows of 64 contiguous bytes, and __ballot_sync picks the first
//     lane that decides.  The standalone insert and delete kernels use it;
//   - one lane a key (delete_key): the lane's 8 independent loads into
//     registers.  The compaction uses it, in the threads that write the
//     dropped positions.
// A lane's own 8 loads are 8 scattered requests (32 sectors a warp
// instruction), and where a few SMs carry a whole batch (the insert kernel
// on 4 CTAs, the fused kernel on one) that traffic, not the round trip,
// set the time; the group's loads are coalesced.
//
// The insert scans the window in probe order: a word equal to the key means
// found; the first free word (empty or tombstone) is claimed with a 64-bit
// atomicCAS; a CAS that returns the key means found; a CAS that returns
// another word (another lane claimed the slot) moves on to the next slot of
// the window.  Its words may be stale by then, but in an insert launch a
// word only ever goes from free to a key, and a CAS on a stale free word
// returns the word that is there, so every decision is the one a fresh read
// would give.  Lanes still unplaced after the window are reported new
// (probe exhaustion: the key is not stored).
//
// The delete CASes the first slot in probe order that holds the key to the
// tombstone and stops there, whether or not its CAS won (a lane deleting
// the same key got there first).  Empty slots do not end the scan, as they
// do not end JAX's delete rounds.
//
// On lanes whose sequences no other lane of the launch writes, this is
// exactly JAX's round-by-round rule, including its corner: a key inserted
// again behind a tombstone is stored twice, and a delete removes its first
// copy.  find_or_claim_by_slot is the same rule read slot by slot (a load,
// then its compare, then the next load): the fused dedup kernel's form,
// which runs its batch in ONE CTA and there a window's 8 loads a lane cost
// more than the dependent probes they save (PERF.md has the times).
//
// Plain C++ for nvcc; no PyTorch headers.

#pragma once

#include <stdint.h>

namespace pw_probe {

typedef unsigned long long u64;

constexpr int kProbes = 8;
constexpr u64 kEmpty = 0ull;
constexpr u64 kTomb = ~0ull;

__device__ __forceinline__ unsigned int first_slot(u64 key, unsigned int mask) {
  const unsigned int lo = static_cast<unsigned int>(key);
  const unsigned int hi = static_cast<unsigned int>(key >> 32);
  return (lo ^ (hi * 0x9E3779B1u)) & mask;
}

// The kProbes words of the sequence from home, loaded in one wave.
__device__ __forceinline__ void load_window(const u64* table, unsigned int home, unsigned int mask,
                                            u64 (&w)[kProbes]) {
#pragma unroll
  for (int r = 0; r < kProbes; ++r) w[r] = __ldcg(table + ((home + r) & mask));
}

// Tombstones the first slot of key's sequence that holds it, if any: one
// lane, its window in registers.
__device__ __forceinline__ void delete_key(u64* table, u64 key, unsigned int mask) {
  const unsigned int home = first_slot(key, mask);
  u64 w[kProbes];
  load_window(table, home, mask, w);
#pragma unroll
  for (int r = 0; r < kProbes; ++r) {
    if (w[r] == key) {
      atomicCAS(table + ((home + r) & mask), key, kTomb);
      return;
    }
  }
}

// The group of 8 lanes (lanes 8g .. 8g + 7 of a warp) that holds one key.
// Every lane of the warp must call the group functions (full-warp ballots
// and shuffles); ``on`` is false for a group with no key to probe.
constexpr unsigned kFullWarp = 0xFFFFFFFFu;
static_assert(kProbes == 8, "a group is one warp's quarter");

// Lane j's word of its group's window: slot (home + j) & mask.
__device__ __forceinline__ u64 group_word(const u64* table, u64 key, bool on, unsigned int mask) {
  const unsigned int j = threadIdx.x & 7u;
  return on ? __ldcg(table + ((first_slot(key, mask) + j) & mask)) : kEmpty;
}

// The group's lanes (bits 0-7) where ``hit`` holds.
__device__ __forceinline__ unsigned group_ballot(bool hit) {
  return (__ballot_sync(kFullWarp, hit) >> (threadIdx.x & 24u)) & 0xFFu;
}

// The insert, given each lane's word of the window: true iff the key was
// found (every lane of the group gets the answer).
__device__ __forceinline__ bool group_find_or_claim(u64* table, u64 key, bool on, unsigned int mask, u64 cur) {
  const unsigned int j = threadIdx.x & 7u, g0 = threadIdx.x & 24u;
  enum { kGoOn = 0, kFound = 1, kClaimed = 2 };
  unsigned cand = group_ballot(on && (cur == key || cur == kEmpty || cur == kTomb));
  bool pending = on, found = false;
  while (__any_sync(kFullWarp, pending)) {
    const int f = __ffs(cand) - 1;  // the first lane that decides; -1: exhausted
    int res = kGoOn;
    if (pending && static_cast<int>(j) == f) {
      if (cur == key) {
        res = kFound;
      } else {
        const u64 old = atomicCAS(table + ((first_slot(key, mask) + j) & mask), cur, key);
        res = old == cur ? kClaimed : old == key ? kFound : kGoOn;
      }
    }
    res = __shfl_sync(kFullWarp, res, static_cast<int>(g0) + (f < 0 ? 0 : f));
    if (pending) {
      if (f < 0 || res != kGoOn) {
        pending = false;
        found = f >= 0 && res == kFound;
      } else {
        cand &= ~((2u << f) - 1u);  // the CAS was lost: the slots after it
      }
    }
  }
  return found;
}

// The delete, given each lane's word of the window.
__device__ __forceinline__ void group_delete(u64* table, u64 key, bool on, unsigned int mask, u64 cur) {
  const unsigned int j = threadIdx.x & 7u;
  const unsigned cand = group_ballot(on && cur == key);
  if (on && cand != 0u && static_cast<int>(j) == __ffs(cand) - 1)
    atomicCAS(table + ((first_slot(key, mask) + j) & mask), key, kTomb);
}

// The insert read slot by slot, one lane a key; true iff the key was found.
__device__ __forceinline__ bool find_or_claim_by_slot(u64* table, u64 key, unsigned int mask) {
  unsigned int slot = first_slot(key, mask);
  for (int r = 0; r < kProbes; ++r) {
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

}  // namespace pw_probe
