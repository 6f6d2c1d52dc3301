// The search iteration's frontier bookkeeping: the gate and the selection,
// the compaction of the ring, and the append of the scored children (history,
// goal, priority keys, window, counters).  Three kernels, one launch each.
//
// Replaces XLA code of the JAX package, not a TPU kernel, in
// pushworld_tpu/search/batched.py: _select_frontier (lines 520-534, a top-k
// of the int32 keys), _append_history (439-454), _append_frontier (457-517,
// with the lax.cond of its compaction at 504), the goal resolution, the
// priority keys and the counters of _iterate (537-623), and run_chunk's gate
// (the fixed trip count's cond).  Their plain PyTorch form
// (pushworld_tpu_torch/search/batched.py *_reference) is some 150 kernels an
// iteration, two stable sorts of the F keys among them.
//
// Keys.  Every key is a non-negative int32 at most EMPTY = 0x7F000000 (a free
// slot).  The kernels order keys as unsigned words with the sign bit flipped,
// which is the int32 order, and carry a slot beside a key as one 64-bit word
// (key << 32 | slot), so that (key, slot) order is the order of the words and
// no two words are equal.
//
// The select and the compaction: one cluster of kCluster = 8 CTAs of 1,024
// threads (the portable cluster size of sm_90), each CTA on an SM of its own.
// CTA c owns the tile of slots [c * T, c * T + T), T = ceil(F / 8).  The CTAs
// exchange through distributed shared memory (a CTA reads and writes the
// others' shared memory) and meet at the cluster barrier, which the hardware
// keeps: no cooperative launch, no counter in device memory and no grid-wide
// barrier through L2, and a launch captures into a CUDA graph as any other.
// Eight CTAs, not one per 1,024 keys: 8 is the largest cluster that every
// sm_90 card schedules without a non-portable attribute, and on the H100 a
// cluster of 16 sped the compaction up but slowed the select down (its
// regions go to twice as many CTAs).  A tile too
// large for shared memory (F above ~96K for the compaction and ~200K for the
// select, at B = 256) lives in device scratch instead, through the same
// code: the pointers are generic.
//
// pw_frontier_select.  The gate first, as the JAX package's run_chunk reads
// it before an iteration: not solved and the history cursor below its limit
// (every CTA reads them, so all agree; the sharded search passes no gate
// inputs: always open), then a key below EMPTY (the tiles' lowest words).
// The gate goes to a device flag that the iteration's later kernels read; a
// closed gate writes sel_valid = 0 and the flag, and nothing else.  Else the
// B lowest words, EMPTY slots included when fewer than B are live (their
// lanes feed children that land in the window with EMPTY keys):
//   1. each CTA takes the min(B, T) lowest words of its tile (block_lowest: a
//      radix select over the keys from the top byte, a histogram in shared
//      memory a pass, which stops once the words that match its prefix are
//      exactly those still wanted, or once they share their key: then the
//      first of them in slot order are taken, in order, with no pass over
//      the slots), places the words below a tied key by counting for each
//      the words below it (at most B^2 comparisons spread over the CTA) and
//      writes them in order into its region in every CTA's shared memory,
//      padded with all-ones words;
//   2. after the cluster barrier every CTA reads the gate from the regions'
//      first words and gives each of its own candidates its row: the words
//      below it in the 8 sorted regions, by binary lifting in the 8 in step.
//      The candidates of row < B are the B lowest words in (key, slot)
//      order; their CTAs free the live ones and gather parents, parent_hist
//      and sel_valid.
// Nothing is written before the barrier, so a closed gate writes nothing else.
//
// pw_frontier_compact.  need = gate and cursor + nb > F, read on the device
// by every CTA before the first cluster barrier (CTA 0 writes the cursor only
// after the last); without need every CTA returns at once, after one read of
// the gate and the cursor.  Else, as the
// lax.cond branch: a stable sort of the F keys, an LSD radix sort of the
// words by key, 4 passes of 8 bits.  In a pass each CTA counts its tile's
// digits by (digit, warp), warp w owning a contiguous range that it ranks in
// order (the lanes of equal digit by __match_any_sync, only in the scatter:
// counting needs none), a word after its digit's words in the lower warps;
// across the
// cluster each CTA reads the others' digit totals and places its group of a
// digit after every lower digit and after the lower tiles' words of that
// digit, so the sort stays stable; the words go straight into the shared
// memory of the CTA that owns their new position.  A pass whose digit is the
// same for every word (the cluster's totals say so, alike in every CTA) moves
// nothing and is skipped.  Each CTA copies the states, hist and fingerprints
// of its own slots to scratch before the passes and, after them, permutes its
// own positions from the copies; live slots at or beyond keep are dropped
// (EMPTY), and the thread that writes a dropped position tombstones its
// fingerprint in the visited set itself, with visited_probe.cuh's delete
// (the window of 8 slots in one wave, then one CAS), so the iteration needs
// no delete launch, drop mask or need flag; cursor = min(live, keep),
// evictions += dropped.  The drops are distinct positions: two lanes race
// on one slot only where probe exhaustion let one key into the frontier
// twice, exactly as two lanes of a delete launch would.
//
// pw_frontier_append.  With the gate open: the history index of each new
// child is cursor + its rank among the new lanes in lane order; the
// (parent, action) records are written, the cursor advances, clamped
// margin short of the capacity.  The priority key of a new child is
// novelty << 28 | clamp(rgd, 0, 8190) << 15 | (~hist_idx & 0x7FFF), EMPTY
// for the others; keys, states, history indices and fingerprints go to the
// window at the ring cursor, which advances by nb.  The first goal among
// the new children in lane order solves the search (solved_hist kept once
// solved); iterations += 1, expansions += the selected parents,
// needs_deeper += the flagged new children.  Lanes are in action-block
// order; a parent array of length B is read at lane % B, an rgd/deeper
// array of length B (the lazy mode's per-parent values) at lane % B, and the
// action of a lane is lane / B unless an actions array is given (the
// sharded search's received children).  Since PR 11 a cluster of 8 CTAs
// (PR 9's was one CTA of 1,024 threads: a block-wide scan with three
// barriers, every load after a store that might alias it, and a serial
// tail of dependent reads in thread 0).  CTA c owns
// the lanes [c * per, c * per + per), per = ceil(nb / 8), one a thread (in
// rounds above 512).  The gate is read alone first, so a closed gate costs
// one load and writes nothing but the loop tail's scalars.  Then every
// load that does not wait on another (the cursors, the counters, the
// lane's inputs, the first vectors of the state copy), through the
// read-only path.  The ranks: a ballot of
// the new lanes a warp (rank = carry + the warp's offset + popc(ballot &
// lanes below)), of the new goals and of the deeper flags; one CTA
// barrier; warp 0 scans the words, finds the tile's first new goal and its
// rank, and writes the tile's sums into every CTA's shared memory
// (distributed shared memory); the cluster barrier, split: between its
// arrive and its wait the states (16-byte vectors where the rows allow) and
// the fingerprints go to the window, which need no rank.  Then each warp
// has the lower tiles' carry, the totals and the first goal from the 8
// sums; CTA 0 writes the counters once, from values on chip (nothing is
// read back from device memory), and every lane its history record, index,
// key and window slot.  Every CTA reads the cursors before the barrier and
// CTA 0 writes them after it, which is what the cluster buys: independent
// CTAs, each counting the new lanes below it, were tried in PR 11 and
// cannot order those reads before that write.  No device counter and no
// cooperative launch: it captures into a CUDA graph as any launch.
//
// The loop tail: the end of a search chunk loop's body (chunk_loop.cu), the
// counterpart of JAX's run_chunk fori_loop count and its lax.cond on `active`
// (pushworld_tpu/search/batched.py:646-655).  Where the caller passes a
// loop's scalars, the writer thread (CTA 0, thread 0) decides whether the
// loop runs another body, from the values it has just written and still holds
// in registers (no reload of what another CTA may be writing):
//   c = gate && !solved && hist_cursor < loop_limit && --remaining > 0
// and writes remaining, the flag c and bodies + 1, and sets the loop's
// condition to c.  On a closed gate it does so too, before it returns (c =
// 0): the condition's default (1) is applied once a launch, so a closed body
// that left it would loop for ever.  Folded into the append, the body's last
// kernel, the decision costs no kernel node of its own.
//
// Order of effects: JAX appends the history, then compacts, then writes
// the window.  History and compaction touch disjoint arrays, so the search
// runs the compaction first and the append after it; the visited set's
// deletes still come after the iteration's inserts.
//
// Bound.  The select reads the F keys once (128 KB at 2^15) and moves the
// selected states (B * 8N bytes); a compaction reads and writes the keys,
// states, hist and fingerprints once, F * (8N + 16) bytes each way (3.2 MB
// at F = 2^15, N = 4: 0.001 ms at 3.35 TB/s); the append moves ~40 bytes a
// lane.  At the search's sizes every kernel is bound by latency, not bytes:
// the select by its chain of CTA barriers (2 a radix pass, a few around
// them) and one cluster barrier, the compaction by its sort
// passes (5 CTA barriers and 2 cluster barriers each) and by moving the
// states through 8 SMs (the copies and the permutation, with 8 loads in
// flight a thread) and, when it evicts, by its deletes (a window and a CAS
// a dropped entry, in the CTAs that own the positions at or beyond keep);
// the append by the launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "visited_probe.cuh"

namespace cg = cooperative_groups;

// Phase marks for scripts/profile_kernel_phases.py (no-ops here).
#ifndef PW_STOP
#define PW_STOP(k, v)
#endif

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;  // every kernel here: CTAs of 32 warps
constexpr int kCluster = 8;     // the select's and the compaction's CTAs: one cluster
constexpr int kEmpty = 0x7F000000;
constexpr int kMaxSmem = 232448;  // a CTA's shared memory on sm_90
constexpr u64 kPad = ~0ull;       // above every word: a slot is below 2^26
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned ord(int key) { return static_cast<unsigned>(key) ^ 0x80000000u; }
__device__ __forceinline__ int unord(unsigned u) { return static_cast<int>(u ^ 0x80000000u); }
__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }
__device__ __forceinline__ int slot_of(u64 w) { return static_cast<int>(static_cast<unsigned>(w)); }
__device__ __forceinline__ int key_of(u64 w) { return unord(static_cast<unsigned>(w >> 32)); }

// The AND and the OR of v over the warp.
__device__ __forceinline__ u64 and_reduce(u64 v) {
  return static_cast<u64>(__reduce_and_sync(kFull, static_cast<unsigned>(v >> 32))) << 32 |
         __reduce_and_sync(kFull, static_cast<unsigned>(v));
}
__device__ __forceinline__ u64 or_reduce(u64 v) {
  return static_cast<u64>(__reduce_or_sync(kFull, static_cast<unsigned>(v >> 32))) << 32 |
         __reduce_or_sync(kFull, static_cast<unsigned>(v));
}

// hist[d] += 1 for each lane with on: one add of 32 where the whole warp has
// one digit (a tile of EMPTY slots), else a shared atomic a lane (faster on
// the H100 than aggregating equal digits with __match_any_sync or ballots).
// Every lane of the warp must call it.
__device__ __forceinline__ void warp_count(int* hist, unsigned d, bool on) {
  const unsigned d0 = __shfl_sync(kFull, d, 0);
  if (__all_sync(kFull, on && d == d0)) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&hist[d0], 32);
  } else if (on) {
    atomicAdd(&hist[d], 1);
  }
}

// Exclusive prefix sum of v over the CTA's 1,024 threads, in thread order;
// *total gets the sum.  sh holds 33 ints.  Every thread must call it.
__device__ int block_exclusive_scan(int v, int* total, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = sh[lane];
    int incl = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    sh[lane] = incl - w;
    if (lane == 31) sh[32] = incl;
  }
  __syncthreads();
  const int out = sh[warp] + x - v;
  *total = sh[32];
  __syncthreads();
  return out;
}

// dst[i] = src[i] for i in [0, n) over the CTA, up to kIlp loads (64 bytes)
// in flight a thread (one load at a time leaves one SM a few GB/s).
constexpr int kIlp = 8;
template <class V>
__device__ void block_copy(V* __restrict__ dst, const V* __restrict__ src, size_t n) {
  constexpr int kU = sizeof(V) > 8 ? kIlp / 2 : kIlp;
  for (size_t base = threadIdx.x; base < n; base += static_cast<size_t>(kThreads) * kU) {
    V v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const size_t i = base + static_cast<size_t>(u) * kThreads;
      if (i < n) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const size_t i = base + static_cast<size_t>(u) * kThreads;
      if (i < n) dst[i] = v[u];
    }
  }
}

// ---------------------------------------------------------------- select

struct LowestShared {
  __align__(16) int hist[2][256];  // by pass parity: one is counted while the other is zeroed
  u64 wand[32], wor[32];           // a warp's AND and OR of the words a pass counted
  u64 all_and, all_or;             // the CTA's
  int wcount[32];                  // a warp's words of the tied key
  int digit, below, eq, count;
};

// The words of the slots [lo, lo + m), from the keys in device memory.
struct KeyWords {
  const int* h;
  int lo;
  __device__ u64 operator()(int i) const {
    return static_cast<u64>(ord(h[lo + i])) << 32 | static_cast<unsigned>(lo + i);
  }
};

// Words held in memory (shared, another CTA's shared, or device).
struct Words {
  const u64* w;
  __device__ u64 operator()(int i) const { return w[i]; }
};

// Writes the take lowest of the m distinct words src(0), ..., src(m - 1)
// (take <= m; words of equal key in slot order, as a tile's are) to
// out[0, take) and returns n: out[0, n) holds the words below the tied key
// in no set order, out[n, take) the tied words in order (n = take when no
// key ties).  A radix select over the keys from the top byte: a pass
// histograms the next 8 bits of the words that match the prefix so far
// (warp_count) and warp 0 finds the digit of the take-th lowest.  The pass
// also ANDs and ORs the words it counts: the words that match the new prefix
// agree wherever those all did, so the next pass starts at the highest byte
// in which they differ.  It stops once the words that match are exactly
// those still wanted (every word <= prefix | ~mask is taken), or once they
// all have one key: then every lower key is taken, and of that key the
// first words in slot order, by a scan over the warps' contiguous ranges (a
// tile cut among its EMPTY slots takes 1 pass, as the top byte of EMPTY is
// no other key's; a tile of one key takes 1 pass; no pass goes over the
// slots).  Two barriers a pass.  Every thread of the CTA calls it, with
// sh.hist[0] zeroed before a barrier; it ends with a barrier.
template <class Src>
__device__ int block_lowest(const Src& src, int m, int take, u64* out, LowestShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  u64 lim = ~0ull;   // every word <= lim is taken,
  u64 tie = kPad;    // and of the key tie >> 32 the first tie_take words
  int tie_take = 0;
  if (take < m) {
    u64 prefix = 0ull, mask = 0ull;
    int k = take;  // the words still wanted among those that match the prefix
    for (int pass = 0, shift = 56; pass < 4; ++pass) {
      int* hist = sh.hist[pass & 1];
      // The other histogram was last read by warp 0 before the previous
      // pass's second barrier.
      if (tid < 256) sh.hist[(pass + 1) & 1][tid] = 0;
      u64 w_and = ~0ull, w_or = 0ull;
      for (int base = warp * 32; base < m; base += kThreads) {
        const int i = base + lane;
        const u64 u = i < m ? src(i) : 0ull;
        const bool on = i < m && (u & mask) == prefix;
        warp_count(hist, static_cast<unsigned>(u >> shift) & 255u, on);
        if (on) {
          w_and &= u;
          w_or |= u;
        }
      }
      w_and = and_reduce(w_and);
      w_or = or_reduce(w_or);
      if (lane == 0) sh.wand[warp] = w_and, sh.wor[warp] = w_or;
      __syncthreads();
      if (warp == 0) {
        // all_and and all_or were last read before this pass's first barrier.
        const u64 all_and = and_reduce(sh.wand[lane]), all_or = or_reduce(sh.wor[lane]);
        if (lane == 0) sh.all_and = all_and, sh.all_or = all_or;
        const int4 lo4 = reinterpret_cast<const int4*>(hist)[2 * lane];
        const int4 hi4 = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
        const int c[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
        int sum = 0;
        for (int j = 0; j < 8; ++j) sum += c[j];
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        int run = incl - sum;
        if (run < k && k <= incl) {
          for (int j = 0; j < 8; ++j) {
            if (run + c[j] >= k) {
              sh.digit = lane * 8 + j;
              sh.below = run;
              sh.eq = c[j];
              break;
            }
            run += c[j];
          }
        }
      }
      __syncthreads();
      prefix |= static_cast<u64>(sh.digit) << shift;
      mask |= 255ull << shift;
      k -= sh.below;
      if (sh.eq == k) {  // read by all before warp 0 writes again, a barrier on
        lim = prefix | ~mask;
        break;
      }
      if (pass == 0 && sh.digit == (ord(kEmpty) >> 24)) {
        // No key is above EMPTY, so the words of this top byte are EMPTY's.
        tie = static_cast<u64>(ord(kEmpty)) << 32;
        tie_take = k;
        lim = tie - 1;
        break;
      }
      // Two or more words match and differ below shift (they are distinct),
      // so diff is not 0; the bytes above the highest set bit of diff join
      // the prefix as they are.  Where that bit is in the slot, the words
      // that match share their key.
      const u64 lower = (1ull << shift) - 1;
      const u64 diff = (sh.all_and ^ sh.all_or) & lower;
      const int next = (63 - __clzll(static_cast<long long>(diff))) & ~7;
      const u64 same = lower & ~((1ull << (next + 8)) - 1);
      prefix |= sh.all_and & same;
      mask |= same;
      if (next < 32) {
        tie = prefix & ~0xFFFFFFFFull;
        tie_take = k;
        lim = tie - 1;
        break;
      }
      shift = next;
    }
  }
  // Warp w walks the contiguous range [wlo, whi) in order; a word of the tied
  // key is taken when fewer than tie_take such words come before it.
  const int chunk = (m + 31) / 32;
  const int wlo = min(warp * chunk, m), whi = min(wlo + chunk, m);
  int before = 0;  // this warp's range: the tied words of the lower warps
  if (tid == 0) sh.count = 0;
  if (tie_take > 0) {
    int n_tie = 0;
    for (int base = wlo; base < whi; base += 32) {
      const int i = base + lane;
      n_tie += __popc(__ballot_sync(kFull, i < whi && (src(i) & ~0xFFFFFFFFull) == tie));
    }
    if (lane == 0) sh.wcount[warp] = n_tie;
    __syncthreads();
    const int w = sh.wcount[lane];
    int incl = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    before = __shfl_sync(kFull, incl - w, warp);
  } else {
    __syncthreads();
  }
  // The words below the tied key (or lim) go to out[0, n), a warp's in a
  // round at a place from one atomic; a tied word goes to out[n + its rank].
  const int n = take - tie_take;
  int ties = before;
  for (int base = wlo; base < whi; base += 32) {
    const int i = base + lane;
    const u64 u = i < whi ? src(i) : kPad;
    const bool below = i < whi && u <= lim;
    const unsigned ballot = __ballot_sync(kFull, below);
    if (ballot != 0u) {
      int at = 0;
      if (lane == 0) at = atomicAdd(&sh.count, __popc(ballot));
      at = __shfl_sync(kFull, at, 0);
      if (below) out[at + __popc(ballot & lanes_below(lane))] = u;
    }
    if (tie_take > 0) {
      const unsigned tied = __ballot_sync(kFull, i < whi && (u & ~0xFFFFFFFFull) == tie);
      const int r = ties + __popc(tied & lanes_below(lane));
      if ((tied >> lane & 1u) && r < tie_take) out[n + r] = u;
      ties += __popc(tied);
    }
  }
  __syncthreads();
  return n;
}

struct Select {
  int* h;                     // (F,) keys; selected live slots become EMPTY
  const int* states;          // (F, n, 2)
  const int* fhist;           // (F,)
  const uint8_t* solved;      // scalar, or null: no gate (always open)
  const int* hist_cursor;     // scalar (with solved)
  int hist_limit;
  int* parents;               // (B, n, 2)
  int* parent_hist;           // (B,)
  uint8_t* sel_valid;         // (B,)
  uint8_t* gate;              // scalar or null
  u64* scratch;               // the regions when they do not fit in shared memory
  int F, B, n;
  int T, stride;              // slots a tile, ceil(F / kCluster); words a region, min(B, T)
  int cand_in_smem;
};

// Dynamic shared memory, laid out alike in every CTA: the tile's lowest
// words (stride), the 8 regions (kCluster * stride words) when
// cand_in_smem, the tile's words (T) when kTileInSmem, then their ranks
// (stride ints).
template <bool kTileInSmem>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1) select_kernel(Select s) {
  extern __shared__ __align__(16) u64 dyn[];
  __shared__ LowestShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  u64* low = dyn;
  u64* cand = low + s.stride;
  u64* tile = cand + (s.cand_in_smem ? kCluster * s.stride : 0);
  int* rank = reinterpret_cast<int*>(tile + (kTileInSmem ? s.T : 0));

  // 1. The gate: solved and the history first (after a solve the gate closes
  // without a look at the keys).
  if (s.solved != nullptr && (*s.solved || *s.hist_cursor >= s.hist_limit)) {
    if (c == 0) {
      if (tid == 0 && s.gate != nullptr) *s.gate = 0;
      for (int r = tid; r < s.B; r += kThreads) s.sel_valid[r] = 0;
    }
    return;
  }

  // 2. The tile's min(B, m) lowest words, sorted, into region c of every
  // CTA, padded.  block_lowest finds the first histogram zeroed.
  const int lo = min(c * s.T, s.F);
  const int m = min(s.T, s.F - lo);
  const int take = min(s.B, m);
  if (tid < 256) sh.hist[0][tid] = 0;
  int unsorted;
  if (kTileInSmem) {
    for (int base = tid; base < m; base += kThreads * kIlp) {
      int key[kIlp];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) key[u] = base + u * kThreads < m ? s.h[lo + base + u * kThreads] : 0;
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int i = base + u * kThreads;
        if (i < m) tile[i] = static_cast<u64>(ord(key[u])) << 32 | static_cast<unsigned>(lo + i);
      }
    }
    __syncthreads();
    unsorted = block_lowest(Words{tile}, m, take, low, sh);
  } else {
    __syncthreads();
    unsorted = block_lowest(KeyWords{s.h, lo}, m, take, low, sh);
  }
  // low[0, unsorted) are placed by counting the words below each (parts
  // threads a word, each counting a span); the tied words after them are in
  // place already.
  if (unsorted > 1) {
    for (int r = tid; r < unsorted; r += kThreads) rank[r] = 0;
    __syncthreads();
    const int parts = unsorted >= kThreads ? 1 : kThreads / unsorted;
    const int span = (unsorted + parts - 1) / parts;
    for (int idx = tid; idx < unsorted * parts; idx += kThreads) {
      const int r = idx % unsorted, q = idx / unsorted;
      const u64 w = low[r];
      const int j1 = min(unsorted, (q + 1) * span);
      int below = 0;
      for (int j = q * span; j < j1; ++j) below += low[j] < w;
      if (below != 0) atomicAdd(&rank[r], below);
    }
    __syncthreads();
  }
  // Region c: in every CTA's shared memory when they fit, else once in scratch.
  if (s.cand_in_smem) {
    for (int idx = tid; idx < kCluster * s.stride; idx += kThreads) {
      const int q = idx / s.stride, r = idx - q * s.stride;
      const int at = r < unsorted && unsorted > 1 ? rank[r] : r;
      cluster.map_shared_rank(cand, q)[c * s.stride + at] = r < take ? low[r] : kPad;
    }
  } else {
    for (int r = tid; r < s.stride; r += kThreads)
      s.scratch[static_cast<size_t>(c) * s.stride + (r < unsorted && unsorted > 1 ? rank[r] : r)] =
          r < take ? low[r] : kPad;
  }
  // Thread r owns the candidate low[r]: its history index and the first
  // kRowRegs int2 of its state row are loaded while the cluster meets.
  constexpr int kRowRegs = 4;
  const int2* rows = reinterpret_cast<const int2*>(s.states);  // a state row is n int2
  u64 w = kPad;
  int hist_of = 0;
  int2 row_of[kRowRegs];
  if (tid < take) {
    w = low[tid];
    const int slot = slot_of(w);
    hist_of = s.fhist[slot];
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j)
      if (j < s.n) row_of[j] = rows[static_cast<size_t>(slot) * s.n + j];
  }
  cluster.sync();  // the regions are written; no CTA reads h or another's memory again

  // 3. The gate from the regions' first words, alike in every CTA.
  const u64* regions = s.cand_in_smem ? cand : s.scratch;
  u64 first = kPad;
  for (int q = 0; q < kCluster; ++q) {
    const u64 head = regions[static_cast<size_t>(q) * s.stride];
    first = head < first ? head : first;
  }
  const bool open = s.solved == nullptr || key_of(first) < kEmpty;
  if (!open) {
    if (c == 0) {
      if (tid == 0 && s.gate != nullptr) *s.gate = 0;
      for (int r = tid; r < s.B; r += kThreads) s.sel_valid[r] = 0;
    }
    return;
  }
  if (c == 0 && tid == 0 && s.gate != nullptr) *s.gate = 1;

  // 4. Each CTA's candidates: a candidate's row is the number of words below
  // it in the 8 sorted regions (its own place in its own), by binary lifting
  // in the 8 in step; the B lowest of the F words are those of row < B.
  // Free the live ones and write their rows.
  int top = 1;
  while (2 * top <= s.stride) top *= 2;
  int2* out = reinterpret_cast<int2*>(s.parents);
  for (int r = tid; r < take; r += kThreads) {
    if (r >= kThreads) {  // only where take > 1,024: no registers loaded
      w = low[r];
      hist_of = s.fhist[slot_of(w)];
#pragma unroll
      for (int j = 0; j < kRowRegs; ++j)
        if (j < s.n) row_of[j] = rows[static_cast<size_t>(slot_of(w)) * s.n + j];
    }
    int pos[kCluster] = {};
    for (int bit = top; bit > 0; bit >>= 1) {
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        const int t = pos[q] + bit;
        if (t <= s.stride && regions[static_cast<size_t>(q) * s.stride + t - 1] < w) pos[q] = t;
      }
    }
    int row = 0;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) row += pos[q];
    if (row >= s.B) continue;
    const int slot = slot_of(w);
    const bool valid = key_of(w) < kEmpty;
    s.sel_valid[row] = valid;
    s.parent_hist[row] = hist_of;
    if (valid) s.h[slot] = kEmpty;
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j)
      if (j < s.n) out[static_cast<size_t>(row) * s.n + j] = row_of[j];
    for (int j = kRowRegs; j < s.n; ++j)
      out[static_cast<size_t>(row) * s.n + j] = rows[static_cast<size_t>(slot) * s.n + j];
  }
}

// ---------------------------------------------------------------- compact

struct Compact {
  int* h;                     // (F,)
  int* states;                // (F, n, 2)
  int* fhist;                 // (F,)
  long long* fkey;            // (F,) packed fingerprints
  int* ring_cursor;           // scalar
  int* evictions;             // scalar
  u64* table;                 // the visited set (mask + 1,) packed words: dropped fingerprints are tombstoned
  const uint8_t* gate;        // scalar or null: open
  u64* sort;                  // (2F,) scratch: the words when a tile does not fit in shared memory
  int* states_copy;           // (F, n, 2) scratch
  int* hist_copy;             // (F,) scratch
  long long* key_copy;        // (F,) scratch
  int F, n, nb, keep;
  int T;                      // slots a tile, ceil(F / kCluster)
  unsigned mask;              // the visited set's slots - 1
};

constexpr int kOffRow = 257;  // off[warp * kOffRow + digit]: a warp's digits in distinct banks

struct SortShared {
  int off[32 * kOffRow];  // per (warp, digit): counts, then the warp's words before it of the digit
  int tot[2][256];    // the tile's count of each digit, by pass parity (the other CTAs read it)
  __align__(16) int all[256];  // the array's count of each digit
  int below[256];     // the lower tiles' count of each digit
  int delta[256];     // where the tile's words of a digit start in the array
  int live, skip;
};

// Copies the rows of the positions [0, m) from rows[slot] (per V's a row),
// slot by slot as the sorted words fin say, 64 bytes in flight a thread.
template <class V>
__device__ void gather_rows(V* __restrict__ out, const V* __restrict__ rows, const u64* fin, int m, int per) {
  constexpr int kU = sizeof(V) > 8 ? kIlp / 2 : kIlp;
  const int total = m * per;
  for (int base = threadIdx.x; base < total; base += kThreads * kU) {
    V v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = base + u * kThreads;
      if (j < total) {
        const int p = j / per;
        v[u] = rows[static_cast<size_t>(slot_of(fin[p])) * per + (j - p * per)];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (base + u * kThreads < total) out[base + u * kThreads] = v[u];
  }
}

// Dynamic shared memory (kSmem): the two buffers of the tile's words, T each.
template <bool kSmem>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1) compact_kernel(Compact c) {
  extern __shared__ __align__(16) u64 dyn[];
  __shared__ SortShared ss;
  cg::cluster_group cluster = cg::this_cluster();
  const int me = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool need = (c.gate == nullptr || *c.gate) && *c.ring_cursor + c.nb > c.F;
  if (!need) return;
  const int lo = min(me * c.T, c.F);
  const int m = min(c.T, c.F - lo);
  // Buffer b holds the array's positions [q * T, q * T + T) in CTA q.
  auto buffer = [&](int b, int q) -> u64* {
    return kSmem ? cluster.map_shared_rank(dyn + b * c.T, q)
                 : c.sort + static_cast<size_t>(b) * c.F + static_cast<size_t>(q) * c.T;
  };
  u64* own[2] = {kSmem ? dyn : c.sort + lo, kSmem ? dyn + c.T : c.sort + c.F + lo};

  // The copies of the tile's slots, its words in slot order, its live count.
  // A state row is n int2 (n / 2 int4 where n is even).
  const size_t row0 = static_cast<size_t>(lo) * c.n;
  if (c.n % 2 == 0)
    block_copy(reinterpret_cast<int4*>(c.states_copy + 2 * row0), reinterpret_cast<const int4*>(c.states + 2 * row0),
               static_cast<size_t>(m) * c.n / 2);
  else
    block_copy(reinterpret_cast<int2*>(c.states_copy) + row0, reinterpret_cast<const int2*>(c.states) + row0,
               static_cast<size_t>(m) * c.n);
  block_copy(c.hist_copy + lo, c.fhist + lo, m);
  block_copy(c.key_copy + lo, c.fkey + lo, m);
  int live = 0;
  for (int base = tid; base < m; base += kThreads * kIlp) {
    int key[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) key[u] = base + u * kThreads < m ? c.h[lo + base + u * kThreads] : kEmpty;
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int i = base + u * kThreads;
      if (i < m) own[0][i] = static_cast<u64>(ord(key[u])) << 32 | static_cast<unsigned>(lo + i);
      live += key[u] < kEmpty;
    }
  }
  live = __reduce_add_sync(kFull, live);
  if (tid == 0) ss.live = 0;
  int* row = ss.off + warp * kOffRow;  // this warp's counts: only it writes them, but in the prefix
  for (int i = lane; i < kOffRow; i += 32) row[i] = 0;
  __syncthreads();
  if (lane == 0) atomicAdd(&ss.live, live);

  // LSD radix sort of the words by key, stable: warp w ranks the tile's
  // positions [wlo, whi) in order.  A pass: the warps' counts (1 barrier),
  // each digit's prefix over the warps and the tile's totals (published by
  // the cluster barrier), the array's totals and their prefix (warp 0; 2
  // barriers), the scatter (a cluster barrier).
  const int chunk = (m + 31) / 32;
  const int wlo = min(warp * chunk, m), whi = min(wlo + chunk, m);
  int cur = 0, n_live = 0;
  bool moved = true;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 32 + 8 * pass;
    const u64* src = own[cur];
    for (int base = wlo; base < whi; base += 32) {  // counts need no ranks
      const int i = base + lane;
      warp_count(row, i < whi ? static_cast<unsigned>(src[i] >> shift) & 255u : 0u, i < whi);
    }
    __syncthreads();
    int* tot = ss.tot[pass & 1];
    if (tid < 256) {  // digit tid: the words of the lower warps, and the tile's total
      int run = 0;
      for (int w = 0; w < 32; ++w) {
        const int n_w = ss.off[w * kOffRow + tid];
        ss.off[w * kOffRow + tid] = run;
        run += n_w;
      }
      tot[tid] = run;
    }
    cluster.sync();  // every tile's digit totals (and, in pass 0, its live count and copies)
    if (pass == 0 && tid == 0 && me == 0)
      for (int q = 0; q < kCluster; ++q) n_live += *cluster.map_shared_rank(&ss.live, q);
    if (tid < 256) {
      int all = 0, below = 0;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        const int t = *cluster.map_shared_rank(tot + tid, q);
        all += t;
        below += q < me ? t : 0;
      }
      ss.all[tid] = all;
      ss.below[tid] = below;
    }
    __syncthreads();
    if (warp == 0) {  // lane l: digits 8l .. 8l + 7
      const int4 lo4 = reinterpret_cast<const int4*>(ss.all)[2 * lane];
      const int4 hi4 = reinterpret_cast<const int4*>(ss.all)[2 * lane + 1];
      const int n_d[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
      int sum = 0;
      bool one = false;  // one digit for every word: the pass moves nothing
      for (int j = 0; j < 8; ++j) {
        sum += n_d[j];
        one |= n_d[j] == c.F;
      }
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      int first = incl - sum;
      for (int j = 0; j < 8; ++j) {
        ss.delta[lane * 8 + j] = first + ss.below[lane * 8 + j];
        first += n_d[j];
      }
      const unsigned any_one = __ballot_sync(kFull, one);
      if (lane == 0) ss.skip = any_one != 0u;
    }
    __syncthreads();
    moved = !ss.skip;
    if (moved) {
      for (int base = wlo; base < whi; base += 32) {
        const int i = base + lane;
        u64 e = 0ull;
        unsigned d = 256u;
        if (i < whi) {
          e = src[i];
          d = static_cast<unsigned>(e >> shift) & 255u;
        }
        const unsigned peers = __match_any_sync(kFull, d);
        if (d < 256u) {
          const int pos = row[d] + ss.delta[d] + __popc(peers & lanes_below(lane));
          const int q = pos / c.T;
          buffer(cur ^ 1, q)[pos - q * c.T] = e;
        }
        __syncwarp();
        if (d < 256u && lane == __ffs(peers) - 1) row[d] += __popc(peers);
        __syncwarp();
      }
    }
    for (int i = lane; i < kOffRow; i += 32) row[i] = 0;  // for the next pass's counts
    if (!moved) continue;
    cluster.sync();  // the words of the pass are in place
    cur ^= 1;
  }
  if (!moved) cluster.sync();  // no CTA leaves while another reads its totals

  // The tile's positions, from the sorted words and the copies.
  const u64* fin = own[cur];
  constexpr int kHalf = kIlp / 2;
  for (int base = tid; base < m; base += kThreads * kHalf) {
    int hv[kHalf];
    long long kv[kHalf];
#pragma unroll
    for (int u = 0; u < kHalf; ++u) {
      const int i = base + u * kThreads;
      if (i < m) {
        const int slot = slot_of(fin[i]);
        hv[u] = c.hist_copy[slot];
        kv[u] = c.key_copy[slot];
      }
    }
#pragma unroll
    for (int u = 0; u < kHalf; ++u) {
      const int i = base + u * kThreads, p = lo + i;
      if (i < m) {
        const int key = key_of(fin[i]);
        const bool dropped = key < kEmpty && p >= c.keep;
        c.h[p] = dropped ? kEmpty : key;
        c.fhist[p] = hv[u];
        c.fkey[p] = kv[u];
        // The dropped entry leaves the visited set: it can be generated again.
        if (dropped) pw_probe::delete_key(c.table, static_cast<u64>(kv[u]), c.mask);
      }
    }
  }
  if (c.n % 2 == 0)
    gather_rows(reinterpret_cast<int4*>(c.states + 2 * row0), reinterpret_cast<const int4*>(c.states_copy), fin, m,
                c.n / 2);
  else
    gather_rows(reinterpret_cast<int2*>(c.states) + row0, reinterpret_cast<const int2*>(c.states_copy), fin, m, c.n);
  if (me == 0 && tid == 0) {
    *c.ring_cursor = n_live < c.keep ? n_live : c.keep;
    if (n_live > c.keep) *c.evictions += n_live - c.keep;
  }
}

// ---------------------------------------------------------------- append

// A search chunk loop's scalars (search/chunk_graph.py), which the loop's
// launch and the append's tail update: one 16-byte device block.
struct LoopScalars {
  int remaining;     // bodies this launch may still run, this one included (the launch's memset sets the bound)
  int flag;          // whether the loop runs another body
  long long bodies;  // bodies run
};

struct Append {
  const uint8_t* gate;        // scalar or null: open
  const uint8_t* is_new;      // (nb,)
  const int* phist;           // (phist_len,) parent history refs
  const int* actions;         // (nb,) or null: lane / B
  const uint8_t* goal;        // (nb,) or null: no goal resolution
  const float* nov;           // (nb,)
  const float* rgd;           // (rgd_len,)
  const uint8_t* deeper;      // (rgd_len,) or null: no needs_deeper count
  const uint8_t* sel_valid;   // (n_sel,)
  const int* children;        // (nb, n, 2)
  const long long* keys;      // (nb,)
  int* h;                     // (F,)
  int* states;                // (F, n, 2)
  int* fhist;                 // (F,)
  long long* fkey;            // (F,)
  int* ring_cursor;
  int* hist_parent;           // (hcap,)
  int* hist_action;           // (hcap,)
  int* hist_cursor;
  uint8_t* solved;
  int* solved_hist;
  int* iterations;
  int* expansions;
  int* needs_deeper;
  int* hist_idx;              // (nb,) out
  LoopScalars* loop;          // the search chunk loop's scalars, or null: no loop tail
  unsigned long long handle;  // the loop's condition (a cudaGraphConditionalHandle), or 0: none
  int loop_limit;             // the history cursor's limit of an active iteration
  int nb, B, n, F, hcap, margin, use_novelty, phist_len, rgd_len, n_sel;
  int per;                    // lanes a CTA owns: CTA c owns [c * per, min(nb, c * per + per))
  int rounds;                 // ceil(per / blockDim.x)
};

constexpr int kAppendThreads = 512;  // threads a CTA at most (so that 128 registers a thread are allowed)
constexpr int kCopyIlp = 4;          // vectors of the state copy a thread loads before storing one

// One lane's inputs (read-only in the kernel: through the read-only path).
struct LaneIn {
  bool fresh, goal, deeper;
  int phist, action, nov, rgd;
  long long key;
};

__device__ __forceinline__ LaneIn load_lane(const Append& a, int l) {
  const int at_rgd = a.rgd_len == a.nb ? l : l % a.rgd_len;  // per lane, or per parent
  LaneIn in;
  in.fresh = __ldg(a.is_new + l) != 0;
  in.goal = a.goal != nullptr && __ldg(a.goal + l) != 0;
  in.deeper = a.deeper != nullptr && __ldg(a.deeper + at_rgd) != 0;
  in.phist = __ldg(a.phist + (a.phist_len == a.nb ? l : l % a.phist_len));
  in.action = a.actions != nullptr ? __ldg(a.actions + l) : l / a.B;
  in.nov = a.use_novelty ? static_cast<int>(__ldg(a.nov + l)) : 1;
  in.rgd = static_cast<int>(fminf(fmaxf(__ldg(a.rgd + at_rgd), 0.0f), 8190.0f));
  in.key = __ldg(a.keys + l);
  return in;
}

// What a CTA tells the cluster, written into every CTA's shared memory.
struct TileSums {
  int n_new, n_deeper, n_sel;
  int goal_lane, goal_rank;  // the tile's first new goal (INT_MAX: none) and its rank among the tile's new lanes
};

// The cluster barrier in two halves, so that work that needs no other CTA
// runs while the barrier completes: arrive (release: this thread's earlier
// writes, distributed shared memory included, become visible to the
// cluster), then wait (acquire).  Every thread of every CTA calls both.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory"); }

// The loop's tail (one thread): the loop runs another body when this one's
// gate was open, the search is not solved, the history is below its limit
// and the launch has bodies left.  `left` is the countdown after this body,
// `ran` the bodies run before it; the state the tail reads is the append's
// own result, held in registers.
__device__ __forceinline__ void loop_tail(const Append& a, bool open, bool solved, int cursor, int left,
                                          long long ran) {
  const bool c = open & !solved & (cursor < a.loop_limit) & (left > 0);
  a.loop->remaining = left;
  a.loop->flag = c;
  a.loop->bodies = ran + 1;
  if (a.handle) cudaGraphSetConditional(a.handle, c);
}

// The append: a cluster of kCluster CTAs, CTA c owning the lanes
// [c * per, c * per + per) in rounds of blockDim.x, lane order within a CTA
// (round, warp, lane).  kOne: one round, whose inputs stay in registers
// across the barriers; V: the state copy's vector (int4 where rows and
// buffers allow, else int2).
template <bool kOne, class V>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kAppendThreads) append_kernel(Append a) {
  extern __shared__ unsigned words[];  // 4 arrays of rounds * warps: new bits, goal bits, deeper counts, offsets
  __shared__ int sel_w[32];
  __shared__ TileSums sums[kCluster];
  const int c = blockIdx.x, K = kCluster;  // the grid is one cluster
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, T = blockDim.x, W = T >> 5;
  const int R = kOne ? 1 : a.rounds, NW = R * W;
  unsigned* new_w = words;
  unsigned* goal_w = words + NW;
  unsigned* deeper_c = words + 2 * NW;
  unsigned* word_off = words + 3 * NW;
  const int lo = c * a.per, hi = min(a.nb, lo + a.per);

  const bool writer = c == 0 && tid == 0;
  // The gate alone first: a closed one returns before any other load,
  // every CTA alike, before any barrier; the loop's tail still runs (the
  // condition's default is applied once a launch, not once a body).
  if (a.gate != nullptr && !*a.gate) {
    if (writer && a.loop != nullptr) {
      const LoopScalars l = *a.loop;
      loop_tail(a, false, true, 0, l.remaining - 1, l.bodies);
    }
    return;
  }
  // Then every load that does not wait on another: the cursors, the
  // writer's counters and loop scalars, round 0's lane inputs, the first
  // vectors of the state copy, sel_valid.
  const int cursor0 = *a.hist_cursor, ring0 = *a.ring_cursor;
  bool solved_in = true;
  int it0 = 0, ex0 = 0, nd0 = 0, left = 0;
  long long ran = 0;
  if (writer) {
    solved_in = *a.solved;
    it0 = *a.iterations;
    ex0 = *a.expansions;
    nd0 = a.deeper != nullptr ? *a.needs_deeper : 0;
    if (a.loop != nullptr) {
      const LoopScalars l = *a.loop;
      left = l.remaining - 1;
      ran = l.bodies;
    }
  }
  const bool solved0 = a.goal == nullptr || solved_in;  // no goal resolution: as if solved
  const int l0 = lo + tid;
  const LaneIn in0 = l0 < hi ? load_lane(a, l0) : LaneIn{};
  constexpr int kVec = sizeof(V) / 4;  // ints a vector
  const int vrow = 2 * a.n / kVec, m = hi > lo ? hi - lo : 0, nvec = m * vrow;
  const V* src = reinterpret_cast<const V*>(a.children) + static_cast<size_t>(lo) * vrow;
  V* dst = reinterpret_cast<V*>(a.states);
  V buf[kCopyIlp];
#pragma unroll
  for (int u = 0; u < kCopyIlp; ++u)
    if (tid + u * T < nvec) buf[u] = __ldg(src + tid + u * T);
  int my_sel = 0;
  for (int r = c * T + tid; r < a.n_sel; r += K * T) my_sel += __ldg(a.sel_valid + r) != 0;
  PW_STOP(1, cursor0 + ring0 + in0.rgd + my_sel);  // phase: loads

  // The tile's words: a ballot of new lanes, of new goals, and the count of
  // new lanes flagged deeper, per (round, warp).
  for (int r = 0; r < R; ++r) {
    const int l = lo + r * T + tid;
    const LaneIn in = r == 0 ? in0 : (l < hi ? load_lane(a, l) : LaneIn{});
    const bool fresh = l < hi && in.fresh;
    const unsigned nw = __ballot_sync(kFull, fresh);
    const unsigned gw = __ballot_sync(kFull, fresh && in.goal);
    const unsigned dw = __ballot_sync(kFull, fresh && in.deeper);
    if (lane == 0) {
      new_w[r * W + warp] = nw;
      goal_w[r * W + warp] = gw;
      deeper_c[r * W + warp] = __popc(dw);
    }
  }
  my_sel = __reduce_add_sync(kFull, my_sel);
  if (lane == 0) sel_w[warp] = my_sel;
  __syncthreads();
  PW_STOP(2, static_cast<int>(new_w[warp]));  // phase: ballots, barrier

  // Warp 0: the words' offsets, the tile's sums and its first new goal,
  // then the sums into every CTA of the cluster.
  if (warp == 0) {
    int carry = 0, n_deeper = 0, goal_word = -1;
    for (int base = 0; base < NW; base += 32) {
      const int j = base + lane;
      const int cnt = j < NW ? __popc(new_w[j]) : 0;
      int incl = cnt;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (j < NW) word_off[j] = carry + incl - cnt;
      n_deeper += j < NW ? static_cast<int>(deeper_c[j]) : 0;
      const unsigned any = __ballot_sync(kFull, j < NW && goal_w[j] != 0u);
      if (goal_word < 0 && any) goal_word = base + __ffs(any) - 1;
      carry += __shfl_sync(kFull, incl, 31);
    }
    __syncwarp();
    TileSums t;
    t.n_new = carry;
    t.n_deeper = __reduce_add_sync(kFull, n_deeper);
    t.n_sel = __reduce_add_sync(kFull, lane < W ? sel_w[lane] : 0);
    t.goal_lane = INT_MAX;
    t.goal_rank = 0;
    if (goal_word >= 0) {
      const int f = __ffs(goal_w[goal_word]) - 1;
      t.goal_rank = static_cast<int>(word_off[goal_word]) + __popc(new_w[goal_word] & lanes_below(f));
      t.goal_lane = lo + (goal_word / W) * T + (goal_word % W) * 32 + f;
    }
    if (lane < K) *cg::this_cluster().map_shared_rank(&sums[c], lane) = t;
  }
  __syncwarp();
  cluster_arrive();  // the sums are out; the offsets visible in the CTA after the wait

  // While the barrier completes: the states and fingerprints into the
  // window (they need no rank; 16-byte vectors where rows allow).
  for (int base = 0; base < nvec; base += kCopyIlp * T) {
    if (base > 0) {
#pragma unroll
      for (int u = 0; u < kCopyIlp; ++u)
        if (base + tid + u * T < nvec) buf[u] = __ldg(src + base + tid + u * T);
    }
#pragma unroll
    for (int u = 0; u < kCopyIlp; ++u) {
      const int e = base + tid + u * T;
      if (e < nvec) {
        const int row = e / vrow, p = ring0 + lo + row;
        if (p < a.F) dst[static_cast<size_t>(p) * vrow + (e - row * vrow)] = buf[u];
      }
    }
  }
  for (int r = 0; r < R; ++r) {
    const int l = lo + r * T + tid, p = ring0 + l;
    if (l < hi && p < a.F) a.fkey[p] = r == 0 ? in0.key : __ldg(a.keys + l);
  }
  cluster_wait();  // every CTA's sums in every CTA
  PW_STOP(3, sums[0].n_new);  // phase: tile sums, cluster barrier, state copy

  // The carry of the lower tiles, the totals and the first goal, per warp.
  const TileSums mine = lane < K ? sums[lane] : TileSums{0, 0, 0, INT_MAX, 0};
  int incl = mine.n_new;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const int carry = __shfl_sync(kFull, incl - mine.n_new, c);

  // The counters first (their stores drain beside the lanes'), once, from
  // values held on chip: warp 0 of CTA 0.
  if (c == 0 && warp == 0) {
    const int n_new = __shfl_sync(kFull, incl, 31);
    const int n_deeper = __reduce_add_sync(kFull, mine.n_deeper);
    const int n_sel = __reduce_add_sync(kFull, mine.n_sel);
    const unsigned goals = __ballot_sync(kFull, mine.goal_lane != INT_MAX);
    const int first = goals ? __ffs(goals) - 1 : 0;
    const int goal_idx = cursor0 + __shfl_sync(kFull, incl - mine.n_new + mine.goal_rank, first);
    if (writer) {
      const int cap = a.hcap - a.margin;
      const int cursor = cursor0 + n_new < cap ? cursor0 + n_new : cap;
      *a.hist_cursor = cursor;
      *a.ring_cursor = ring0 + a.nb;
      if (!solved0) {
        *a.solved_hist = goals ? goal_idx : 0;
        if (goals) *a.solved = 1;
      }
      *a.iterations = it0 + 1;
      *a.expansions = ex0 + n_sel;
      if (a.deeper != nullptr) *a.needs_deeper = nd0 + n_deeper;
      if (a.loop != nullptr) loop_tail(a, true, solved_in || (!solved0 && goals), cursor, left, ran);
    }
  }

  // Per lane: the history index and record, the key and the window.
  for (int r = 0; r < R; ++r) {
    const int l = lo + r * T + tid;
    if (l >= hi) break;
    const LaneIn in = r == 0 ? in0 : load_lane(a, l);
    const int j = r * W + warp;
    const int idx = in.fresh ? cursor0 + carry + static_cast<int>(word_off[j]) +
                                   __popc(new_w[j] & lanes_below(lane))
                             : 0;
    a.hist_idx[l] = idx;
    if (in.fresh && idx < a.hcap) {  // as JAX, an index past the capacity is dropped
      a.hist_parent[idx] = in.phist;
      a.hist_action[idx] = in.action;
    }
    const int p = ring0 + l;
    if (p < a.F) {
      a.h[p] = in.fresh ? (in.nov << 28) | (in.rgd << 15) | (~idx & 0x7FFF) : kEmpty;
      a.fhist[p] = idx;
    }
  }
}

// Shared memory a select launch takes: the tile's lowest words and their
// ranks (stride words and ints), the regions when cand, the tile's words
// when tile.
size_t select_smem(int T, int stride, bool cand, bool tile) {
  return static_cast<size_t>(stride) * 12 + (cand ? static_cast<size_t>(kCluster) * stride * 8 : 0) +
         (tile ? static_cast<size_t>(T) * 8 : 0);
}

// Lets fn take up to its share of a CTA's shared memory (static plus dynamic:
// kMaxSmem), once a device; one value for every launch, so that threads that
// launch at once never undo each other's setting.
template <int kKernel>
cudaError_t allow_dynamic_smem(const void* fn, size_t static_bytes) {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem - static_bytes));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

constexpr size_t kSelectStatic = sizeof(LowestShared) + 1024;  // with room to spare
constexpr size_t kCompactStatic = sizeof(SortShared) + 1024;
constexpr size_t kAppendStatic = sizeof(TileSums) * kCluster + 32 * sizeof(int) + 1024;
// The append's launch: one cluster of kCluster CTAs of T threads, each
// owning per lanes in rounds of T (a CTA past the last lane owns none).
struct AppendShape {
  int T, per, rounds;
  size_t smem;
};

AppendShape append_shape(int nb) {
  AppendShape s;
  s.per = (nb + kCluster - 1) / kCluster;
  s.T = (s.per + 31) / 32 * 32;
  if (s.T > kAppendThreads) s.T = kAppendThreads;
  s.rounds = (s.per + s.T - 1) / s.T;
  s.smem = static_cast<size_t>(4) * s.rounds * (s.T / 32) * sizeof(unsigned);
  return s;
}

template <bool kOne, class V>
cudaError_t launch_append(const Append& a, const AppendShape& shape, cudaStream_t stream) {
  if (shape.smem > 48 * 1024) {
    const cudaError_t err = allow_dynamic_smem<4 + 2 * kOne + (sizeof(V) == 16)>(
        reinterpret_cast<const void*>(append_kernel<kOne, V>), kAppendStatic);
    if (err != cudaSuccess) return err;
  }
  append_kernel<kOne, V><<<kCluster, shape.T, shape.smem, stream>>>(a);
  return cudaSuccess;
}

}  // namespace

// ---------------------------------------------------------------- C interface

// Where a select launch keeps its tiles' candidates: 0 words of scratch when
// shared memory holds them, else kCluster * min(B, ceil(F / 8)); -1
// for sizes it does not take.
extern "C" int pw_frontier_select_scratch_words(int F, int B) {
  if (F < 1 || B < 1 || B > F || F > (1 << 26)) return -1;
  const int T = (F + kCluster - 1) / kCluster;
  const int stride = B < T ? B : T;
  const size_t cap = kMaxSmem - kSelectStatic;
  if (select_smem(T, stride, false, false) > cap) return -1;
  return select_smem(T, stride, true, false) <= cap ? 0 : kCluster * stride;
}

// Selects the B lowest keys; solved and hist_cursor null: no gate (always
// open).  gate (a bool scalar) may be null.  scratch: the number of u64 words
// pw_frontier_select_scratch_words gives (null when 0).  min(B, ceil(F / 8))
// up to ~17,000.
extern "C" int pw_frontier_select(void* h, const void* states, const void* fhist, const void* solved,
                                  const void* hist_cursor, int hist_limit, void* parents, void* parent_hist,
                                  void* sel_valid, void* gate, void* scratch, int F, int B, int n, void* stream) {
  const int words = pw_frontier_select_scratch_words(F, B);
  if (words < 0 || n < 1 || (solved == nullptr) != (hist_cursor == nullptr) || (words > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = (F + kCluster - 1) / kCluster;
  const int stride = B < T ? B : T;
  const size_t cap = kMaxSmem - kSelectStatic;
  const bool cand = words == 0;
  const bool tile = select_smem(T, stride, cand, true) <= cap;
  const size_t smem = select_smem(T, stride, cand, tile);
  Select s{static_cast<int*>(h),          static_cast<const int*>(states), static_cast<const int*>(fhist),
           static_cast<const uint8_t*>(solved), static_cast<const int*>(hist_cursor), hist_limit,
           static_cast<int*>(parents),    static_cast<int*>(parent_hist),  static_cast<uint8_t*>(sel_valid),
           static_cast<uint8_t*>(gate),   static_cast<u64*>(scratch),      F, B, n, T, stride, cand};
  const cudaError_t err =
      tile ? allow_dynamic_smem<0>(reinterpret_cast<const void*>(select_kernel<true>), kSelectStatic)
           : allow_dynamic_smem<1>(reinterpret_cast<const void*>(select_kernel<false>), kSelectStatic);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile)
    select_kernel<true><<<kCluster, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(s);
  else
    select_kernel<false><<<kCluster, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(s);
  return static_cast<int>(cudaGetLastError());
}

// Compacts the ring when gate (null: open) and cursor + nb > F, and
// tombstones the dropped entries' fingerprints in the visited set table
// (mask + 1 packed words, mask = 2^bits - 1).  Scratch: sort (2F,) u64 (the
// words, when a tile does not fit in shared memory: F above ~96K),
// states_copy (F, n, 2) int32 (16-byte aligned where n is even), hist_copy
// (F,) int32, key_copy (F,) int64.
extern "C" int pw_frontier_compact(void* h, void* states, void* fhist, void* fkey, void* ring_cursor,
                                   void* evictions, void* table, unsigned mask, const void* gate, void* sort,
                                   void* states_copy, void* hist_copy, void* key_copy, int F, int n, int nb,
                                   int keep, void* stream) {
  if (F < 1 || n < 1 || nb < 0 || keep < 0 || keep > F || F > (1 << 26) / n || (mask & (mask + 1u)) != 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = (F + kCluster - 1) / kCluster;
  Compact c{static_cast<int*>(h),          static_cast<int*>(states),     static_cast<int*>(fhist),
            static_cast<long long*>(fkey), static_cast<int*>(ring_cursor), static_cast<int*>(evictions),
            static_cast<u64*>(table),      static_cast<const uint8_t*>(gate),
            static_cast<u64*>(sort),       static_cast<int*>(states_copy), static_cast<int*>(hist_copy),
            static_cast<long long*>(key_copy), F, n, nb, keep, T, mask};
  const size_t smem = static_cast<size_t>(T) * 16;
  const bool in_smem = smem <= kMaxSmem - kCompactStatic;
  const cudaError_t err =
      in_smem ? allow_dynamic_smem<2>(reinterpret_cast<const void*>(compact_kernel<true>), kCompactStatic)
              : allow_dynamic_smem<3>(reinterpret_cast<const void*>(compact_kernel<false>), kCompactStatic);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (in_smem)
    compact_kernel<true><<<kCluster, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(c);
  else
    compact_kernel<false><<<kCluster, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(c);
  return static_cast<int>(cudaGetLastError());
}

// Appends nb scored children (see the header); goal and deeper may be null,
// actions null means lane / B.  children and states are 8-byte aligned.
// loop (8-byte aligned; null: no tail) is a search chunk loop's LoopScalars,
// handle its condition (0: none; then only the scalars are written),
// loop_limit the history cursor's limit of an active iteration.
extern "C" int pw_frontier_append(const void* gate, const void* is_new, const void* phist, const void* actions,
                                  const void* goal, const void* nov, const void* rgd, const void* deeper,
                                  const void* sel_valid, const void* children, const void* keys, void* h,
                                  void* states, void* fhist, void* fkey, void* ring_cursor, void* hist_parent,
                                  void* hist_action, void* hist_cursor, void* solved, void* solved_hist,
                                  void* iterations, void* expansions, void* needs_deeper, void* hist_idx, int nb,
                                  int B, int n, int F, int hcap, int margin, int use_novelty, int phist_len,
                                  int rgd_len, int n_sel, void* loop, unsigned long long handle, int loop_limit,
                                  void* stream) {
  if (nb < 1 || B < 1 || n < 1 || F < 1 || hcap < 1 || phist_len < 1 || rgd_len < 1 || n_sel < 0 ||
      nb % phist_len != 0 || nb % rgd_len != 0 || nb > (1 << 26) / n ||
      (reinterpret_cast<uintptr_t>(children) | reinterpret_cast<uintptr_t>(states)) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(loop) % 8 != 0 || (handle != 0 && loop == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const AppendShape shape = append_shape(nb);
  if (shape.smem > kMaxSmem - kAppendStatic) return static_cast<int>(cudaErrorInvalidValue);
  Append a{static_cast<const uint8_t*>(gate),      static_cast<const uint8_t*>(is_new),
           static_cast<const int*>(phist),         static_cast<const int*>(actions),
           static_cast<const uint8_t*>(goal),      static_cast<const float*>(nov),
           static_cast<const float*>(rgd),         static_cast<const uint8_t*>(deeper),
           static_cast<const uint8_t*>(sel_valid), static_cast<const int*>(children),
           static_cast<const long long*>(keys),    static_cast<int*>(h),
           static_cast<int*>(states),              static_cast<int*>(fhist),
           static_cast<long long*>(fkey),          static_cast<int*>(ring_cursor),
           static_cast<int*>(hist_parent),         static_cast<int*>(hist_action),
           static_cast<int*>(hist_cursor),         static_cast<uint8_t*>(solved),
           static_cast<int*>(solved_hist),         static_cast<int*>(iterations),
           static_cast<int*>(expansions),          static_cast<int*>(needs_deeper),
           static_cast<int*>(hist_idx),            static_cast<LoopScalars*>(loop),
           handle,                                 loop_limit,
           nb, B, n, F, hcap, margin, use_novelty, phist_len, rgd_len, n_sel, shape.per, shape.rounds};
  const bool wide = n % 2 == 0 && (reinterpret_cast<uintptr_t>(children) | reinterpret_cast<uintptr_t>(states)) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (shape.rounds == 1)
    err = wide ? launch_append<true, int4>(a, shape, s) : launch_append<true, int2>(a, shape, s);
  else
    err = wide ? launch_append<false, int4>(a, shape, s) : launch_append<false, int2>(a, shape, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
