// The search iteration's frontier bookkeeping: the gate and the selection,
// the compaction of the ring, and the append of the scored children (history,
// goal, priority keys, window, counters).  Three kernels, one launch each.
//
// Replaces XLA code of the JAX package, not a TPU kernel, in
// pushworld_tpu/search/batched.py: _select_frontier (lines 520-534, a top-k
// of the int32 keys), _append_history (439-454), _append_frontier (457-517,
// with the lax.cond of its compaction), the goal resolution, the priority
// keys and the counters of _iterate (537-623), and run_chunk's gate
// (the fixed trip count's cond).  Their plain PyTorch form
// (pushworld_tpu_torch/search/batched.py *_reference) is some 150 kernels an
// iteration, two stable sorts of the F keys among them.
//
// Keys.  Every key is a non-negative int32 at most EMPTY = 0x7F000000 (a free
// slot).  The kernels order keys as unsigned words with the sign bit flipped,
// which is the int32 order, and carry a slot beside a key as one 64-bit word
// (key << 32 | slot), so that (key, slot) order is the order of the words.
//
// pw_frontier_select (one CTA of 1,024 threads).  The gate first, as the JAX
// package's run_chunk reads it before an iteration: not solved, the history
// cursor below its limit, and a key below EMPTY (read only when the first two
// hold; the sharded search passes no gate inputs: always open).  The gate goes to a device flag that the
// iteration's later kernels read; a closed gate writes sel_valid = 0 and
// nothing else.  Then the B lowest keys in (key, slot) order, EMPTY slots
// included when fewer than B are live (their lanes feed children that land
// in the window with EMPTY keys): a radix select of 4 passes of 8 bits over
// the keys (held in shared memory, 128 KB at F = 2^15; read from device
// memory above 227 KB), a warp-aggregated histogram each pass, gives the B-th
// key T and how many keys equal to T to take; the keys below T are all
// taken, those equal to T in slot order (warp ballots over contiguous
// ranges).  A bitonic sort of the B words orders them.  The selected slots
// that were live are freed (EMPTY), and parents, parent_hist and sel_valid
// are gathered.
//
// pw_frontier_compact (one CTA).  need = gate and cursor + nb > F, read on
// the device; without need the CTA returns at once.  Else, as the lax.cond
// branch: a stable sort of the F keys (an LSD radix sort of the (key, slot)
// words, 4 passes of 8 bits; each warp ranks its contiguous range in order
// with __match_any_sync, so the sort is stable), states, hist and
// fingerprints permuted through it from copies, live slots at or beyond keep
// dropped (EMPTY; a drop mask and the need flag go to the caller, whose
// visited_set.cu probe_delete launch, gated on the flag, tombstones the
// dropped fingerprints), cursor = min(live, keep), evictions += dropped.
// The sort and the copies use device scratch from the caller.
//
// pw_frontier_append (one CTA).  With the gate open: a block-wide exclusive
// scan of is_new over the nb lanes gives each new child its history index
// (cursor + rank); the (parent, action) records are written, the cursor
// advances, clamped margin short of the capacity.  The priority key of a new
// child is novelty << 28 | clamp(rgd, 0, 8190) << 15 | (~hist_idx & 0x7FFF),
// EMPTY for the others; keys, states, history indices and fingerprints go to
// the window at the ring cursor, which advances by nb.  The first goal among
// the new children in lane order solves the search (solved_hist kept once
// solved); iterations += 1, expansions += the selected parents,
// needs_deeper += the flagged new children.  Lanes are in action-block
// order; a parent array of length B is read at lane % B, an rgd/deeper
// array of length B (the lazy mode's per-parent values) at lane % B, and the
// action of a lane is lane / B unless an actions array is given (the
// sharded search's received children).
//
// Order of effects: JAX appends the history, then compacts, then writes
// the window.  History and compaction touch disjoint arrays, so the search
// runs the compaction first and the append after it; the visited set's
// deletes still come after the iteration's inserts.
//
// Bound.  The select and the compaction read the F keys (128 KB at 2^15)
// a few times from shared memory or L2, and move the selected or all states
// (B * 8N bytes; F * (8N + 12) for a compaction); the append moves ~40
// bytes a lane.  At the search's sizes every kernel but a compaction is a
// few microseconds, near the launch; a compaction (one in every ~8-24
// iterations) is bound by one SM's bandwidth to L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;  // every kernel here: one CTA of 32 warps
constexpr int kEmpty = 0x7F000000;
constexpr int kMaxSmem = 232448;  // a CTA's shared memory on sm_90
constexpr int kStaticSmem = 4096;  // room for the select kernel's static arrays

__device__ __forceinline__ unsigned ord(int key) { return static_cast<unsigned>(key) ^ 0x80000000u; }
__device__ __forceinline__ int unord(unsigned u) { return static_cast<int>(u ^ 0x80000000u); }
__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// Exclusive prefix sum of v over the CTA's 1,024 threads, in thread order;
// *total gets the sum.  sh holds 33 ints.  Every thread must call it.
__device__ int block_exclusive_scan(int v, int* total, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = sh[lane];
    int incl = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
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

// ---------------------------------------------------------------- select

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
  int F, B, n, P;             // P: a power of two >= B
};

template <bool kSharedKeys>
__global__ void __launch_bounds__(kThreads) select_kernel(Select s) {
  extern __shared__ __align__(16) u64 dyn[];
  u64* sel = dyn;                                        // P words
  unsigned* keys = reinterpret_cast<unsigned*>(dyn + s.P);  // F keys (kSharedKeys)
  __shared__ int hist[256];
  __shared__ unsigned umin[32];
  __shared__ int wcount[32];
  __shared__ int digit_sh, below_sh, less_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto key_at = [&](int i) -> unsigned { return kSharedKeys ? keys[i] : ord(s.h[i]); };

  // 1. The gate: solved and the history first (after a solve the gate closes
  // without a look at the keys), then a live key, from the least key.
  bool open = s.solved == nullptr || (!*s.solved && *s.hist_cursor < s.hist_limit);
  if (open) {
    unsigned mn = 0xFFFFFFFFu;
    for (int i = tid; i < s.F; i += kThreads) {
      const unsigned u = ord(s.h[i]);
      if (kSharedKeys) keys[i] = u;
      mn = u < mn ? u : mn;
    }
    mn = __reduce_min_sync(0xFFFFFFFFu, mn);
    if (lane == 0) umin[warp] = mn;
    __syncthreads();
    mn = __reduce_min_sync(0xFFFFFFFFu, umin[lane]);
    open = s.solved == nullptr || unord(mn) < kEmpty;
  }
  if (tid == 0 && s.gate != nullptr) *s.gate = open;
  if (!open) {
    for (int r = tid; r < s.B; r += kThreads) s.sel_valid[r] = 0;
    return;
  }

  // 2. Radix select: the B-th key T (prefix) and k, the keys equal to T to take.
  unsigned prefix = 0u, pmask = 0u;
  int k = s.B;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int base = warp * 32; base < s.F; base += kThreads) {
      const int i = base + lane;
      unsigned d = 256u;
      if (i < s.F) {
        const unsigned u = key_at(i);
        if ((u & pmask) == prefix) d = (u >> shift) & 255u;
      }
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
      if (d < 256u && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      int c[8], sum = 0;
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[lane * 8 + j];
        sum += c[j];
      }
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += y;
      }
      int run = incl - sum;
      if (run < k && k <= incl) {
        for (int j = 0; j < 8; ++j) {
          if (run + c[j] >= k) {
            digit_sh = lane * 8 + j;
            below_sh = run;
            break;
          }
          run += c[j];
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(digit_sh) << shift;
    pmask |= 255u << shift;
    k -= below_sh;
    __syncthreads();
  }
  const int n_less = s.B - k;

  // 3. Collect: every key below T (any order), the first k keys equal to T
  // in slot order (warp w walks the slots [w * chunk, (w + 1) * chunk)).
  if (tid == 0) less_sh = 0;
  for (int r = s.B + tid; r < s.P; r += kThreads) sel[r] = ~0ull;
  __syncthreads();
  const int chunk = (s.F + 31) / 32;
  const int lo = warp * chunk < s.F ? warp * chunk : s.F;
  const int hi = lo + chunk < s.F ? lo + chunk : s.F;
  int eq = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const unsigned u = i < hi ? key_at(i) : 0xFFFFFFFFu;
    if (i < hi && u < prefix) sel[atomicAdd(&less_sh, 1)] = static_cast<u64>(u) << 32 | static_cast<unsigned>(i);
    eq += __popc(__ballot_sync(0xFFFFFFFFu, i < hi && u == prefix));
  }
  if (lane == 0) wcount[warp] = eq;
  __syncthreads();
  int rank = 0;
  for (int w = 0; w < warp; ++w) rank += wcount[w];
  for (int base = lo; base < hi && rank < k; base += 32) {
    const int i = base + lane;
    const bool is_eq = i < hi && key_at(i) == prefix;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, is_eq);
    const int mine = rank + __popc(ballot & lanes_below(lane));
    if (is_eq && mine < k) sel[n_less + mine] = static_cast<u64>(prefix) << 32 | static_cast<unsigned>(i);
    rank += __popc(ballot);
  }
  __syncthreads();

  // 4. Bitonic sort of the P words: (key, slot) order.
  for (int size = 2; size <= s.P; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < s.P; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const u64 x = sel[i], y = sel[ixj];
          if ((x > y) == ((i & size) == 0)) {
            sel[i] = y;
            sel[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  // 5. Gather and free.
  for (int r = tid; r < s.B; r += kThreads) {
    const u64 e = sel[r];
    const int slot = static_cast<int>(static_cast<unsigned>(e));
    const bool valid = unord(static_cast<unsigned>(e >> 32)) < kEmpty;
    s.sel_valid[r] = valid;
    s.parent_hist[r] = s.fhist[slot];
    if (valid) s.h[slot] = kEmpty;
  }
  const int row = 2 * s.n;
  for (int idx = tid; idx < s.B * row; idx += kThreads) {
    const int r = idx / row;
    const int slot = static_cast<int>(static_cast<unsigned>(sel[r]));
    s.parents[idx] = s.states[static_cast<size_t>(slot) * row + (idx - r * row)];
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
  uint8_t* drop;              // (F,) out, written when need
  uint8_t* need;              // scalar out
  const uint8_t* gate;        // scalar or null: open
  u64* sort_a;                // (F,) scratch
  u64* sort_b;                // (F,) scratch
  int* states_copy;           // (F, n, 2) scratch
  int* hist_copy;             // (F,) scratch
  long long* key_copy;        // (F,) scratch
  int F, n, nb, keep;
};

__global__ void __launch_bounds__(kThreads) compact_kernel(Compact c) {
  __shared__ int off[256 * 32];  // per (digit, warp): counts, then write offsets
  __shared__ int sh[33];
  __shared__ int live_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool need = (c.gate == nullptr || *c.gate) && *c.ring_cursor + c.nb > c.F;
  if (tid == 0) *c.need = need;
  if (!need) return;
  const int row = 2 * c.n;

  for (int i = tid; i < c.F * row; i += kThreads) c.states_copy[i] = c.states[i];
  for (int i = tid; i < c.F; i += kThreads) {
    c.hist_copy[i] = c.fhist[i];
    c.key_copy[i] = c.fkey[i];
  }
  if (tid == 0) live_sh = 0;
  __syncthreads();

  // LSD radix sort of the (key, slot) words by key, stable: warp w owns the
  // positions [lo, hi) and ranks its elements in their order.
  const int chunk = (c.F + 31) / 32;
  const int lo = warp * chunk < c.F ? warp * chunk : c.F;
  const int hi = lo + chunk < c.F ? lo + chunk : c.F;
  const u64* src = nullptr;
  u64* dst = c.sort_a;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 32 + 8 * pass;
    for (int i = tid; i < 256 * 32; i += kThreads) off[i] = 0;
    __syncthreads();
    int live = 0;
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      unsigned d = 256u;
      if (i < hi) {
        const u64 e = pass == 0 ? static_cast<u64>(ord(c.h[i])) << 32 | static_cast<unsigned>(i) : src[i];
        d = static_cast<unsigned>(e >> shift) & 255u;
        if (pass == 0 && c.h[i] < kEmpty) ++live;
      }
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
      if (d < 256u && lane == __ffs(peers) - 1) off[d * 32 + warp] += __popc(peers);
      __syncwarp();
    }
    if (pass == 0) {
      for (int o = 16; o > 0; o >>= 1) live += __shfl_down_sync(0xFFFFFFFFu, live, o);
      if (lane == 0) atomicAdd(&live_sh, live);
    }
    __syncthreads();
    int v[8], sum = 0;
    for (int j = 0; j < 8; ++j) {
      v[j] = off[tid * 8 + j];
      sum += v[j];
    }
    int total;
    int start = block_exclusive_scan(sum, &total, sh);
    for (int j = 0; j < 8; ++j) {
      off[tid * 8 + j] = start;
      start += v[j];
    }
    __syncthreads();
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      unsigned d = 256u;
      u64 e = 0ull;
      if (i < hi) {
        e = pass == 0 ? static_cast<u64>(ord(c.h[i])) << 32 | static_cast<unsigned>(i) : src[i];
        d = static_cast<unsigned>(e >> shift) & 255u;
      }
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
      if (d < 256u) dst[off[d * 32 + warp] + __popc(peers & lanes_below(lane))] = e;
      __syncwarp();
      if (d < 256u && lane == __ffs(peers) - 1) off[d * 32 + warp] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    src = dst;
    dst = dst == c.sort_a ? c.sort_b : c.sort_a;
  }

  const int n_live = live_sh;
  for (int p = tid; p < c.F; p += kThreads) {
    const u64 e = src[p];
    const int slot = static_cast<int>(static_cast<unsigned>(e));
    const int key = unord(static_cast<unsigned>(e >> 32));
    const bool drop = key < kEmpty && p >= c.keep;
    c.h[p] = drop ? kEmpty : key;
    c.fhist[p] = c.hist_copy[slot];
    c.fkey[p] = c.key_copy[slot];
    c.drop[p] = drop;
  }
  for (int idx = tid; idx < c.F * row; idx += kThreads) {
    const int p = idx / row;
    const int slot = static_cast<int>(static_cast<unsigned>(src[p]));
    c.states[idx] = c.states_copy[static_cast<size_t>(slot) * row + (idx - p * row)];
  }
  if (tid == 0) {
    *c.ring_cursor = n_live < c.keep ? n_live : c.keep;
    if (n_live > c.keep) *c.evictions += n_live - c.keep;
  }
}

// ---------------------------------------------------------------- append

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
  int nb, B, n, F, hcap, margin, use_novelty, phist_len, rgd_len, n_sel;
};

__global__ void __launch_bounds__(kThreads) append_kernel(Append a) {
  __shared__ int sh[33];
  __shared__ int first_sh, deeper_sh, sel_sh;
  if (a.gate != nullptr && !*a.gate) return;
  const int tid = threadIdx.x, lane = tid & 31;
  const int cursor0 = *a.hist_cursor, ring0 = *a.ring_cursor;
  const int per = (a.nb + kThreads - 1) / kThreads;
  const int lo = tid * per < a.nb ? tid * per : a.nb;
  const int hi = lo + per < a.nb ? lo + per : a.nb;
  int mine = 0;
  for (int l = lo; l < hi; ++l) mine += a.is_new[l] != 0;
  if (tid == 0) {
    first_sh = INT_MAX;
    deeper_sh = 0;
    sel_sh = 0;
  }
  int n_new;
  int rank = block_exclusive_scan(mine, &n_new, sh);  // its barriers publish the zeros above

  int n_deeper = 0;
  for (int l = lo; l < hi; ++l) {
    const bool fresh = a.is_new[l] != 0;
    const int idx = fresh ? cursor0 + rank : 0;
    rank += fresh;
    a.hist_idx[l] = idx;
    if (fresh && idx < a.hcap) {  // as JAX, an index past the capacity is dropped
      a.hist_parent[idx] = a.phist[l % a.phist_len];
      a.hist_action[idx] = a.actions != nullptr ? a.actions[l] : l / a.B;
    }
    int key = kEmpty;
    if (fresh) {
      const int nov = a.use_novelty ? static_cast<int>(a.nov[l]) : 1;
      const int rgd = static_cast<int>(fminf(fmaxf(a.rgd[l % a.rgd_len], 0.0f), 8190.0f));
      key = (nov << 28) | (rgd << 15) | (~idx & 0x7FFF);
      if (a.goal != nullptr && a.goal[l]) atomicMin(&first_sh, l);
      if (a.deeper != nullptr && a.deeper[l % a.rgd_len]) ++n_deeper;
    }
    const int p = ring0 + l;
    if (p < a.F) {
      a.h[p] = key;
      a.fhist[p] = idx;
      a.fkey[p] = a.keys[l];
    }
  }
  const int row = 2 * a.n;
  for (int i = tid; i < a.nb * row; i += kThreads) {
    const int p = ring0 + i / row;
    if (p < a.F) a.states[static_cast<size_t>(ring0) * row + i] = a.children[i];
  }
  int n_sel = 0;
  for (int r = tid; r < a.n_sel; r += kThreads) n_sel += a.sel_valid[r] != 0;
  for (int o = 16; o > 0; o >>= 1) {
    n_deeper += __shfl_down_sync(0xFFFFFFFFu, n_deeper, o);
    n_sel += __shfl_down_sync(0xFFFFFFFFu, n_sel, o);
  }
  if (lane == 0) {
    atomicAdd(&deeper_sh, n_deeper);
    atomicAdd(&sel_sh, n_sel);
  }
  __syncthreads();
  if (tid == 0) {
    const int cap = a.hcap - a.margin;
    *a.hist_cursor = cursor0 + n_new < cap ? cursor0 + n_new : cap;
    *a.ring_cursor = ring0 + a.nb;
    if (a.goal != nullptr && !*a.solved) {
      const bool any = first_sh != INT_MAX;
      *a.solved_hist = any ? a.hist_idx[first_sh] : 0;
      if (any) *a.solved = 1;
    }
    *a.iterations += 1;
    *a.expansions += sel_sh;
    if (a.deeper != nullptr) *a.needs_deeper += deeper_sh;
  }
}

size_t select_smem(int F, int P, bool shared_keys) {
  return static_cast<size_t>(P) * 8 + (shared_keys ? static_cast<size_t>(F) * 4 : 0);
}

bool shared_keys(int F, int P) { return select_smem(F, P, true) + kStaticSmem <= kMaxSmem; }

}  // namespace

// ---------------------------------------------------------------- C interface

// Selects the B lowest keys; solved and hist_cursor null: no gate (always
// open).  gate (a bool scalar) may be null.
extern "C" int pw_frontier_select(void* h, const void* states, const void* fhist, const void* solved,
                                  const void* hist_cursor, int hist_limit, void* parents, void* parent_hist,
                                  void* sel_valid, void* gate, int F, int B, int n, void* stream) {
  if (F < 1 || B < 1 || B > F || n < 1 || F > (1 << 26) || (solved == nullptr) != (hist_cursor == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int P = 1;
  while (P < B) P <<= 1;
  if (select_smem(0, P, false) + kStaticSmem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  Select s{static_cast<int*>(h),          static_cast<const int*>(states), static_cast<const int*>(fhist),
           static_cast<const uint8_t*>(solved), static_cast<const int*>(hist_cursor), hist_limit,
           static_cast<int*>(parents),    static_cast<int*>(parent_hist),  static_cast<uint8_t*>(sel_valid),
           static_cast<uint8_t*>(gate),   F, B, n, P};
  const bool in_shared = shared_keys(F, P);
  const size_t smem = select_smem(F, P, in_shared);
  const void* fn = in_shared ? reinterpret_cast<const void*>(select_kernel<true>)
                             : reinterpret_cast<const void*>(select_kernel<false>);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (in_shared)
    select_kernel<true><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(s);
  else
    select_kernel<false><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(s);
  return static_cast<int>(cudaGetLastError());
}

// Compacts the ring when gate (null: open) and cursor + nb > F; writes need
// and, when it holds, the drop mask.  Scratch: sort (2F,) u64, states_copy
// (F, n, 2) int32, hist_copy (F,) int32, key_copy (F,) int64.
extern "C" int pw_frontier_compact(void* h, void* states, void* fhist, void* fkey, void* ring_cursor,
                                   void* evictions, void* drop, void* need, const void* gate, void* sort,
                                   void* states_copy, void* hist_copy, void* key_copy, int F, int n, int nb,
                                   int keep, void* stream) {
  if (F < 1 || n < 1 || nb < 0 || keep < 0 || keep > F || F > (1 << 26) / n)
    return static_cast<int>(cudaErrorInvalidValue);
  Compact c{static_cast<int*>(h),          static_cast<int*>(states),     static_cast<int*>(fhist),
            static_cast<long long*>(fkey), static_cast<int*>(ring_cursor), static_cast<int*>(evictions),
            static_cast<uint8_t*>(drop),   static_cast<uint8_t*>(need),   static_cast<const uint8_t*>(gate),
            static_cast<u64*>(sort),       static_cast<u64*>(sort) + F,   static_cast<int*>(states_copy),
            static_cast<int*>(hist_copy),  static_cast<long long*>(key_copy), F, n, nb, keep};
  compact_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(c);
  return static_cast<int>(cudaGetLastError());
}

// Appends nb scored children (see the header); goal and deeper may be null,
// actions null means lane / B.
extern "C" int pw_frontier_append(const void* gate, const void* is_new, const void* phist, const void* actions,
                                  const void* goal, const void* nov, const void* rgd, const void* deeper,
                                  const void* sel_valid, const void* children, const void* keys, void* h,
                                  void* states, void* fhist, void* fkey, void* ring_cursor, void* hist_parent,
                                  void* hist_action, void* hist_cursor, void* solved, void* solved_hist,
                                  void* iterations, void* expansions, void* needs_deeper, void* hist_idx, int nb,
                                  int B, int n, int F, int hcap, int margin, int use_novelty, int phist_len,
                                  int rgd_len, int n_sel, void* stream) {
  if (nb < 1 || B < 1 || n < 1 || F < 1 || hcap < 1 || phist_len < 1 || rgd_len < 1 || n_sel < 0 ||
      nb % phist_len != 0 || nb % rgd_len != 0 || nb > (1 << 26) / n)
    return static_cast<int>(cudaErrorInvalidValue);
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
           static_cast<int*>(hist_idx),            nb, B, n, F, hcap, margin, use_novelty, phist_len, rgd_len,
           n_sel};
  append_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
