// The search iteration's expansion: all four children of every selected
// parent, their moved masks, the `effective` flags and the goal test, in one
// launch.
//
// Replaces XLA code of the JAX package, not a TPU kernel:
// pushworld_tpu/ops/step.py expand_children (lines 131-182) and
// is_goal_state (199), and the lines of pushworld_tpu/search/batched.py
// _iterate that follow it (547-554: moved, effective).  Their plain PyTorch
// form (pushworld_tpu_torch/ops/step.py expand_and_test_reference) compares
// a (4, B, N, N, C) broadcast of relative offsets with the contact lists,
// then squares the (N, N) push relation as float matrices
// (_closure_from_agent: log2 N batched matmuls), then gathers the
// static-block bits: some 40 kernels an iteration.
//
// What it computes, per (action a, parent b) lane, as the plain version does:
//   push[i] bit j  some contact c of (a, i, j) equals pos_i - pos_j (the
//                  packed (rx, ry) compare of the plain version is a pair
//                  compare: offsets are far below 2048);
//   pushed         the transitive closure of push from the agent (object 0),
//                  which the plain version's squaring reaches exactly;
//   nothing        static_block[a, 0, agent] or static_block[a, i, pos_i]
//                  for some pushed i >= 1 (all or nothing);
//   moved          pushed & ~nothing & obj_mask;
//   child          pos + displacement(a) * moved; moved is exactly
//                  (child != parent).any(-1) since a displacement is never 0;
//   effective      moved.any() & sel_valid[b];
//   goal           every object at its goal where goal_mask holds.
// Lanes are in action-block order: lane = a * B + b.
//
// Bound.  A lane reads its parent (8N bytes), the contact lists of one
// action (shared by the CTA) and N static-block bytes, and writes 9N + 2
// bytes: ~53 KB for the search's 1,024 lanes at N = 4, under 0.02 us of
// memory time.  The launch and the chain of dependent memory round trips
// are the bound.
//
// Design (PR 11; PR 9's kernel ran one thread a lane, 8 CTAs for 1,024
// lanes, each thread walking N * N * C contact entries in device memory with
// an early exit per pair: 5.6 of its 8.7 us).  One thread per (lane, object
// i): a group of P threads a lane (P the power of two >= N, so a group lies
// in one warp), kThreads / P lanes a CTA: 32 CTAs of 128 threads at N = 4
// and 1,024 lanes.  The gate is read alone first, so a closed gate costs
// one load.  Then every load that does not depend on another: the thread's
// parent cell, sel_valid, the object's goal and mask, and the contact lists
// of the CTA's actions, which the CTA stages in shared memory as one 32-bit
// word (rx, ry) per entry, masked entries set to kNoOffset, a word no
// offset between two cells can equal; then the static-block byte of the
// thread's object at its cell (the only load that waits on another), one
// barrier, and the push mask of object i by comparing the word of each pair
// (i, j) with every contact word: N * C compares, no early exit.  The
// group's N masks go through shared memory; each thread runs the closure
// (a worklist over set bits: reached |= push[k] & ~reached for every newly
// reached k, at most N rounds); the blocked, live and off-goal bits of the
// group's objects are one ballot each.  Thread i writes its object's child
// cell and moved byte (a warp's stores are contiguous), thread 0 of the
// group the lane's flags.  Contact lists above kStageWords words (a CTA's
// actions span at most 2 * N * N * C words when B >= 31: 96 at N = 4 and
// C = 3) stay in device memory and are read through the same code (the L1
// keeps them).  This is the one-word path, N <= 32 (kMaxObjects).
//
// Wide path (expand_wide_kernel, N > 32, any N).  A pusher's pushees no
// longer fit a word and a lane's objects no longer fit a warp, so a lane
// takes a CTA of kWideThreads threads, thread t holding objects t, t +
// kWideThreads, ...  The closure is a breadth-first walk over bit sets of
// ceil(N / 32) words in shared memory (reached, this round's frontier, the
// next one): in each round every thread tests each of its objects j not yet
// reached against every pusher k of the frontier (the C contact words of
// (a, k, j), read from device memory, against pos_k - pos_j) and ORs j into
// the next frontier; one barrier with an OR ends the round, and a round
// that adds nothing ends the walk.  It reaches the same fixpoint as the
// worklist and as the plain version's squaring: every object a path of
// pushes from the agent reaches.  Only the push relation's entries from
// frontier pushers are compared (each pusher once): N * reached * C
// compares a lane, not N^2 C.  The blocked, moved and off-goal tests are
// CTA-wide ORs (__syncthreads_or).  Bound as above, the launch and the
// rounds' barriers; 4B CTAs.
//
// Gate.  With a gate flag that is 0 (the search iteration is a no-op),
// every lane writes effective = goal = 0 and returns; children and moved
// are not written (the parents were not gathered).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

// Phase marks for scripts/profile_kernel_phases.py (no-ops here).
#ifndef PW_STOP
#define PW_STOP(k, v)
#endif

namespace {

constexpr int kMaxObjects = 32;
constexpr int kThreads = 128;
constexpr int kStageWords = 2048;  // the contact words a CTA stages in shared memory, at most
constexpr uint32_t kNoOffset = 0x80008000u;  // (-32768, -32768): no two cells are that far apart
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Expand {
  const int2* parents;          // (B, n) cells (x, y)
  const uint32_t* contacts;     // (4, n, n, C) rel offsets, int16 (rx, ry) = pos_i - pos_j as one word
  const uint8_t* cmask;         // (4, n, n, C)
  const uint8_t* static_block;  // (4, n, H, W)
  const uint8_t* obj_mask;      // (n,)
  const int2* goal_pos;         // (n,)
  const uint8_t* goal_mask;     // (n,)
  const uint8_t* sel_valid;     // (B,) or null: every parent valid
  const uint8_t* gate;          // scalar or null: open
  int2* children;               // (4B, n)
  uint8_t* moved;               // (4B, n)
  uint8_t* effective;           // (4B,)
  uint8_t* goal;                // (4B,)
  int B, n, C, H, W;
  int shift;                    // log2 P: P threads a lane
};

// The (rx, ry) word of an offset, as the int16 pair of a contact entry.
__device__ __forceinline__ uint32_t offset_word(int rx, int ry) {
  return static_cast<uint32_t>(static_cast<uint16_t>(rx)) | static_cast<uint32_t>(static_cast<uint16_t>(ry)) << 16;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) expand_kernel(Expand e) {
  __shared__ uint32_t staged[kStageWords];  // the CTA's actions' contact words, when kStaged
  __shared__ int2 cell[kThreads];
  __shared__ unsigned push[kThreads];
  const int t = threadIdx.x, lanes = kThreads >> e.shift, lane0 = blockIdx.x * lanes, nb = 4 * e.B;
  // The gate alone first: a closed one writes the CTA's flags (one warp,
  // contiguous bytes) and returns before any other load or index math.
  if (e.gate != nullptr && !*e.gate) {
    if (t < lanes && lane0 + t < nb) {
      e.effective[lane0 + t] = 0;
      e.goal[lane0 + t] = 0;
    }
    return;
  }
  const int P = 1 << e.shift, i = t & (P - 1), n = e.n;
  const int lane = lane0 + (t >> e.shift);
  const bool real = lane < nb, mine = real && i < n;
  const int a = real ? lane / e.B : 3, b = lane - a * e.B;
  const int a0 = lane0 / e.B;
  const int per_action = n * n * e.C;

  // Then every load that waits on nothing: the thread's parent cell (8
  // bytes, neighbouring threads on neighbouring cells), sel_valid, the
  // object's masks and goal, the CTA's contact words; then the static-block
  // byte at the cell (the one load that waits on another).
  const int2 pos = mine ? e.parents[static_cast<size_t>(b) * n + i] : make_int2(0, 0);
  const bool sel = real && (e.sel_valid == nullptr || e.sel_valid[b]);
  const bool live = mine && e.obj_mask[i];
  const bool has_goal = mine && e.goal_mask[i];
  const int2 target = mine ? e.goal_pos[i] : make_int2(0, 0);
  const int words = kStaged ? ((min(lane0 + lanes, nb) - 1) / e.B - a0 + 1) * per_action : 0;
  const size_t base = static_cast<size_t>(a0) * per_action;
  uint32_t w0 = kNoOffset;
  bool on0 = false;
  if (t < words) {  // both loads at once, then the select
    w0 = e.contacts[base + t];
    on0 = e.cmask[base + t];
  }
  const size_t plane = static_cast<size_t>(e.H) * e.W;
  const bool blocked =
      mine && e.static_block[(static_cast<size_t>(a) * n + i) * plane + static_cast<size_t>(pos.y) * e.W + pos.x];
  cell[t] = pos;
  if (t < words) staged[t] = on0 ? w0 : kNoOffset;
  for (int k = t + kThreads; k < words; k += kThreads) {
    const uint32_t w = e.contacts[base + k];
    const bool on = e.cmask[base + k];
    staged[k] = on ? w : kNoOffset;
  }
  __syncthreads();
  PW_STOP(1, cell[t ^ 1].x + static_cast<int>(blocked));  // phase: loads, staging, barrier

  // push[i]: the objects j that some contact of (a, i, j) pushes.
  const int g0 = t & ~(P - 1);  // the group's first thread
  unsigned mask = 0u;
  if (mine) {
    const uint32_t* row = kStaged ? staged + static_cast<size_t>((a - a0) * n + i) * n * e.C
                                  : e.contacts + (static_cast<size_t>(a) * n + i) * n * e.C;
    const uint8_t* mrow = e.cmask + (static_cast<size_t>(a) * n + i) * n * e.C;
    for (int j = 0; j < n; ++j) {
      const int2 q = cell[g0 + j];
      const uint32_t rel = offset_word(pos.x - q.x, pos.y - q.y);
      bool hit = false;
      for (int c = 0; c < e.C; ++c) {
        const uint32_t w = row[j * e.C + c];
        hit |= w == rel && (kStaged || mrow[j * e.C + c]);
      }
      mask |= static_cast<unsigned>(hit) << j;
    }
  }
  push[t] = mask;
  __syncwarp();
  PW_STOP(2, static_cast<int>(push[t ^ 1]));  // phase: push relation

  // The closure from the agent: a worklist of reached objects not yet expanded.
  unsigned reached = 1u, todo = 1u;
  while (todo) {
    const int k = __ffs(todo) - 1;
    todo &= todo - 1u;
    const unsigned fresh = push[g0 + k] & ~reached;
    reached |= fresh;
    todo |= fresh;
  }
  PW_STOP(3, static_cast<int>(reached));  // phase: closure

  // The group's bits, object k at bit k (a group starts at a multiple of P).
  const int gl = g0 & 31;
  const unsigned group = P == 32 ? kFull : ((1u << P) - 1u);
  const unsigned blocked_bits = (__ballot_sync(kFull, blocked) >> gl) & group;
  const unsigned live_bits = (__ballot_sync(kFull, live) >> gl) & group;
  const unsigned moved = (blocked_bits & reached) ? 0u : (reached & live_bits);
  const int m = (moved >> i) & 1u;
  const int dx = a == 0 ? -1 : (a == 1 ? 1 : 0);
  const int dy = a == 2 ? -1 : (a == 3 ? 1 : 0);
  const int2 child = make_int2(pos.x + dx * m, pos.y + dy * m);
  const bool off_goal = has_goal && (child.x != target.x || child.y != target.y);
  const unsigned off_bits = (__ballot_sync(kFull, off_goal) >> gl) & group;
  if (mine) {
    const size_t at = static_cast<size_t>(lane) * n + i;
    e.children[at] = child;
    e.moved[at] = static_cast<uint8_t>(m);
  }
  if (real && i == 0) {
    e.effective[lane] = moved != 0u && sel;
    e.goal[lane] = off_bits == 0u;
  }
}

constexpr int kWideThreads = 128;

// One lane a CTA, any n (see the header): the closure by rounds over
// ceil(n / 32)-word bit sets in dynamic shared memory (reached, frontier,
// next).
__global__ void __launch_bounds__(kWideThreads) expand_wide_kernel(Expand e) {
  extern __shared__ unsigned sets[];
  const int lane = blockIdx.x, t = threadIdx.x, n = e.n;
  if (e.gate != nullptr && !*e.gate) {
    if (t == 0) {
      e.effective[lane] = 0;
      e.goal[lane] = 0;
    }
    return;
  }
  const int a = lane / e.B, b = lane - a * e.B;
  const int words = (n + 31) >> 5;
  unsigned* reached = sets;
  unsigned* front = sets + words;
  unsigned* next = sets + 2 * words;
  const int2* cells = e.parents + static_cast<size_t>(b) * n;
  for (int w = t; w < words; w += kWideThreads) {
    reached[w] = front[w] = w == 0 ? 1u : 0u;  // the agent
    next[w] = 0u;
  }
  __syncthreads();
  for (;;) {
    for (int j = t; j < n; j += kWideThreads) {
      if (reached[j >> 5] >> (j & 31) & 1u) continue;
      const int2 pj = cells[j];
      bool hit = false;
      for (int w = 0; w < words && !hit; ++w) {
        for (unsigned f = front[w]; f != 0u && !hit; f &= f - 1u) {
          const int k = (w << 5) + __ffs(f) - 1;
          const int2 pk = cells[k];
          const uint32_t rel = offset_word(pk.x - pj.x, pk.y - pj.y);
          const size_t row = ((static_cast<size_t>(a) * n + k) * n + j) * e.C;
          for (int c = 0; c < e.C; ++c) hit |= e.contacts[row + c] == rel && e.cmask[row + c];
        }
      }
      if (hit) atomicOr(next + (j >> 5), 1u << (j & 31));
    }
    __syncthreads();
    bool grew = false;
    for (int w = t; w < words; w += kWideThreads) {
      const unsigned f = next[w];
      front[w] = f;
      reached[w] |= f;
      next[w] = 0u;
      grew |= f != 0u;
    }
    if (!__syncthreads_or(grew)) break;
  }

  // All or nothing: some reached object (the agent included) blocked.
  const size_t plane = static_cast<size_t>(e.H) * e.W;
  bool blocked = false;
  for (int i = t; i < n; i += kWideThreads) {
    if (!(reached[i >> 5] >> (i & 31) & 1u)) continue;
    const int2 pos = cells[i];
    blocked |= e.static_block[(static_cast<size_t>(a) * n + i) * plane + static_cast<size_t>(pos.y) * e.W + pos.x] != 0;
  }
  const bool nothing = __syncthreads_or(blocked) != 0;
  const int dx = a == 0 ? -1 : (a == 1 ? 1 : 0);
  const int dy = a == 2 ? -1 : (a == 3 ? 1 : 0);
  bool any_moved = false, off_goal = false;
  for (int i = t; i < n; i += kWideThreads) {
    const int2 pos = cells[i];
    const int m = !nothing && (reached[i >> 5] >> (i & 31) & 1u) && e.obj_mask[i];
    const int2 child = make_int2(pos.x + dx * m, pos.y + dy * m);
    const int2 target = e.goal_pos[i];
    const size_t at = static_cast<size_t>(lane) * n + i;
    e.children[at] = child;
    e.moved[at] = static_cast<uint8_t>(m);
    any_moved |= m != 0;
    off_goal |= e.goal_mask[i] && (child.x != target.x || child.y != target.y);
  }
  const bool moved = __syncthreads_or(any_moved) != 0;
  const bool off = __syncthreads_or(off_goal) != 0;
  if (t == 0) {
    e.effective[lane] = moved && (e.sel_valid == nullptr || e.sel_valid[b]);
    e.goal[lane] = !off;
  }
}

}  // namespace

// The largest number of objects (the states' second dimension) the one-word
// path (pw_expand) takes; pw_expand_wide takes any number.
extern "C" int pw_expand_max_objects() { return kMaxObjects; }

// Writes children (4B, n, 2) int32, moved (4B, n) bool, effective and goal
// (4B,) bool from parents (B, n, 2).  sel_valid and gate may be null.
// parents, goal_pos and children are 8-byte aligned, contacts 4-byte.
extern "C" int pw_expand(const void* parents, const void* contacts, const void* contacts_mask,
                         const void* static_block, const void* obj_mask, const void* goal_pos,
                         const void* goal_mask, const void* sel_valid, const void* gate, void* children,
                         void* moved, void* effective, void* goal, int B, int n, int C, int H, int W,
                         void* stream) {
  if (B < 0 || n < 1 || n > kMaxObjects || C < 1 || H < 1 || W < 1 || B > (1 << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  int shift = 0;
  while ((1 << shift) < n) ++shift;
  const int lanes = kThreads >> shift;
  // Consecutive lanes of one CTA touch at most this many action blocks.
  const int blocks = (lanes - 1 + B - 1) / B + 1;
  const int span = blocks < 4 ? blocks : 4;
  const bool staged = static_cast<long long>(span) * n * n * C <= kStageWords;
  Expand e{static_cast<const int2*>(parents),      static_cast<const uint32_t*>(contacts),
           static_cast<const uint8_t*>(contacts_mask), static_cast<const uint8_t*>(static_block),
           static_cast<const uint8_t*>(obj_mask),  static_cast<const int2*>(goal_pos),
           static_cast<const uint8_t*>(goal_mask), static_cast<const uint8_t*>(sel_valid),
           static_cast<const uint8_t*>(gate),      static_cast<int2*>(children),
           static_cast<uint8_t*>(moved),           static_cast<uint8_t*>(effective),
           static_cast<uint8_t*>(goal),            B, n, C, H, W, shift};
  const int grid = static_cast<int>((4ll * B + lanes - 1) / lanes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged)
    expand_kernel<true><<<grid, kThreads, 0, s>>>(e);
  else
    expand_kernel<false><<<grid, kThreads, 0, s>>>(e);
  return static_cast<int>(cudaGetLastError());
}

// pw_expand's wide path, for any n (the wrapper takes it above
// pw_expand_max_objects()): the same arguments and outputs.
extern "C" int pw_expand_wide(const void* parents, const void* contacts, const void* contacts_mask,
                              const void* static_block, const void* obj_mask, const void* goal_pos,
                              const void* goal_mask, const void* sel_valid, const void* gate, void* children,
                              void* moved, void* effective, void* goal, int B, int n, int C, int H, int W,
                              void* stream) {
  if (B < 0 || n < 1 || C < 1 || H < 1 || W < 1 || B > (1 << 28) || n > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Expand e{static_cast<const int2*>(parents),      static_cast<const uint32_t*>(contacts),
           static_cast<const uint8_t*>(contacts_mask), static_cast<const uint8_t*>(static_block),
           static_cast<const uint8_t*>(obj_mask),  static_cast<const int2*>(goal_pos),
           static_cast<const uint8_t*>(goal_mask), static_cast<const uint8_t*>(sel_valid),
           static_cast<const uint8_t*>(gate),      static_cast<int2*>(children),
           static_cast<uint8_t*>(moved),           static_cast<uint8_t*>(effective),
           static_cast<uint8_t*>(goal),            B, n, C, H, W, 0};
  const size_t smem = 3 * static_cast<size_t>((n + 31) / 32) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(expand_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  expand_wide_kernel<<<4 * B, kWideThreads, smem, static_cast<cudaStream_t>(stream)>>>(e);
  return static_cast<int>(cudaGetLastError());
}
