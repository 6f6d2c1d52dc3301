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
// action (shared by the block, so mostly L1 hits) and N static-block bytes,
// and writes 9N + 2 bytes: ~70 KB for the search's 1,024 lanes at N = 4.
// The launch is the bound.
//
// Design.  One thread a lane (no lane waits on another).  The push relation
// is N 32-bit masks in shared memory (push[i] = the objects i pushes, one
// column a thread, so no bank conflicts); the closure is a worklist over
// set bits: reached |= push[i] & ~reached for every newly reached i, at most
// N rounds of one AND each instead of log2 N float matmuls.  N <= 32.
//
// Gate.  With a gate flag that is 0 (the search iteration is a no-op),
// every lane writes effective = goal = 0 and returns; children and moved
// are not written (the parents were not gathered).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxObjects = 32;
constexpr int kThreads = 128;

struct Expand {
  const int* parents;          // (B, n, 2) int32 (x, y)
  const int16_t* contacts;     // (4, n, n, C, 2) rel offsets (rx, ry) = pos_i - pos_j
  const uint8_t* cmask;        // (4, n, n, C)
  const uint8_t* static_block; // (4, n, H, W)
  const uint8_t* obj_mask;     // (n,)
  const int* goal_pos;         // (n, 2)
  const uint8_t* goal_mask;    // (n,)
  const uint8_t* sel_valid;    // (B,) or null: every parent valid
  const uint8_t* gate;         // scalar or null: open
  int* children;               // (4B, n, 2)
  uint8_t* moved;              // (4B, n)
  uint8_t* effective;          // (4B,)
  uint8_t* goal;               // (4B,)
  int B, n, C, H, W;
};

__global__ void __launch_bounds__(kThreads) expand_kernel(Expand e) {
  __shared__ unsigned push[kMaxObjects][kThreads];
  const int t = threadIdx.x;
  const int lane = blockIdx.x * kThreads + t;
  if (lane >= 4 * e.B) return;
  if (e.gate != nullptr && !*e.gate) {
    e.effective[lane] = 0;
    e.goal[lane] = 0;
    return;
  }
  const int a = lane / e.B, b = lane % e.B, n = e.n;
  const int* pos = e.parents + static_cast<size_t>(b) * n * 2;

  for (int i = 0; i < n; ++i) {
    const int xi = pos[2 * i], yi = pos[2 * i + 1];
    unsigned mask = 0u;
    for (int j = 0; j < n; ++j) {
      const int rx = xi - pos[2 * j], ry = yi - pos[2 * j + 1];
      const size_t pair = (static_cast<size_t>(a) * n + i) * n + j;
      const int16_t* c = e.contacts + pair * e.C * 2;
      const uint8_t* cm = e.cmask + pair * e.C;
      for (int k = 0; k < e.C; ++k) {
        if (cm[k] && c[2 * k] == rx && c[2 * k + 1] == ry) {
          mask |= 1u << j;
          break;
        }
      }
    }
    push[i][t] = mask;
  }

  // The closure from the agent: a worklist of reached objects not yet expanded.
  unsigned reached = 1u, todo = 1u;
  while (todo) {
    const int i = __ffs(todo) - 1;
    todo &= todo - 1u;
    const unsigned fresh = push[i][t] & ~reached;
    reached |= fresh;
    todo |= fresh;
  }

  const size_t plane = static_cast<size_t>(e.H) * e.W;
  const uint8_t* sb = e.static_block + static_cast<size_t>(a) * n * plane;
  bool nothing = false;
  unsigned live = 0u;
  for (int i = 0; i < n; ++i) {
    if (e.obj_mask[i]) live |= 1u << i;
    if ((reached >> i) & 1u) {
      const size_t cell = static_cast<size_t>(pos[2 * i + 1]) * e.W + pos[2 * i];
      if (sb[i * plane + cell]) nothing = true;
    }
  }
  const unsigned moved = nothing ? 0u : (reached & live);
  const int dx = a == 0 ? -1 : (a == 1 ? 1 : 0);
  const int dy = a == 2 ? -1 : (a == 3 ? 1 : 0);
  int* child = e.children + static_cast<size_t>(lane) * n * 2;
  bool at_goal = true;
  for (int i = 0; i < n; ++i) {
    const int m = (moved >> i) & 1u;
    const int x = pos[2 * i] + dx * m, y = pos[2 * i + 1] + dy * m;
    child[2 * i] = x;
    child[2 * i + 1] = y;
    e.moved[static_cast<size_t>(lane) * n + i] = static_cast<uint8_t>(m);
    if (e.goal_mask[i] && (x != e.goal_pos[2 * i] || y != e.goal_pos[2 * i + 1])) at_goal = false;
  }
  e.effective[lane] = moved != 0u && (e.sel_valid == nullptr || e.sel_valid[b]);
  e.goal[lane] = at_goal;
}

}  // namespace

// The largest number of objects (the states' second dimension) the kernel takes.
extern "C" int pw_expand_max_objects() { return kMaxObjects; }

// Writes children (4B, n, 2) int32, moved (4B, n) bool, effective and goal
// (4B,) bool from parents (B, n, 2).  sel_valid and gate may be null.
extern "C" int pw_expand(const void* parents, const void* contacts, const void* contacts_mask,
                         const void* static_block, const void* obj_mask, const void* goal_pos,
                         const void* goal_mask, const void* sel_valid, const void* gate, void* children,
                         void* moved, void* effective, void* goal, int B, int n, int C, int H, int W,
                         void* stream) {
  if (B < 0 || n < 1 || n > kMaxObjects || C < 1 || H < 1 || W < 1 || B > (1 << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Expand e{static_cast<const int*>(parents),       static_cast<const int16_t*>(contacts),
           static_cast<const uint8_t*>(contacts_mask), static_cast<const uint8_t*>(static_block),
           static_cast<const uint8_t*>(obj_mask),  static_cast<const int*>(goal_pos),
           static_cast<const uint8_t*>(goal_mask), static_cast<const uint8_t*>(sel_valid),
           static_cast<const uint8_t*>(gate),      static_cast<int*>(children),
           static_cast<uint8_t*>(moved),           static_cast<uint8_t*>(effective),
           static_cast<uint8_t*>(goal),            B, n, C, H, W};
  expand_kernel<<<(4 * B + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(e);
  return static_cast<int>(cudaGetLastError());
}
