// The environment step: a batch of rollouts' transition, goal test, reward,
// truncation and auto-reset in one launch (VectorEnv.step), or the
// transition alone (ops.step.step).
//
// Replaces XLA code of the JAX package, not a TPU kernel:
// pushworld_tpu/ops/step.py step (line 70: the push relation gathered from
// the dense push table, its closure by log2 N matrix squarings, the
// static-block gather), is_goal_state and count_achieved_goals (192-202),
// and pushworld_tpu/envs/vector_env.py VectorEnv.step (110-153: reward,
// truncation, auto-reset), which JAX jits into one program.  The plain
// PyTorch form (pushworld_tpu_torch/ops/step.py env_step_reference) runs
// them eagerly: some 75 kernels a step.
//
// What it computes, per rollout b, as the plain version does:
//   a, p           the action clamped to [0, 3] and the puzzle index to
//                  [0, P) (JAX's gathers clamp an index; the environment's
//                  reset checks the puzzle range on the host);
//   push[i] bit j  obj_mask[i] & obj_mask[j] & |pos_i - pos_j| <= delta
//                  & push[p, a, i, j, ry + delta, rx + delta];
//   reached        the closure of push from the agent (object 0), which the
//                  plain version's squaring reaches exactly;
//   nothing        static_block[p, a, i, pos_i] for some reached i (the
//                  agent always reached): all or nothing;
//   next           pos + displacement(a) * (reached & ~nothing & obj_mask);
//   terminated     every goal object at its goal; achieved the count at it;
// and, for the environment (steps non-null):
//   reward         10.0f where terminated, else (float)(achieved - prev)
//                  - 0.01f (one float32 rounding, as PyTorch and XLA do);
//   steps + 1, truncated = !terminated & steps >= max_steps, done =
//   terminated | truncated; the next state is the puzzle's initial
//   positions, 0 steps and its initial achieved count where done, else
//   next, steps, achieved.  next_pos is the pre-reset transition.
// Cells outside the grid are clamped into it for the static-block read (a
// valid state never has one: the table blocks every move out of the grid).
//
// Batch geometry.  The states, actions and puzzle indices are read through
// strides over up to kMaxDims batch dimensions (a stride 0 broadcasts), so
// ops.step.step's broadcast callers (the greedy policy's four actions over
// a stride-0 state batch) are one launch with no copy.  An action is int32
// or int64 (torch.randint's), or one value for all; outputs are
// contiguous.
//
// Bound.  A rollout reads its cells (8N bytes), action, steps and achieved
// (16) and at most N^2 push bytes and N static-block bytes, and writes
// 16N + 14 bytes: ~0.5 MB at B = 4096, N = 4, 0.15 us of memory time, below
// a launch.  The launch and the chain of dependent loads (cells, then the
// push bytes of each reached pusher, then the static-block bytes) bound it.
//
// Design (one-word path, n <= 32).  A group of P threads a rollout (P the
// power of two >= n, so a group lies in one warp), thread i holding object
// i: the group's cells go through shared memory, thread i builds push[i]
// (n table reads, all independent), the masks go through shared memory and
// each thread runs the closure as a worklist over set bits (at most n
// rounds, no further loads); the blocked, moved, at-goal and off-goal bits
// of the group are one ballot each.  Thread i writes its object's cells,
// thread 0 the rollout's scalars.  128 threads a CTA: 32 rollouts a CTA at
// N = 4, 128 CTAs at B = 4096.
//
// Wide path (n > 32, any n).  A CTA of kWideThreads threads a rollout,
// thread t holding objects t, t + kWideThreads, ...; the closure is a
// breadth-first walk over bit sets of ceil(n / 32) words in dynamic shared
// memory (reached, this round's frontier, the next one), as expand.cu's
// wide path walks them: each round tests every object not yet reached
// against each frontier pusher (one push-table byte a pair), one barrier
// with an OR ends it.  12 words at 100 objects: far inside shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxObjects = 32;
constexpr int kThreads = 128;
constexpr int kWideThreads = 128;
constexpr int kMaxDims = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Env {
  const int* positions;        // int32 cells, (x, y) pairs, n a state, batch strides below
  const void* actions;         // int32 / int64, or null: `action` for every rollout
  const void* pidx;            // int32 / int64, or null: puzzle 0
  const int* steps;            // (B,) or null: the transition alone
  const int* achieved;         // (B,)
  const uint8_t* static_block; // (P, 4, n, H, W)
  const uint8_t* push;         // (P, 4, n, n, K, K)
  const uint8_t* obj_mask;     // (P, n)
  const int2* goal_pos;        // (P, n)
  const uint8_t* goal_mask;    // (P, n)
  const int2* init_pos;        // (P, n)
  const int* init_achieved;    // (P,)
  int2* next_pos;              // (B, n)
  int2* new_pos;               // (B, n), the state after auto-reset
  int* new_steps;              // (B,)
  int* new_achieved;           // (B,)
  float* reward;               // (B,)
  uint8_t* terminated;         // (B,)
  uint8_t* truncated;          // (B,)
  long long B, max_steps;      // max_steps: LLONG_MAX for none
  int n, H, W, delta, P, action, action_bytes, pidx_bytes, ndim, shift;
  long long size[kMaxDims], pos_stride[kMaxDims], act_stride[kMaxDims], pidx_stride[kMaxDims];
};

// Rollout b's element offsets into the states (int32s), actions and puzzle
// indices, from the row-major batch coordinates of b.
__device__ __forceinline__ void locate(const Env& e, long long b, long long& po, long long& ao, long long& qo) {
  po = ao = qo = 0;
  for (int d = e.ndim - 1; d >= 0; --d) {
    const long long c = e.size[d] > 1 ? b % e.size[d] : 0;
    b = e.size[d] > 1 ? b / e.size[d] : b;
    po += c * e.pos_stride[d];
    ao += c * e.act_stride[d];
    qo += c * e.pidx_stride[d];
  }
}

__device__ __forceinline__ long long read_index(const void* p, int bytes, long long at) {
  return bytes == 8 ? static_cast<const long long*>(p)[at] : static_cast<long long>(static_cast<const int*>(p)[at]);
}

__device__ __forceinline__ int clamp_index(long long v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : static_cast<int>(v));
}

// The rollout's action and puzzle.
__device__ __forceinline__ void action_and_puzzle(const Env& e, long long ao, long long qo, int& a, int& p) {
  a = e.actions != nullptr ? clamp_index(read_index(e.actions, e.action_bytes, ao), 3) : e.action;
  p = e.pidx != nullptr ? clamp_index(read_index(e.pidx, e.pidx_bytes, qo), e.P - 1) : 0;
}

__device__ __forceinline__ bool blocked_at(const Env& e, int p, int a, int i, int2 c) {
  const int x = min(max(c.x, 0), e.W - 1), y = min(max(c.y, 0), e.H - 1);
  const size_t plane = static_cast<size_t>(e.H) * e.W;
  return e.static_block[((static_cast<size_t>(p) * 4 + a) * e.n + i) * plane + static_cast<size_t>(y) * e.W + x] != 0;
}

// Does object i at ci push object j at cj under (p, a)?  Both live.
__device__ __forceinline__ bool pushes(const Env& e, int p, int a, int i, int j, int2 ci, int2 cj) {
  const int rx = ci.x - cj.x, ry = ci.y - cj.y, d = e.delta, K = 2 * d + 1;
  if (rx < -d || rx > d || ry < -d || ry > d) return false;
  const size_t row = ((static_cast<size_t>(p) * 4 + a) * e.n + i) * e.n + j;
  return e.push[(row * K + (ry + d)) * K + (rx + d)] != 0;
}

// The environment's scalars of rollout b (written where `write`: by one
// thread of the rollout's threads); returns whether it resets.
__device__ __forceinline__ bool finish(const Env& e, long long b, int p, bool off_goal, int at_goal, bool write) {
  if (e.steps == nullptr) return false;  // the transition alone
  const bool terminated = !off_goal;
  const int prev = e.achieved[b];
  const int steps = e.steps[b] + 1;
  const bool truncated = !terminated && static_cast<long long>(steps) >= e.max_steps;
  const bool done = terminated || truncated;
  if (write) {
    e.reward[b] = terminated ? 10.0f : __fsub_rn(static_cast<float>(at_goal - prev), 0.01f);
    e.terminated[b] = terminated;
    e.truncated[b] = truncated;
    e.new_steps[b] = done ? 0 : steps;
    e.new_achieved[b] = done ? e.init_achieved[p] : at_goal;
  }
  return done;
}

__global__ void __launch_bounds__(kThreads) env_step_kernel(Env e) {
  __shared__ int2 cell[kThreads];
  __shared__ unsigned push_s[kThreads];
  const int t = threadIdx.x, P = 1 << e.shift, i = t & (P - 1), n = e.n;
  const long long b = static_cast<long long>(blockIdx.x) * (kThreads >> e.shift) + (t >> e.shift);
  const bool real = b < e.B, mine = real && i < n;
  long long po = 0, ao = 0, qo = 0;
  int a = 0, p = 0;
  if (real) {
    locate(e, b, po, ao, qo);
    action_and_puzzle(e, ao, qo, a, p);
  }
  const size_t pn = static_cast<size_t>(p) * n;
  const int2 pos = mine ? *reinterpret_cast<const int2*>(e.positions + po + 2 * i) : make_int2(0, 0);
  const bool live = mine && e.obj_mask[pn + i];
  const bool has_goal = mine && e.goal_mask[pn + i];
  const int2 target = mine ? e.goal_pos[pn + i] : make_int2(0, 0);
  const bool blocked = mine && blocked_at(e, p, a, i, pos);
  cell[t] = pos;
  __syncwarp();

  // push[i]: the live objects that object i pushes.
  const int g0 = t & ~(P - 1);
  unsigned mask = 0u;
  if (live) {
    for (int j = 0; j < n; ++j) {
      const bool hit = e.obj_mask[pn + j] && pushes(e, p, a, i, j, pos, cell[g0 + j]);
      mask |= static_cast<unsigned>(hit) << j;
    }
  }
  push_s[t] = mask;
  __syncwarp();

  // The closure from the agent: a worklist of reached objects not yet expanded.
  unsigned reached = 1u, todo = 1u;
  while (todo) {
    const int k = __ffs(todo) - 1;
    todo &= todo - 1u;
    const unsigned fresh = push_s[g0 + k] & ~reached;
    reached |= fresh;
    todo |= fresh;
  }

  // The group's bits, object k at bit k.
  const int gl = g0 & 31;
  const unsigned group = P == 32 ? kFull : ((1u << P) - 1u);
  const unsigned blocked_bits = (__ballot_sync(kFull, blocked) >> gl) & group;
  const unsigned live_bits = (__ballot_sync(kFull, live) >> gl) & group;
  const unsigned moved = (blocked_bits & reached) ? 0u : (reached & live_bits);
  const int m = (moved >> i) & 1u;
  const int dx = a == 0 ? -1 : (a == 1 ? 1 : 0);
  const int dy = a == 2 ? -1 : (a == 3 ? 1 : 0);
  const int2 next = make_int2(pos.x + dx * m, pos.y + dy * m);
  const bool at = has_goal && next.x == target.x && next.y == target.y;
  const unsigned at_bits = (__ballot_sync(kFull, at) >> gl) & group;
  const unsigned off_bits = (__ballot_sync(kFull, has_goal && !at) >> gl) & group;
  if (!real) return;
  const bool done = finish(e, b, p, off_bits != 0u, __popc(at_bits), i == 0);
  if (mine) {
    const size_t out = static_cast<size_t>(b) * n + i;
    e.next_pos[out] = next;
    if (e.new_pos != nullptr) e.new_pos[out] = done ? e.init_pos[pn + i] : next;
  }
}

// One rollout a CTA, any n (see the header).
__global__ void __launch_bounds__(kWideThreads) env_step_wide_kernel(Env e) {
  extern __shared__ unsigned sets[];
  __shared__ int at_count;
  const long long b = blockIdx.x;
  const int t = threadIdx.x, n = e.n, words = (n + 31) >> 5;
  long long po, ao, qo;
  int a, p;
  locate(e, b, po, ao, qo);
  action_and_puzzle(e, ao, qo, a, p);
  const size_t pn = static_cast<size_t>(p) * n;
  const int2* cells = reinterpret_cast<const int2*>(e.positions + po);
  unsigned* reached = sets;
  unsigned* front = sets + words;
  unsigned* next_set = sets + 2 * words;
  for (int w = t; w < words; w += kWideThreads) {
    reached[w] = front[w] = w == 0 ? 1u : 0u;  // the agent
    next_set[w] = 0u;
  }
  if (t == 0) at_count = 0;
  __syncthreads();
  for (;;) {
    for (int j = t; j < n; j += kWideThreads) {
      if ((reached[j >> 5] >> (j & 31) & 1u) || !e.obj_mask[pn + j]) continue;
      const int2 pj = cells[j];
      bool hit = false;
      for (int w = 0; w < words && !hit; ++w) {
        for (unsigned f = front[w]; f != 0u && !hit; f &= f - 1u) {
          const int k = (w << 5) + __ffs(f) - 1;
          hit = e.obj_mask[pn + k] && pushes(e, p, a, k, j, cells[k], pj);
        }
      }
      if (hit) atomicOr(next_set + (j >> 5), 1u << (j & 31));
    }
    __syncthreads();
    bool grew = false;
    for (int w = t; w < words; w += kWideThreads) {
      const unsigned f = next_set[w];
      front[w] = f;
      reached[w] |= f;
      next_set[w] = 0u;
      grew |= f != 0u;
    }
    if (!__syncthreads_or(grew)) break;
  }

  // All or nothing: some reached object (the agent included) blocked.
  bool blocked = false;
  for (int i = t; i < n; i += kWideThreads) {
    if (reached[i >> 5] >> (i & 31) & 1u) blocked |= blocked_at(e, p, a, i, cells[i]);
  }
  const bool nothing = __syncthreads_or(blocked) != 0;
  const int dx = a == 0 ? -1 : (a == 1 ? 1 : 0);
  const int dy = a == 2 ? -1 : (a == 3 ? 1 : 0);
  bool off_goal = false;
  int at_goal = 0;
  for (int i = t; i < n; i += kWideThreads) {
    const int2 pos = cells[i];
    const int m = !nothing && (reached[i >> 5] >> (i & 31) & 1u) && e.obj_mask[pn + i];
    const int2 next = make_int2(pos.x + dx * m, pos.y + dy * m);
    const int2 target = e.goal_pos[pn + i];
    const bool has_goal = e.goal_mask[pn + i] != 0;
    const bool at = has_goal && next.x == target.x && next.y == target.y;
    at_goal += at;
    off_goal |= has_goal && !at;
    e.next_pos[static_cast<size_t>(b) * n + i] = next;
  }
  if (at_goal) atomicAdd(&at_count, at_goal);
  const bool off = __syncthreads_or(off_goal) != 0;  // also orders at_count's adds before its read
  const bool done = finish(e, b, p, off, at_count, t == 0);
  if (e.new_pos != nullptr) {
    for (int i = t; i < n; i += kWideThreads) {  // the cells this thread wrote above
      const size_t out = static_cast<size_t>(b) * n + i;
      e.new_pos[out] = done ? e.init_pos[pn + i] : e.next_pos[out];
    }
  }
}

}  // namespace

// The largest number of objects the one-word path takes; wider states take
// the wide path.
extern "C" int pw_env_step_max_objects() { return kMaxObjects; }

// geom, on the host (int64): B, n, H, W, delta, P, action (used where
// actions is null), action_bytes, pidx_bytes, max_steps (LLONG_MAX for
// none), path (0 by n, 1 one-word, 2 wide), ndim, then size, pos_stride
// (int32 elements, even), act_stride and pidx_stride, kMaxDims each.  For
// the transition alone, steps, achieved, init_pos, init_achieved and every
// output but next_pos are null.  positions, goal_pos, init_pos and the
// outputs of cells are 8-byte aligned.
extern "C" int pw_env_step(const void* positions, const void* actions, const void* pidx, const void* steps,
                           const void* achieved, const void* static_block, const void* push, const void* obj_mask,
                           const void* goal_pos, const void* goal_mask, const void* init_pos,
                           const void* init_achieved, void* next_pos, void* new_pos, void* new_steps,
                           void* new_achieved, void* reward, void* terminated, void* truncated,
                           const long long* geom, void* stream) {
  Env e{};
  e.positions = static_cast<const int*>(positions);
  e.actions = actions;
  e.pidx = pidx;
  e.steps = static_cast<const int*>(steps);
  e.achieved = static_cast<const int*>(achieved);
  e.static_block = static_cast<const uint8_t*>(static_block);
  e.push = static_cast<const uint8_t*>(push);
  e.obj_mask = static_cast<const uint8_t*>(obj_mask);
  e.goal_pos = static_cast<const int2*>(goal_pos);
  e.goal_mask = static_cast<const uint8_t*>(goal_mask);
  e.init_pos = static_cast<const int2*>(init_pos);
  e.init_achieved = static_cast<const int*>(init_achieved);
  e.next_pos = static_cast<int2*>(next_pos);
  e.new_pos = static_cast<int2*>(new_pos);
  e.new_steps = static_cast<int*>(new_steps);
  e.new_achieved = static_cast<int*>(new_achieved);
  e.reward = static_cast<float*>(reward);
  e.terminated = static_cast<uint8_t*>(terminated);
  e.truncated = static_cast<uint8_t*>(truncated);
  e.B = geom[0];
  e.n = static_cast<int>(geom[1]);
  e.H = static_cast<int>(geom[2]);
  e.W = static_cast<int>(geom[3]);
  e.delta = static_cast<int>(geom[4]);
  e.P = static_cast<int>(geom[5]);
  e.action = static_cast<int>(geom[6]);
  e.action_bytes = static_cast<int>(geom[7]);
  e.pidx_bytes = static_cast<int>(geom[8]);
  e.max_steps = geom[9];
  e.ndim = static_cast<int>(geom[11]);
  const int path = static_cast<int>(geom[10]);
  if (e.B < 0 || e.B > (1ll << 31) - 1 || e.n < 1 || e.n > (1 << 20) || e.H < 1 || e.W < 1 || e.delta < 0 ||
      e.P < 1 || e.ndim < 1 || e.ndim > kMaxDims || (actions != nullptr && e.action_bytes != 4 && e.action_bytes != 8) ||
      (pidx != nullptr && e.pidx_bytes != 4 && e.pidx_bytes != 8) || path < 0 || path > 2 ||
      (path == 1 && e.n > kMaxObjects) || (steps != nullptr && (achieved == nullptr || init_pos == nullptr ||
      init_achieved == nullptr || new_pos == nullptr || new_steps == nullptr || new_achieved == nullptr ||
      reward == nullptr || terminated == nullptr || truncated == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < kMaxDims; ++d) {
    e.size[d] = geom[12 + d];
    e.pos_stride[d] = geom[12 + kMaxDims + d];
    e.act_stride[d] = geom[12 + 2 * kMaxDims + d];
    e.pidx_stride[d] = geom[12 + 3 * kMaxDims + d];
    if (e.pos_stride[d] % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e.B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 2 || (path == 0 && e.n > kMaxObjects)) {
    const size_t smem = 3 * static_cast<size_t>((e.n + 31) / 32) * sizeof(unsigned);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(env_step_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    env_step_wide_kernel<<<static_cast<unsigned>(e.B), kWideThreads, smem, s>>>(e);
  } else {
    while ((1 << e.shift) < e.n) ++e.shift;
    const long long lanes = kThreads >> e.shift;
    env_step_kernel<<<static_cast<unsigned>((e.B + lanes - 1) / lanes), kThreads, 0, s>>>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
