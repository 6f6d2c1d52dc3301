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
//   next, steps, achieved.  next_pos is the pre-reset transition;
//   reward_acc     (where given) reward_acc[b] + reward, one float32 add a
//                  rollout (no atomics, no order across rollouts), so a
//                  rollout's running total equals the plain version's
//                  `reward_acc += reward` bit for bit.
// Cells outside the grid are clamped into it for the static-block read (a
// valid state never has one: the table blocks every move out of the grid).
//
// Batch geometry.  The states, actions and puzzle indices are read through
// strides over up to kMaxDims batch dimensions (a stride 0 broadcasts), so
// ops.step.step's broadcast callers (the greedy policy's four actions over
// a stride-0 state batch) are one launch with no copy.  An action is int32
// or int64 (torch.randint's), or one value for all; outputs are
// contiguous.  A 1-D batch (VectorEnv.step's) needs no division; more
// dimensions divide in 32 bits (B < 2^31, checked on the host).
//
// Bound.  A rollout reads its cells (8N bytes), action, steps and achieved
// (16) and at most N^2 push bytes and N static-block bytes, and writes
// 16N + 14 bytes (+4 with reward_acc): ~0.5 MB at B = 4096, N = 4, 0.15 us
// of memory time, below a launch.  At that size the grid is 128 CTAs of 4
// warps, one a multiprocessor, so nothing hides a load's latency: the
// launch and the chain of dependent loads bound it.
//
// What held the first design back (0.0040 ms at B = 4096, N = 4, on an
// H100, 4.6x the launch floor): about five dependent round trips to
// memory a rollout (the offsets, then the action and puzzle index, then the
// object's cell, masks, goal and static-block byte, then the group's cells
// through shared memory and the push bytes, then achieved, steps and
// init_achieved after the ballots, then init_pos where done), 64-bit
// divisions in the offsets of every batch dimension, and loads behind
// branches and predicates, which the compiler issued one after another.
//
// Design (one-word path, n <= 32).  A group of P threads a rollout (P the
// power of two >= n, a template argument, so a group lies in one warp and
// the loops over the group's objects unroll), thread i holding object i,
// and every global load in one of two rounds, each issued unconditionally:
// a thread past the batch or past the objects reads the last rollout or
// object, a null array is swapped for one that holds as many entries, an
// index or offset is clamped into its table, and every value is masked
// after it arrives, so no load waits on a branch or on another load of
// its round:
//   round 1 (b alone): the action and the puzzle index (two 32-bit words
//     each, int32 or int64), steps, achieved and reward_acc, and the
//     cells: the group reads one contiguous row, thread i its own 8 bytes;
//   round 2 (p, a and the cells): the group's cells pass by __shfl_sync,
//     then the n push bytes (the live mask applied afterwards, from a
//     ballot of each thread's own obj_mask; above 8 objects only the
//     pairs within delta are read, each behind its predicate), obj_mask,
//     goal_mask, goal_pos, init_pos (unconditionally: 8 bytes from L2, not
//     worth a third round), init_achieved and the static-block byte.
// The closure then runs as a worklist over the group's 32-bit masks in
// shared memory (at most n rounds, no further loads); the blocked, live,
// at-goal and off-goal bits of the group are one ballot each; the reward,
// the flags and the writes need no load.  Thread i writes its object's
// cells, thread 0 the rollout's scalars and its reward_acc.  128 threads a
// CTA: 32 rollouts a CTA at N = 4, 128 CTAs at B = 4096.  On an H100 the
// two rounds alone, their loads behind branches and predicates, took the
// kernel to ~0.0028 ms; issued unconditionally, to ~0.0022 (PERF.md
// section 6).
//
// Wide path (n > 32, any n).  A CTA of kWideThreads threads a rollout,
// thread t holding objects t, t + kWideThreads, ...; the closure is a
// breadth-first walk over bit sets of ceil(n / 32) words in dynamic shared
// memory (reached, this round's frontier, the next one), as expand.cu's
// wide path walks them: each round tests every object not yet reached
// against each frontier pusher (one push-table byte a pair), one barrier
// with an OR ends it.  12 words at 100 objects: far inside shared memory.
// Round 1's loads are issued first there too; thread 0 keeps the total.
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
  float* reward_acc;           // (B,) or null: each rollout's running reward total, updated in place
  long long max_steps;         // LLONG_MAX for none
  int B, n, H, W, delta, P, action, action_bytes, pidx_bytes, ndim;
  unsigned size[kMaxDims];
  long long pos_stride[kMaxDims], act_stride[kMaxDims], pidx_stride[kMaxDims];
};

// Rollout b's element offsets into the states (int32s), actions and puzzle
// indices, from the row-major batch coordinates of b (b < B < 2^31).  The
// first dimension's coordinate is what is left of b: a 1-D batch divides
// nothing.
__device__ __forceinline__ void locate(const Env& e, unsigned b, long long& po, long long& ao, long long& qo) {
  po = ao = qo = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d > 0; --d) {
    if (d < e.ndim) {
      const unsigned q = b / e.size[d], c = b - q * e.size[d];
      b = q;
      po += c * e.pos_stride[d];
      ao += c * e.act_stride[d];
      qo += c * e.pidx_stride[d];
    }
  }
  po += b * e.pos_stride[0];
  ao += b * e.act_stride[0];
  qo += b * e.pidx_stride[0];
}

// An index operand's value at element `at` (int32 or int64: `bytes`), read
// as two 32-bit words so that neither load waits on a branch (for int32 the
// second read is the first word again).  A null operand (bytes 0) reads the
// first word of `any`, a valid pointer, and its value goes unused.
__device__ __forceinline__ long long read_index(const void* p, int bytes, long long at, const void* any) {
  const int* w = static_cast<const int*>(p != nullptr ? p : any);
  const long long k = at * (bytes >> 2);
  const int lo = w[k], hi = w[k + (bytes >> 3)];
  return bytes == 8 ? static_cast<long long>((static_cast<unsigned long long>(hi) << 32) | static_cast<unsigned>(lo))
                    : static_cast<long long>(lo);
}

__device__ __forceinline__ int clamp_index(long long v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : static_cast<int>(v));
}

// Round 1 of a rollout: the loads that depend on b alone (the action's and
// the puzzle index's raw values, steps, achieved and the running total),
// each issued unconditionally: a null array reads the first word of the
// states instead, and its value goes unused.
struct Round1 {
  long long a_raw, p_raw;
  int steps, prev;
  float acc;
};

__device__ __forceinline__ Round1 round1(const Env& e, unsigned b, long long ao, long long qo) {
  const bool env = e.steps != nullptr, acc = e.reward_acc != nullptr;
  Round1 r;
  r.a_raw = read_index(e.actions, e.action_bytes, ao, e.positions);
  r.p_raw = read_index(e.pidx, e.pidx_bytes, qo, e.positions);
  r.steps = (env ? e.steps : e.positions)[env ? b : 0];
  r.prev = (env ? e.achieved : e.positions)[env ? b : 0];
  r.acc = (acc ? e.reward_acc : reinterpret_cast<const float*>(e.positions))[acc ? b : 0];
  return r;
}

__device__ __forceinline__ int action_of(const Env& e, const Round1& r) {
  return e.actions != nullptr ? clamp_index(r.a_raw, 3) : e.action;
}

__device__ __forceinline__ int puzzle_of(const Env& e, const Round1& r) {
  return e.pidx != nullptr ? clamp_index(r.p_raw, e.P - 1) : 0;
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

// Whether the rollout resets (false for the transition alone), from round
// 1's steps.  Pure: no load.
__device__ __forceinline__ bool resets(const Env& e, const Round1& r, bool terminated) {
  if (e.steps == nullptr) return false;
  return terminated || static_cast<long long>(r.steps + 1) >= e.max_steps;
}

// The rollout's scalars, written by one of its threads; every value is in
// registers (`init_ach` is init_achieved[p]).
__device__ __forceinline__ void write_scalars(const Env& e, unsigned b, const Round1& r, bool terminated, int at_goal,
                                              int init_ach) {
  const int steps = r.steps + 1;
  const bool truncated = !terminated && static_cast<long long>(steps) >= e.max_steps;
  const bool done = terminated || truncated;
  const float reward = terminated ? 10.0f : __fsub_rn(static_cast<float>(at_goal - r.prev), 0.01f);
  e.reward[b] = reward;
  e.terminated[b] = terminated;
  e.truncated[b] = truncated;
  e.new_steps[b] = done ? 0 : steps;
  e.new_achieved[b] = done ? init_ach : at_goal;
  if (e.reward_acc != nullptr) e.reward_acc[b] = __fadd_rn(r.acc, reward);
}

template <int kP>
__global__ void __launch_bounds__(kThreads) env_step_kernel(Env e) {
  __shared__ unsigned push_s[kThreads];
  const int t = threadIdx.x, i = t & (kP - 1), n = e.n;
  const int g0 = t & ~(kP - 1), lane0 = g0 & 31;  // the group's first thread, in the CTA and in the warp
  const unsigned b = blockIdx.x * (kThreads / kP) + t / kP;
  const bool real = b < static_cast<unsigned>(e.B), mine = real && i < n;

  // Round 1, unconditionally: a thread past the batch reads the last
  // rollout, one past the objects the last object, and its values go unused.
  const unsigned bc = min(b, static_cast<unsigned>(e.B) - 1u);
  const int ic = min(i, n - 1);
  long long po, ao, qo;
  locate(e, bc, po, ao, qo);
  const Round1 r = round1(e, bc, ao, qo);
  const int2 pos = *reinterpret_cast<const int2*>(e.positions + po + 2 * ic);
  const int a = action_of(e, r), p = puzzle_of(e, r);

  // Round 2: the n push bytes, then the object's own masks, goal, initial
  // cell, static-block byte and the puzzle's initial count.  Up to 8
  // objects the group's cells come in by __shfl_sync first and every pair's
  // byte is read (its offset clamped into [-delta, delta], the value masked
  // afterwards), so no load waits on a predicate.  Above, a pair's byte is
  // read only where the two lie within delta (most pairs of a large state
  // do not), each load right after its two shuffles: reading every pair
  // there was the slower of the two on an H100 at 12-32 objects, and the
  // faster at 4-8.
  const int d = e.delta, K = 2 * d + 1;
  const size_t pn = static_cast<size_t>(p) * n;
  const uint8_t* row = e.push + ((static_cast<size_t>(p) * 4 + a) * n + ic) * n * K * K;
  unsigned mask = 0u;
  if (kP <= 8) {
    int2 cell[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) cell[j] = make_int2(__shfl_sync(kFull, pos.x, lane0 + j), __shfl_sync(kFull, pos.y, lane0 + j));
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int rx = pos.x - cell[j].x, ry = pos.y - cell[j].y;
      const bool near = j < n && rx >= -d && rx <= d && ry >= -d && ry <= d;
      const int jc = min(j, n - 1), xc = min(max(rx, -d), d), yc = min(max(ry, -d), d);
      const unsigned byte = row[(static_cast<size_t>(jc) * K + (yc + d)) * K + (xc + d)];
      mask |= static_cast<unsigned>((byte != 0u) & near) << j;
    }
  } else {
    uint8_t hit[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int rx = pos.x - __shfl_sync(kFull, pos.x, lane0 + j);
      const int ry = pos.y - __shfl_sync(kFull, pos.y, lane0 + j);
      const bool near = mine && j < n && rx >= -d && rx <= d && ry >= -d && ry <= d;
      hit[j] = near ? row[(static_cast<size_t>(j) * K + (ry + d)) * K + (rx + d)] : 0;
    }
#pragma unroll
    for (int j = 0; j < kP; ++j) mask |= static_cast<unsigned>(hit[j] != 0) << j;
  }
  const unsigned live_byte = e.obj_mask[pn + ic], goal_byte = e.goal_mask[pn + ic];
  const int2 target = e.goal_pos[pn + ic];
  const int2 init = (e.new_pos != nullptr ? e.init_pos : e.goal_pos)[pn + ic];
  const int init_ach = (e.steps != nullptr ? e.init_achieved : reinterpret_cast<const int*>(e.goal_pos))[p];
  const bool blocked_here = blocked_at(e, p, a, ic, pos);
  const bool live = (live_byte != 0u) & mine, has_goal = (goal_byte != 0u) & mine, blocked = blocked_here & mine;

  // push[i]: the live objects that object i pushes.
  const unsigned group = kFull >> (32 - kP);
  const unsigned live_bits = (__ballot_sync(kFull, live) >> lane0) & group;
  push_s[t] = live ? (mask & live_bits) : 0u;
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
  const unsigned blocked_bits = (__ballot_sync(kFull, blocked) >> lane0) & group;
  const unsigned moved = (blocked_bits & reached) ? 0u : (reached & live_bits);
  const int m = (moved >> i) & 1u;
  const int dx = a == 0 ? -1 : (a == 1 ? 1 : 0);
  const int dy = a == 2 ? -1 : (a == 3 ? 1 : 0);
  const int2 next = make_int2(pos.x + dx * m, pos.y + dy * m);
  const bool at = has_goal && next.x == target.x && next.y == target.y;
  const unsigned at_bits = (__ballot_sync(kFull, at) >> lane0) & group;
  const unsigned off_bits = (__ballot_sync(kFull, has_goal && !at) >> lane0) & group;
  if (!real) return;
  const bool terminated = off_bits == 0u;
  if (i == 0 && e.steps != nullptr) write_scalars(e, b, r, terminated, __popc(at_bits), init_ach);
  if (mine) {
    const size_t out = static_cast<size_t>(b) * n + i;
    e.next_pos[out] = next;
    if (e.new_pos != nullptr) e.new_pos[out] = resets(e, r, terminated) ? init : next;
  }
}

// One rollout a CTA, any n (see the header).
__global__ void __launch_bounds__(kWideThreads) env_step_wide_kernel(Env e) {
  extern __shared__ unsigned sets[];
  __shared__ int at_count;
  const unsigned b = blockIdx.x;
  const int t = threadIdx.x, n = e.n, words = (n + 31) >> 5;
  long long po, ao, qo;
  locate(e, b, po, ao, qo);
  const Round1 r = round1(e, b, ao, qo);
  const int a = action_of(e, r), p = puzzle_of(e, r);
  const size_t pn = static_cast<size_t>(p) * n;
  const int init_ach = t == 0 && e.steps != nullptr ? e.init_achieved[p] : 0;
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
  const bool terminated = !__syncthreads_or(off_goal);  // also orders at_count's adds before its read
  if (t == 0 && e.steps != nullptr) write_scalars(e, b, r, terminated, at_count, init_ach);
  if (e.new_pos != nullptr) {
    const bool done = resets(e, r, terminated);
    for (int i = t; i < n; i += kWideThreads) {  // the cells this thread wrote above
      const size_t out = static_cast<size_t>(b) * n + i;
      e.new_pos[out] = done ? e.init_pos[pn + i] : e.next_pos[out];
    }
  }
}

template <int kP>
void launch_one_word(const Env& e, cudaStream_t s) {
  constexpr int lanes = kThreads / kP;
  env_step_kernel<kP><<<static_cast<unsigned>((static_cast<long long>(e.B) + lanes - 1) / lanes), kThreads, 0, s>>>(e);
}

}  // namespace

// The largest number of objects the one-word path takes; wider states take
// the wide path.
extern "C" int pw_env_step_max_objects() { return kMaxObjects; }

// geom, on the host (int64): B, n, H, W, delta, P, action (used where
// actions is null), action_bytes, pidx_bytes, max_steps (LLONG_MAX for
// none), path (0 by n, 1 one-word, 2 wide), ndim, then size, pos_stride
// (int32 elements, even), act_stride and pidx_stride, kMaxDims each.  For
// the transition alone, steps, achieved, init_pos, init_achieved,
// reward_acc and every output but next_pos are null; reward_acc is
// nullable with steps too.  positions, goal_pos, init_pos and the outputs
// of cells are 8-byte aligned.
extern "C" int pw_env_step(const void* positions, const void* actions, const void* pidx, const void* steps,
                           const void* achieved, const void* static_block, const void* push, const void* obj_mask,
                           const void* goal_pos, const void* goal_mask, const void* init_pos,
                           const void* init_achieved, void* next_pos, void* new_pos, void* new_steps,
                           void* new_achieved, void* reward, void* terminated, void* truncated, void* reward_acc,
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
  e.reward_acc = static_cast<float*>(reward_acc);
  const long long B = geom[0];
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
  if (B < 0 || B > (1ll << 31) - 1 || e.n < 1 || e.n > (1 << 20) || e.H < 1 || e.W < 1 || e.delta < 0 ||
      e.P < 1 || e.ndim < 1 || e.ndim > kMaxDims || (actions != nullptr && e.action_bytes != 4 && e.action_bytes != 8) ||
      (pidx != nullptr && e.pidx_bytes != 4 && e.pidx_bytes != 8) || path < 0 || path > 2 ||
      (path == 1 && e.n > kMaxObjects) || (steps != nullptr && (achieved == nullptr || init_pos == nullptr ||
      init_achieved == nullptr || new_pos == nullptr || new_steps == nullptr || new_achieved == nullptr ||
      reward == nullptr || terminated == nullptr || truncated == nullptr)) ||
      (steps == nullptr && reward_acc != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  e.B = static_cast<int>(B);
  for (int d = 0; d < kMaxDims; ++d) {
    const long long size = geom[12 + d];
    e.pos_stride[d] = geom[12 + kMaxDims + d];
    e.act_stride[d] = geom[12 + 2 * kMaxDims + d];
    e.pidx_stride[d] = geom[12 + 3 * kMaxDims + d];
    if (size < 0 || size > (1ll << 31) - 1 || e.pos_stride[d] % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
    e.size[d] = static_cast<unsigned>(size);
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
  } else if (e.n <= 1) {
    launch_one_word<1>(e, s);
  } else if (e.n <= 2) {
    launch_one_word<2>(e, s);
  } else if (e.n <= 4) {
    launch_one_word<4>(e, s);
  } else if (e.n <= 8) {
    launch_one_word<8>(e, s);
  } else if (e.n <= 16) {
    launch_one_word<16>(e, s);
  } else {
    launch_one_word<32>(e, s);
  }
  return static_cast<int>(cudaGetLastError());
}
