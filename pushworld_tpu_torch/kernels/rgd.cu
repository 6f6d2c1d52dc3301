// The fewest-tools Recursive Graph Distance heuristic of a batch of states,
// totals and needs-deeper flags, in one launch.
//
// Replaces XLA code of the JAX package, not a TPU kernel:
// pushworld_tpu/ops/rgd.py _rgd_impl (lines 526-601) with _all_dirs_cost
// (604-655), _tool_push_cost, _agent_push_cost and
// _push_cost_all_dirs_depth0 (343-479), whose
// plain PyTorch form (pushworld_tpu_torch/ops/rgd.py rgd_heuristic_reference)
// is an unrolled recursion of whole-batch gathers: with the rest of the
// search iteration, ~550 kernels an iteration at pushing depth 0 and
// 6,600-15,000 at depth 3.
//
// Bound.  The function reads, for each state, its positions and a few
// entries of the tables a chain of pushes needs (contact lists, movement
// graph bits, compact vertex ids, packed distances), and writes 5 bytes.  At
// depth 0 that is a few dozen gathers a state: the launch is the bound.  At
// depth 3 it is ~16 N^2 C gathers (N movables, C contacts a pusher-pushee
// pair) and ~16 N^3 min-adds a goal in shared memory: far below both the
// memory rate and the float rate at the search's 1,024 states, so latency
// (chains of dependent gathers, barriers) is what the design works on.
//
// Design.  With q the pushee, a its move, r a pusher and a2 the pusher's own
// first move:
//   A0[q][a]          depth-0 cost (the agent pushes q): 1 + min over the
//                     agent's contact cells of dist(agent -> contact);
//   M[q][a][r][a2]    min over the contacts c of the push of q by r of the
//                     plain version's `base` (0 for a simultaneous push,
//                     else dist(r's next cell -> contact) + 1; INF where
//                     infeasible).  It does not depend on the skip set or
//                     the depth, so one row serves every table;
//   T(S, 0) = A0,     T(S, d)[q][a] = min over pushers r not in S u {q}, a2
//                     of M[q][a][r][a2] + T(S u {q}, d - 1)[r][a2].
// A goal o's cost at depth D >= 1 is min over its moves a of DG + min over
// r != o, a2 of M[o][a][r][a2] + T({o}, D - 1)[r][a2].
//
// The depth-0 pass is one warp a state, lane p holding one (goal, move)
// pair: the valid flag alone first (a closed gate or a dropped lane costs
// that load and its fill), then the positions (one 8-byte load a lane),
// then every gather the pass needs in one wave (the move's feasibility, the
// distance to goal, the agent's vertex, the contacts' vertex ids), then the
// packed distances; shuffles take the min over the four moves, and lane 0
// adds each goal's cost to the total in goal order.  When the deepest
// depth is 0 (max_depth 0, or fewer than three movables) the launch is
// rgd_kernel_d0: 8 states a CTA, no shared memory, no barrier.
//
// Deeper, rgd_kernel_deep gives each state a CTA of kThreads threads: warp
// 0 runs the depth-0 pass while the other warps fill what a deeper depth
// reads first (every pusher's A0 row, its own first moves, its distance
// block's offset and stride), and one barrier later a state whose goals are
// all finite at depth 0 (or cannot move) writes its result.  The others go
// on to the tables, in shared memory: rows of M are filled one (q, a, r)
// triple a thread, its contacts in a loop (a thread a contact with a shared
// atomic min was 17-20% slower on an H100 on searches at depths 3-4, where
// every CTA fills its tables at once); T(S, 1) is one parallel pass, T(S, 2) two
// (every T(S u {q}, 1) at once, then the min), deeper tables a loop over q
// on top of T(., 2).  Barriers stand only between table levels.  Goals run
// in order, depths from 1 up, and a goal stops at its first finite depth
// (fewest tools).
//
// Exactness.  Every value is an integer-valued float32 or INF = 1e9, every
// min is order-free, and each addition is the plain version's own
// (dist + 1, min + inner, goal_dist + cost, total + cost, 1 + min), in the
// same order: the result is bit-equal.  The caller's `where`s overwrite two
// kinds of value whatever they hold, so they are never computed: depths above
// n_real - 2, and table entries of pushers that the valid-pusher mask drops
// (the agent, padding objects, the pushee and the skip set).  No fast-math,
// no FMA (there is no product).
//
// Valid mask.  With a `valid` array (the search passes its is_new or
// sel_valid lanes), a state that is not valid gets the fill (total INF,
// deeper false) before anything else of it is read: the search drops those
// lanes' values, and at a closed gate their states are never written.  The
// plain version applies the same fill.
//
// The one-word path: n <= kMaxObjects (skip sets are 32-bit masks, one
// lane an object; M is 64 KB at 32 objects), any max_depth (depths above 3
// run the loop of T(., 2) tables).
//
// Wide path (n > kMaxObjects, any n): rgd_wide_kernel_d0 and
// rgd_wide_kernel_deep, the same algorithm, the same additions in the same
// order, so the same bits.  What the one-word path keeps in a lane or a
// word it keeps elsewhere:
//   - positions: a lane no longer holds every object, so the depth-0 pass
//     and the prefetch load the positions they need from device memory;
//   - skip sets: no 32-bit masks.  The sets a CTA walks share one uniform
//     part (the goal and the chain of pushers above the current table),
//     held as a flag an object in EX and changed by thread 0 between
//     barriers; a thread's own pushee and pusher are passed beside it.  The
//     depth-first walk of table_deep keeps its next pusher of each level in
//     STK (dmax + 1 ints), likewise;
//   - which rows of M are filled: the goal's own row at depth 1, every row
//     from depth 2 (a row filled twice gets the same values);
//   - the tables: M is 64 n nr bytes (70 KB at 33 objects, 262 KB at 64,
//     640 KB at 100) and TX 16 nr^2 (from depth 3).  Where the whole
//     layout fits the card's opt-in shared memory (227 KB on an H100: up to
//     59 objects of one goal, 53 from depth 3) it is there, a CTA a state;
//     else every array of the layout goes to a device scratch of one layout
//     a CTA, and a persistent grid of 2 CTAs an SM (264 on an H100) walks
//     the states, so the scratch is sized by the CTAs in flight, not by the
//     batch: 810 KB a CTA, 214 MB in all, at 100 objects from depth 3 (648
//     KB and 171 MB at depth 2).  __syncthreads orders a CTA's global
//     accesses as it orders its shared ones.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PW_STOP
#define PW_STOP(k, v)
#endif

namespace {

constexpr float kInf = 1e9f;
constexpr float kFinite = 1e8f;
constexpr int kDInf = 65535;     // the packed distance blocks' INF
constexpr int kNoNext = -2;      // IU entry: the pusher's own move is infeasible
constexpr int kMaxObjects = 32;
constexpr int kThreads = 128;    // a CTA of the deep kernel (a state)
constexpr int kStatesD0 = 8;     // states (warps) a CTA of the depth-0 kernel
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Rgd {
  const int* states;         // (B, n, 2) int32 (x, y), 8-byte aligned
  const uint8_t* E;          // (4, n, H, W) bool
  const int* Dflat;          // packed compact distance blocks, 65535 = INF
  const int* vidx;           // (rows, H*W) compact vertex id, -1 = none
  const int* doff;           // (rows,)
  const int* dstride;        // (rows,)
  const float* DG;           // (n, H, W) distance to goal
  const int16_t* contacts;   // (4, n, n, C, 2) [move, pusher, pushee, c]
  const uint8_t* cmask;      // (4, n, n, C)
  const int16_t* cvidx_a;    // (4, n, H*W, Ca)
  const int* goal_pos;       // (n, 2)
  const uint8_t* goal_mask;  // (n,)
  const uint8_t* valid;      // (B,) or null: every state valid
  float* total;              // (B,)
  uint8_t* deeper;           // (B,)
  int B, n, n_real, max_goals, H, W, C, Ca, max_depth;
};

__host__ __device__ inline int deepest(int max_depth, int n_real) {
  return max_depth < n_real - 2 ? max_depth : n_real - 2;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
__device__ __forceinline__ int move_dx(int a) { return a < 2 ? (a & 1) * 2 - 1 : 0; }
__device__ __forceinline__ int move_dy(int a) { return a < 2 ? 0 : (a & 1) * 2 - 1; }

// E[a, o, y, x], false outside the grid.
__device__ __forceinline__ bool edge(const Rgd& t, int a, int o, int x, int y) {
  if (x < 0 || x >= t.W || y < 0 || y >= t.H) return false;
  return t.E[(static_cast<size_t>(a * t.n + o) * t.H + y) * t.W + x] != 0;
}

__device__ __forceinline__ float dist_value(int d) { return d != kDInf ? static_cast<float>(d) : kInf; }

// Object `lane`'s position (lane < n), one 8-byte load.
__device__ __forceinline__ int2 load_position(const Rgd& t, int b, int lane) {
  return lane < t.n ? __ldg(reinterpret_cast<const int2*>(t.states) + static_cast<size_t>(b) * t.n + lane)
                    : make_int2(0, 0);
}

// Agent cost of pushee q's move a at its cell pf (1 + the min over the agent
// contacts), from the agent's vertex iA: the contacts' vertex ids are
// loaded together, then their distances.
__device__ __forceinline__ float agent_cost(const Rgd& t, int iA, int doff0, int dstr0, int q, int a, int pf) {
  const int16_t* cv = t.cvidx_a + (static_cast<size_t>(a * t.n + q) * (t.H * t.W) + pf) * t.Ca;
  float best = kInf;
  for (int c0 = 0; c0 < t.Ca; c0 += 4) {
    int v[4], d[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c0 + j < t.Ca ? __ldg(cv + c0 + j) : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[j] = (v[j] >= 0 && iA >= 0) ? __ldg(t.Dflat + doff0 + static_cast<long long>(iA) * dstr0 + v[j]) : kDInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) best = fminf(best, dist_value(d[j]));
  }
  return 1.0f + best;
}

// One goal's depth-0 result, alike in the four lanes of its moves.
struct Goal0 {
  float pd;        // min over the moves of (feasible ? DG + A0 : INF)
  bool row;        // a goal object not at its goal
  bool finite_dg;  // some feasible move with a finite distance to goal
  bool any_move;   // some feasible move
};

// The depth-0 pass of goal pair p = 4 k + a (k < max_goals, the goal
// object o = k + 1), by a whole warp whose lane i holds object i's position
// `pos`.  Lanes with p >= 4 max_goals compute nothing but take part in the
// shuffles.  With `eok_out`, `gd_out` and `a0_out` non-null, the pair's
// feasibility, distance to goal and agent cost are stored there (index p;
// the agent cost at o * 4 + a).
// The wide path (kWide, state b) loads the two positions from device memory.
template <bool kWide = false>
__device__ __forceinline__ Goal0 depth0_pair(const Rgd& t, int p, int2 pos, int* eok_out, float* gd_out,
                                             float* a0_out, int b = 0) {
  const int HW = t.H * t.W;
  const bool active = p < 4 * t.max_goals;
  const int o = active ? (p >> 2) + 1 : 0, a = p & 3;
  int qx, qy, ax, ay;
  if constexpr (kWide) {
    const int2* row = reinterpret_cast<const int2*>(t.states) + static_cast<size_t>(b) * t.n;
    const int2 q = __ldg(row + o), ag = __ldg(row);
    qx = q.x, qy = q.y, ax = ag.x, ay = ag.y;
  } else {
    qx = __shfl_sync(kFull, pos.x, o), qy = __shfl_sync(kFull, pos.y, o);
    ax = __shfl_sync(kFull, pos.x, 0), ay = __shfl_sync(kFull, pos.y, 0);
  }
  Goal0 g{kInf, false, false, false};
  float val = kInf;
  bool eok = false;
  float gd = kInf;
  if (active) {
    const bool in_grid = qx >= 0 && qx < t.W && qy >= 0 && qy < t.H;
    const int pf = clampi(qy * t.W + qx, 0, HW - 1);
    // One wave: feasibility, distance to goal, the goal, the agent's vertex.
    eok = in_grid && __ldg(t.E + (static_cast<size_t>(a * t.n + o) * t.H + qy) * t.W + qx) != 0;
    gd = __ldg(t.DG + (static_cast<size_t>(o) * t.H + clampi(qy + move_dy(a), 0, t.H - 1)) * t.W +
               clampi(qx + move_dx(a), 0, t.W - 1));
    const bool has_goal = __ldg(t.goal_mask + o) != 0;
    const int gx = __ldg(t.goal_pos + 2 * o), gy = __ldg(t.goal_pos + 2 * o + 1);
    const int iA = __ldg(t.vidx + clampi(ay * t.W + ax, 0, HW - 1));
    const int doff0 = __ldg(t.doff), dstr0 = __ldg(t.dstride);
    const float a0 = agent_cost(t, iA, doff0, dstr0, o, a, pf);
    val = eok ? gd + a0 : kInf;
    g.row = has_goal && !(qx == gx && qy == gy);
    if (eok_out != nullptr) {
      eok_out[p] = eok;
      gd_out[p] = gd;
      a0_out[o * 4 + a] = a0;
    }
  }
  bool fdg = eok && gd < kFinite, any = eok;
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    val = fminf(val, __shfl_xor_sync(kFull, val, m));
    fdg |= __shfl_xor_sync(kFull, static_cast<int>(fdg), m) != 0;
    any |= __shfl_xor_sync(kFull, static_cast<int>(any), m) != 0;
  }
  g.pd = val;
  g.finite_dg = fdg;
  g.any_move = any;
  return g;
}

// A goal's cost once its last depth `last` is known, and the needs-deeper
// flag it raises (the plain version's fewest-tools rule).
__device__ __forceinline__ float goal_cost(const Rgd& t, float last, bool finite_dg, bool* deeper) {
  const bool found = last < kFinite;
  float cost = found ? last : (t.max_depth > t.n_real - 2 ? kInf : last);
  if (t.max_depth < t.n_real - 2 && finite_dg && cost >= kFinite) *deeper = true;
  return fminf(cost, kInf);
}

// Lane 0 writes the fill of state b if it is not valid; true then.
__device__ __forceinline__ bool dropped(const Rgd& t, int b, bool writer) {
  if (t.valid == nullptr || t.valid[b]) return false;
  if (writer) {
    t.total[b] = kInf;
    t.deeper[b] = 0;
  }
  return true;
}

// ------------------------------------------------------------ deep tables

// Word offsets of the deep kernel's shared arrays; the host sizes the
// launch with the same function.
struct Layout {
  int A0, M, TX, L, GD, EOK, PC, Q, IU, DOFF, DSTR, PD, words;
};

__host__ __device__ inline Layout layout(int n, int n_real, int goals, int max_depth) {
  const int dmax = deepest(max_depth, n_real);
  const int nr = n_real;
  Layout l;
  int w = 0;
  l.A0 = w; w += n * 4;
  l.M = w; w += n * 4 * nr * 4;
  l.TX = w; w += dmax >= 3 ? nr * nr * 4 : 0;
  const int levels = dmax >= 2 ? dmax : 0;  // T(., d) for d = 1 .. dmax - 1
  l.L = w; w += levels * nr * 4;
  l.GD = w; w += goals * 4;
  l.EOK = w; w += goals * 4;
  l.PC = w; w += 4;
  l.Q = w; w += n * 2;
  l.IU = w; w += nr * 4;
  l.DOFF = w; w += nr;
  l.DSTR = w; w += nr;
  l.PD = w; w += goals;
  l.words = w;
  return l;
}

struct Shared {
  float *A0, *M, *TX, *L, *GD, *PC, *PD;
  int *EOK, *Q, *IU, *DOFF, *DSTR;
  int nr;
  __device__ float* level(int d) const { return L + (d - 1) * nr * 4; }
};

// dist(u -> v) in object r's movement graph from its compact block.
__device__ __forceinline__ float dist(const Rgd& t, const Shared& s, int r, int iu, int iv) {
  if (iu < 0 || iv < 0) return kInf;
  return dist_value(__ldg(t.Dflat + s.DOFF[r] + static_cast<long long>(iu) * s.DSTR[r] + iv));
}

// min over pushers r in [1, nr) outside excl, and their moves a2, of
// M[q][a][r][a2] + inner[r][a2].
__device__ __forceinline__ float best_push(const Shared& s, int q, int a, unsigned excl, const float* inner) {
  const float* row = s.M + (q * 4 + a) * s.nr * 4;
  float best = kInf;
  for (int r = 1; r < s.nr; ++r) {
    if (excl >> r & 1u) continue;
#pragma unroll
    for (int a2 = 0; a2 < 4; ++a2) best = fminf(best, row[r * 4 + a2] + inner[r * 4 + a2]);
  }
  return best;
}

// M[q][a][r][0..3]: pusher r realizes pushee q's move a, for each of r's own
// first moves a2 (min over the contacts).
__device__ void push_row(const Rgd& t, const Shared& s, int q, int a, int r, float* out) {
  const int HW = t.H * t.W;
  float m[4] = {kInf, kInf, kInf, kInf};
  const int px = s.Q[2 * q], py = s.Q[2 * q + 1];
  const int rx = s.Q[2 * r], ry = s.Q[2 * r + 1];
  const size_t row = (static_cast<size_t>(a * t.n + r) * t.n + q) * t.C;
  for (int c = 0; c < t.C; ++c) {
    if (!t.cmask[row + c]) continue;
    const int cx = px + t.contacts[(row + c) * 2];
    const int cy = py + t.contacts[(row + c) * 2 + 1];
    if (!edge(t, a, r, cx, cy)) continue;
    const int iv = t.vidx[static_cast<size_t>(r) * HW + clampi(cy * t.W + cx, 0, HW - 1)];
    const bool same = cx == rx && cy == ry;
#pragma unroll
    for (int a2 = 0; a2 < 4; ++a2) {
      const int iu = s.IU[r * 4 + a2];
      if (iu == kNoNext) continue;
      const float base = (same && a2 == a) ? 0.0f : dist(t, s, r, iu, iv) + 1.0f;
      m[a2] = fminf(m[a2], base);
    }
  }
#pragma unroll
  for (int a2 = 0; a2 < 4; ++a2) out[a2] = m[a2];
}

// Fills the rows of M in `rows` not filled yet, one (q, a, r) triple a
// thread.  Called by the whole CTA; `done` is the same in every thread.
__device__ void ensure_m(const Rgd& t, const Shared& s, unsigned rows, unsigned* done) {
  const unsigned todo = rows & ~*done;
  if (!todo) return;
  *done |= todo;
  const int nr = s.nr;
  for (int i = threadIdx.x; i < t.n * 4 * nr; i += blockDim.x) {
    const int q = i / (4 * nr), a = (i / nr) & 3, r = i % nr;
    if ((todo >> q & 1u) && r >= 1 && r != q) push_row(t, s, q, a, r, s.M + ((q * 4 + a) * nr + r) * 4);
  }
  __syncthreads();
}

// T(S, 1) into level 1, entries of pushers outside S.
__device__ void table1(const Shared& s, unsigned S) {
  float* out = s.level(1);
  for (int i = threadIdx.x; i < s.nr * 4; i += blockDim.x) {
    const int q = i >> 2;
    if (q >= 1 && !(S >> q & 1u)) out[i] = best_push(s, q, i & 3, S | 1u << q, s.A0);
  }
  __syncthreads();
}

// T(S, 2) into level 2: every T(S u {q}, 1) at once into TX[q], then the min.
__device__ void table2(const Shared& s, unsigned S) {
  const int nr = s.nr;
  for (int i = threadIdx.x; i < nr * nr * 4; i += blockDim.x) {
    const int q = i / (nr * 4), r = (i >> 2) % nr;
    const unsigned skip = S | 1u << q | 1u << r;
    if (q >= 1 && r >= 1 && q != r && !(S >> q & 1u) && !(S >> r & 1u))
      s.TX[i] = best_push(s, r, i & 3, skip, s.A0);
  }
  __syncthreads();
  float* out = s.level(2);
  for (int i = threadIdx.x; i < nr * 4; i += blockDim.x) {
    const int q = i >> 2;
    if (q >= 1 && !(S >> q & 1u)) out[i] = best_push(s, q, i & 3, S | 1u << q, s.TX + q * nr * 4);
  }
  __syncthreads();
}

// T(S0, d0) into level d0 for d0 >= 3: a depth-first walk over the chain of
// pushers, one T(., 2) at its leaves.  Every thread walks the same path.
__device__ void table_deep(const Shared& s, unsigned S0, int d0) {
  unsigned skip[kMaxObjects];
  int next[kMaxObjects];
  int d = d0;
  skip[d] = S0;
  next[d] = 1;
  for (;;) {
    int q = next[d];
    while (q < s.nr && (skip[d] >> q & 1u)) ++q;
    if (q >= s.nr) {  // level d is complete: fold it into its parent's entry
      if (d == d0) return;
      ++d;
      const int pq = next[d];
      if (threadIdx.x < 4)
        s.level(d)[pq * 4 + threadIdx.x] = best_push(s, pq, threadIdx.x, skip[d] | 1u << pq, s.level(d - 1));
      __syncthreads();
      next[d] = pq + 1;
      continue;
    }
    next[d] = q;
    const unsigned sub = skip[d] | 1u << q;
    if (d == 3) {
      table2(s, sub);
      if (threadIdx.x < 4) s.level(3)[q * 4 + threadIdx.x] = best_push(s, q, threadIdx.x, sub, s.level(2));
      __syncthreads();
      next[d] = q + 1;
    } else {
      --d;
      skip[d] = sub;
      next[d] = 1;
    }
  }
}

// ------------------------------------------------------------ the kernels

// The deepest depth is 0 (or below): a warp a state, 8 states a CTA.
__global__ void __launch_bounds__(kStatesD0 * 32) rgd_kernel_d0(Rgd t) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kStatesD0 + (threadIdx.x >> 5);
  if (b >= t.B || dropped(t, b, lane == 0)) return;
  PW_STOP(1, b);  // phase: valid flag
  const int2 pos = load_position(t, b, lane);
  const int dmax = deepest(t.max_depth, t.n_real);
  float total = 0.0f;
  bool deeper = false;
  for (int p0 = 0; p0 < 4 * t.max_goals; p0 += 32) {  // 8 goals a pass
    const Goal0 g = depth0_pair(t, p0 + lane, pos, nullptr, nullptr, nullptr);
    PW_STOP(2, static_cast<int>(g.pd));  // phase: positions, gathers, distances, move min
    const float cost = g.row ? goal_cost(t, dmax >= 0 ? g.pd : kInf, g.finite_dg, &deeper) : 0.0f;
    for (int k = 0; k < 8 && p0 / 4 + k < t.max_goals; ++k) total = total + __shfl_sync(kFull, cost, 4 * k);
  }
  deeper = __any_sync(kFull, deeper);
  if (lane == 0) {
    t.total[b] = total;
    t.deeper[b] = deeper;
  }
}

// Depth 1 or more: a CTA a state, the depth-0 pass by warp 0.
__global__ void __launch_bounds__(kThreads) rgd_kernel_deep(Rgd t) {
  const int lane = threadIdx.x & 31;
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned need_deep;
  const Layout l = layout(t.n, t.n_real, t.max_goals, t.max_depth);
  Shared s;
  s.A0 = smem + l.A0;
  s.M = smem + l.M;
  s.TX = smem + l.TX;
  s.L = smem + l.L;
  s.GD = smem + l.GD;
  s.PC = smem + l.PC;
  s.PD = smem + l.PD;
  s.EOK = reinterpret_cast<int*>(smem + l.EOK);
  s.Q = reinterpret_cast<int*>(smem + l.Q);
  s.IU = reinterpret_cast<int*>(smem + l.IU);
  s.DOFF = reinterpret_cast<int*>(smem + l.DOFF);
  s.DSTR = reinterpret_cast<int*>(smem + l.DSTR);
  s.nr = t.n_real;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5;
  if (dropped(t, b, tid == 0)) return;
  PW_STOP(1, b);  // phase: valid flag
  const int HW = t.H * t.W;
  const int dmax = deepest(t.max_depth, t.n_real);
  const int nr = s.nr;
  const int2 pos = load_position(t, b, lane);
  if (warp == 0) {
    // The depth-0 pass; a state whose goals need no deeper depth is done.
    if (lane < t.n) {
      s.Q[2 * lane] = pos.x;
      s.Q[2 * lane + 1] = pos.y;
    }
    float total = 0.0f;
    bool deeper = false;
    unsigned rows = 0u;  // goals infinite at depth 0 that can move: they go deeper
    for (int p0 = 0; p0 < 4 * t.max_goals; p0 += 32) {
      const Goal0 g = depth0_pair(t, p0 + lane, pos, s.EOK, s.GD, s.A0);
      const bool lead = (lane & 3) == 0 && p0 + lane < 4 * t.max_goals;
      const float cost = g.row ? goal_cost(t, g.any_move ? g.pd : kInf, g.finite_dg, &deeper) : 0.0f;
      if (lead) s.PD[(p0 + lane) >> 2] = g.row ? g.pd : -1.0f;
      const unsigned deep = __ballot_sync(kFull, lead && g.row && g.pd >= kFinite && g.any_move);
      for (int k = 0; k < 8; ++k) {
        if (deep >> (4 * k) & 1u) rows |= 1u << (p0 / 4 + k + 1);
        if (p0 / 4 + k < t.max_goals) total = total + __shfl_sync(kFull, cost, 4 * k);
      }
    }
    deeper = __any_sync(kFull, deeper);
    if (lane == 0) {
      need_deep = rows;
      if (rows == 0u) {
        t.total[b] = total;
        t.deeper[b] = deeper;
      }
    }
  } else {
    // Meanwhile, what a deeper depth reads first: each pusher's own first
    // moves (IU), its distance block (DOFF, DSTR), and the A0 rows of the
    // pushers that are no goal objects.  Jobs go 32 a warp-wide step, so the
    // shuffles of the positions stay uniform.
    const int n_iu = nr * 4, n_a0 = 4 * (nr - 1 - t.max_goals > 0 ? nr - 1 - t.max_goals : 0);
    const int ax = __shfl_sync(kFull, pos.x, 0), ay = __shfl_sync(kFull, pos.y, 0);
    for (int base = (warp - 1) * 32; base < n_iu + n_a0 + nr; base += kThreads - 32) {
      const int job = base + lane;
      const int obj = job < n_iu ? job >> 2 : (job < n_iu + n_a0 ? t.max_goals + 1 + ((job - n_iu) >> 2) : 0);
      const int x = __shfl_sync(kFull, pos.x, obj & 31), y = __shfl_sync(kFull, pos.y, obj & 31);
      if (job < n_iu) {
        const int a2 = job & 3;
        const int next = __ldg(t.vidx + static_cast<size_t>(obj) * HW +
                               clampi((y + move_dy(a2)) * t.W + x + move_dx(a2), 0, HW - 1));
        s.IU[job] = edge(t, a2, obj, x, y) ? next : kNoNext;
      } else if (job < n_iu + n_a0) {
        const int iA = __ldg(t.vidx + clampi(ay * t.W + ax, 0, HW - 1));
        s.A0[obj * 4 + (job & 3)] =
            agent_cost(t, iA, __ldg(t.doff), __ldg(t.dstride), obj, job & 3, clampi(y * t.W + x, 0, HW - 1));
      } else if (job < n_iu + n_a0 + nr) {
        s.DOFF[job - n_iu - n_a0] = __ldg(t.doff + job - n_iu - n_a0);
        s.DSTR[job - n_iu - n_a0] = __ldg(t.dstride + job - n_iu - n_a0);
      }
    }
  }
  __syncthreads();
  const unsigned rows = need_deep;
  PW_STOP(2, static_cast<int>(rows));  // phase: depth-0 pass beside the deeper prefetch, barrier
  if (rows == 0u) return;

  // Deeper: every goal in order, from the depth-0 values, as the plain
  // version's fewest-tools loop.
  unsigned pushers = 0u, m_done = 0u;
  for (int r = 1; r < nr; ++r) pushers |= 1u << r;
  float total = 0.0f;
  bool deeper = false;
  for (int k = 0; k < t.max_goals; ++k) {
    const int o = k + 1;
    float cost = 0.0f;
    if (s.PD[k] >= 0.0f) {  // a goal object not at its goal
      const int* eok = s.EOK + k * 4;
      const float* gd = s.GD + k * 4;
      bool finite_dg = false, any_move = false;
      for (int a = 0; a < 4; ++a) {
        finite_dg |= eok[a] && gd[a] < kFinite;
        any_move |= eok[a] != 0;
      }
      float last = s.PD[k];
      bool found = last < kFinite;
      for (int D = 1; D <= dmax && !found; ++D) {
        float pd = kInf;
        if (any_move) {
          ensure_m(t, s, D == 1 ? 1u << o : (pushers | 1u << o), &m_done);
          PW_STOP(3, static_cast<int>(s.M[0]));  // phase: deep states: first rows of M
          const float* inner = s.A0;
          if (D == 2) {
            table1(s, 1u << o);
            inner = s.level(1);
          } else if (D == 3) {
            table2(s, 1u << o);
            inner = s.level(2);
          } else if (D >= 4) {
            table_deep(s, 1u << o, D - 1);
            inner = s.level(D - 1);
          }
          if (tid < 4 && eok[tid]) s.PC[tid] = best_push(s, o, tid, 1u << o, inner);
          __syncthreads();
          for (int a = 0; a < 4; ++a) pd = fminf(pd, eok[a] ? gd[a] + s.PC[a] : kInf);
          __syncthreads();  // PC is rewritten at the next depth
        }
        last = pd;
        found = pd < kFinite;
      }
      cost = goal_cost(t, last, finite_dg, &deeper);
    }
    total = total + cost;
  }
  if (tid == 0) {
    t.total[b] = total;
    t.deeper[b] = deeper;
  }
}

// ------------------------------------------------------------ wide path

// The deep kernel's arrays on the wide path: the one-word layout, then EX
// (n ints: the uniform part of the skip set) and STK (dmax + 1 ints: the
// walk's next pusher at each level).
struct WideShared : Shared {
  int *EX, *STK;
};

__host__ __device__ inline int wide_words(int n, int n_real, int goals, int max_depth) {
  return layout(n, n_real, goals, max_depth).words + n + deepest(max_depth, n_real) + 1;
}

// min over pushers r in [1, nr) outside EX, e1 and e2, and their moves a2,
// of M[q][a][r][a2] + inner[r][a2] (best_push with the skip set EX u {e1, e2}).
__device__ __forceinline__ float best_push_wide(const WideShared& s, int q, int a, int e1, int e2,
                                                const float* inner) {
  const float* row = s.M + (q * 4 + a) * s.nr * 4;
  float best = kInf;
  for (int r = 1; r < s.nr; ++r) {
    if (s.EX[r] || r == e1 || r == e2) continue;
#pragma unroll
    for (int a2 = 0; a2 < 4; ++a2) best = fminf(best, row[r * 4 + a2] + inner[r * 4 + a2]);
  }
  return best;
}

// Fills the rows of M of pushee o, or (all) of every pusher and o, unless
// every row is filled already.  Called by the whole CTA.
__device__ void ensure_m_wide(const Rgd& t, const WideShared& s, int o, bool all, bool* all_done) {
  if (*all_done) return;
  const int nr = s.nr;
  for (int i = threadIdx.x; i < t.n * 4 * nr; i += blockDim.x) {
    const int q = i / (4 * nr), a = (i / nr) & 3, r = i % nr;
    const bool row = q == o || (all && q >= 1 && q < nr);
    if (row && r >= 1 && r != q) push_row(t, s, q, a, r, s.M + ((q * 4 + a) * nr + r) * 4);
  }
  __syncthreads();
  *all_done = all;
}

// T(EX, 1) into level 1, entries of pushers outside EX.
__device__ void table1_wide(const WideShared& s) {
  float* out = s.level(1);
  for (int i = threadIdx.x; i < s.nr * 4; i += blockDim.x) {
    const int q = i >> 2;
    if (q >= 1 && !s.EX[q]) out[i] = best_push_wide(s, q, i & 3, q, -1, s.A0);
  }
  __syncthreads();
}

// T(EX, 2) into level 2: every T(EX u {q}, 1) at once into TX[q], then the min.
__device__ void table2_wide(const WideShared& s) {
  const int nr = s.nr;
  for (int i = threadIdx.x; i < nr * nr * 4; i += blockDim.x) {
    const int q = i / (nr * 4), r = (i >> 2) % nr;
    if (q >= 1 && r >= 1 && q != r && !s.EX[q] && !s.EX[r]) s.TX[i] = best_push_wide(s, r, i & 3, q, r, s.A0);
  }
  __syncthreads();
  float* out = s.level(2);
  for (int i = threadIdx.x; i < nr * 4; i += blockDim.x) {
    const int q = i >> 2;
    if (q >= 1 && !s.EX[q]) out[i] = best_push_wide(s, q, i & 3, q, -1, s.TX + q * nr * 4);
  }
  __syncthreads();
}

// T(EX, d0) into level d0 for d0 >= 3: table_deep's walk, the chain of
// pushers in EX and the next pusher of each level in STK.  Every thread
// walks the same path; thread 0 changes EX and STK between barriers.  EX
// is as on entry at the return.
__device__ void table_deep_wide(const WideShared& s, int d0) {
  const int nr = s.nr, tid = threadIdx.x;
  if (tid == 0) s.STK[d0] = 1;
  __syncthreads();
  int d = d0;
  for (;;) {
    int q = s.STK[d];
    while (q < nr && s.EX[q]) ++q;
    __syncthreads();  // every thread has read STK and EX
    if (q >= nr) {  // level d is complete: fold it into its parent's entry
      if (d == d0) return;
      ++d;
      const int pq = s.STK[d];
      if (tid < 4) s.level(d)[pq * 4 + tid] = best_push_wide(s, pq, tid, -1, -1, s.level(d - 1));
      __syncthreads();
      if (tid == 0) {
        s.EX[pq] = 0;
        s.STK[d] = pq + 1;
      }
      __syncthreads();
      continue;
    }
    if (tid == 0) s.EX[q] = 1;
    if (d == 3) {
      __syncthreads();
      table2_wide(s);
      if (tid < 4) s.level(3)[q * 4 + tid] = best_push_wide(s, q, tid, -1, -1, s.level(2));
      __syncthreads();
      if (tid == 0) {
        s.EX[q] = 0;
        s.STK[3] = q + 1;
      }
    } else {
      if (tid == 0) {
        s.STK[d] = q;
        s.STK[d - 1] = 1;
      }
      --d;
    }
    __syncthreads();
  }
}

// The deepest depth is 0 (or below), any n: a warp a state, 8 states a CTA.
__global__ void __launch_bounds__(kStatesD0 * 32) rgd_wide_kernel_d0(Rgd t) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kStatesD0 + (threadIdx.x >> 5);
  if (b >= t.B || dropped(t, b, lane == 0)) return;
  const int dmax = deepest(t.max_depth, t.n_real);
  float total = 0.0f;
  bool deeper = false;
  for (int p0 = 0; p0 < 4 * t.max_goals; p0 += 32) {  // 8 goals a pass
    const Goal0 g = depth0_pair<true>(t, p0 + lane, make_int2(0, 0), nullptr, nullptr, nullptr, b);
    const float cost = g.row ? goal_cost(t, dmax >= 0 ? g.pd : kInf, g.finite_dg, &deeper) : 0.0f;
    for (int k = 0; k < 8 && p0 / 4 + k < t.max_goals; ++k) total = total + __shfl_sync(kFull, cost, 4 * k);
  }
  deeper = __any_sync(kFull, deeper);
  if (lane == 0) {
    t.total[b] = total;
    t.deeper[b] = deeper;
  }
}

// Depth 1 or more, any n: a CTA a state, its arrays in shared memory
// (scratch null) or in its slice of the device scratch, the grid walking
// the states.
__global__ void __launch_bounds__(kThreads) rgd_wide_kernel_deep(Rgd t, float* scratch) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int need_deep;
  const Layout l = layout(t.n, t.n_real, t.max_goals, t.max_depth);
  float* base = scratch != nullptr
                    ? scratch + static_cast<size_t>(blockIdx.x) * wide_words(t.n, t.n_real, t.max_goals, t.max_depth)
                    : smem;
  WideShared s;
  s.A0 = base + l.A0;
  s.M = base + l.M;
  s.TX = base + l.TX;
  s.L = base + l.L;
  s.GD = base + l.GD;
  s.PC = base + l.PC;
  s.PD = base + l.PD;
  s.EOK = reinterpret_cast<int*>(base + l.EOK);
  s.Q = reinterpret_cast<int*>(base + l.Q);
  s.IU = reinterpret_cast<int*>(base + l.IU);
  s.DOFF = reinterpret_cast<int*>(base + l.DOFF);
  s.DSTR = reinterpret_cast<int*>(base + l.DSTR);
  s.EX = reinterpret_cast<int*>(base + l.words);
  s.STK = s.EX + t.n;
  s.nr = t.n_real;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HW = t.H * t.W;
  const int dmax = deepest(t.max_depth, t.n_real);
  const int nr = s.nr;
  for (int b = blockIdx.x; b < t.B; b += gridDim.x) {
    if (dropped(t, b, tid == 0)) continue;  // alike in every thread
    const int2* pos = reinterpret_cast<const int2*>(t.states) + static_cast<size_t>(b) * t.n;
    for (int i = tid; i < t.n; i += kThreads) {
      const int2 p = __ldg(pos + i);
      s.Q[2 * i] = p.x;
      s.Q[2 * i + 1] = p.y;
      s.EX[i] = 0;
    }
    if (warp == 0) {
      // The depth-0 pass; a state whose goals need no deeper depth is done.
      float total = 0.0f;
      bool deeper = false, deep = false;
      for (int p0 = 0; p0 < 4 * t.max_goals; p0 += 32) {
        const Goal0 g = depth0_pair<true>(t, p0 + lane, make_int2(0, 0), s.EOK, s.GD, s.A0, b);
        const bool lead = (lane & 3) == 0 && p0 + lane < 4 * t.max_goals;
        const float cost = g.row ? goal_cost(t, g.any_move ? g.pd : kInf, g.finite_dg, &deeper) : 0.0f;
        if (lead) s.PD[(p0 + lane) >> 2] = g.row ? g.pd : -1.0f;
        deep |= __any_sync(kFull, lead && g.row && g.pd >= kFinite && g.any_move);
        for (int k = 0; k < 8 && p0 / 4 + k < t.max_goals; ++k) total = total + __shfl_sync(kFull, cost, 4 * k);
      }
      deeper = __any_sync(kFull, deeper);
      if (lane == 0) {
        need_deep = deep;
        if (!deep) {
          t.total[b] = total;
          t.deeper[b] = deeper;
        }
      }
    } else {
      // Meanwhile, what a deeper depth reads first, as the one-word path.
      const int n_iu = nr * 4, n_a0 = 4 * (nr - 1 - t.max_goals > 0 ? nr - 1 - t.max_goals : 0);
      const int2 ag = __ldg(pos);
      const int iA = __ldg(t.vidx + clampi(ag.y * t.W + ag.x, 0, HW - 1));
      for (int job = tid - 32; job < n_iu + n_a0 + nr; job += kThreads - 32) {
        if (job < n_iu) {
          const int obj = job >> 2, a2 = job & 3;
          const int2 p = __ldg(pos + obj);
          const int next = __ldg(t.vidx + static_cast<size_t>(obj) * HW +
                                 clampi((p.y + move_dy(a2)) * t.W + p.x + move_dx(a2), 0, HW - 1));
          s.IU[job] = edge(t, a2, obj, p.x, p.y) ? next : kNoNext;
        } else if (job < n_iu + n_a0) {
          const int obj = t.max_goals + 1 + ((job - n_iu) >> 2);
          const int2 p = __ldg(pos + obj);
          s.A0[obj * 4 + (job & 3)] =
              agent_cost(t, iA, __ldg(t.doff), __ldg(t.dstride), obj, job & 3, clampi(p.y * t.W + p.x, 0, HW - 1));
        } else {
          s.DOFF[job - n_iu - n_a0] = __ldg(t.doff + job - n_iu - n_a0);
          s.DSTR[job - n_iu - n_a0] = __ldg(t.dstride + job - n_iu - n_a0);
        }
      }
    }
    __syncthreads();
    if (need_deep) {
      // Deeper: every goal in order, from the depth-0 values, as the plain
      // version's fewest-tools loop.
      bool all_m = false;
      float total = 0.0f;
      bool deeper = false;
      for (int k = 0; k < t.max_goals; ++k) {
        const int o = k + 1;
        float cost = 0.0f;
        if (s.PD[k] >= 0.0f) {  // a goal object not at its goal
          const int* eok = s.EOK + k * 4;
          const float* gd = s.GD + k * 4;
          bool finite_dg = false, any_move = false;
          for (int a = 0; a < 4; ++a) {
            finite_dg |= eok[a] && gd[a] < kFinite;
            any_move |= eok[a] != 0;
          }
          float last = s.PD[k];
          bool found = last < kFinite;
          if (tid == 0) s.EX[o] = 1;  // the goal's skip set {o}
          __syncthreads();
          for (int D = 1; D <= dmax && !found; ++D) {
            float pd = kInf;
            if (any_move) {
              ensure_m_wide(t, s, o, D >= 2, &all_m);
              const float* inner = s.A0;
              if (D == 2) {
                table1_wide(s);
                inner = s.level(1);
              } else if (D == 3) {
                table2_wide(s);
                inner = s.level(2);
              } else if (D >= 4) {
                table_deep_wide(s, D - 1);
                inner = s.level(D - 1);
              }
              if (tid < 4 && eok[tid]) s.PC[tid] = best_push_wide(s, o, tid, -1, -1, inner);
              __syncthreads();
              for (int a = 0; a < 4; ++a) pd = fminf(pd, eok[a] ? gd[a] + s.PC[a] : kInf);
              __syncthreads();  // PC is rewritten at the next depth
            }
            last = pd;
            found = pd < kFinite;
          }
          if (tid == 0) s.EX[o] = 0;
          __syncthreads();
          cost = goal_cost(t, last, finite_dg, &deeper);
        }
        total = total + cost;
      }
      if (tid == 0) {
        t.total[b] = total;
        t.deeper[b] = deeper;
      }
    }
    __syncthreads();  // the next state reuses the arrays and need_deep
  }
}

// The wide deep kernel's persistent grid in scratch mode: 2 CTAs an SM.
int wide_scratch_ctas(int B, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || sms < 1) sms = 132;
  return B < 2 * sms ? B : 2 * sms;
}

// Whether the wide deep kernel's layout of `words` floats fits the opt-in
// shared memory of `device`.
bool wide_fits_shared(long long words, int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return false;
  return words * 4 + 64 <= optin;  // 64: the static need_deep, with room
}

}  // namespace

// The largest number of objects (the states' second dimension) the one-word
// path (pw_rgd_heuristic) takes; pw_rgd_heuristic_wide takes any number.
extern "C" int pw_rgd_max_objects() { return kMaxObjects; }

// The floats of device scratch that pw_rgd_heuristic_wide needs for a batch
// of B states on `device`: 0 where it runs on shared memory alone (the
// deepest depth is 0, or the layout fits the opt-in shared memory).
extern "C" long long pw_rgd_wide_scratch_floats(int B, int n, int n_real, int max_goals, int max_depth,
                                                int device) {
  if (B <= 0 || deepest(max_depth, n_real) < 1) return 0;
  const long long words = wide_words(n, n_real, max_goals, max_depth);
  if (wide_fits_shared(words, device)) return 0;
  return words * wide_scratch_ctas(B, device);
}

extern "C" int pw_rgd_heuristic(const void* states, const void* E, const void* Dflat, const void* vidx,
                                const void* doff, const void* dstride, const void* DG, const void* contacts,
                                const void* contacts_mask, const void* cvidx_a, const void* goal_pos,
                                const void* goal_mask, const void* valid, void* total, void* deeper, int B,
                                int n, int n_real, int max_goals, int H, int W, int C, int Ca, int max_depth,
                                void* stream) {
  if (B <= 0 || n < 1 || n > kMaxObjects || n_real < 1 || n_real > n || max_goals < 0 || max_goals >= n ||
      max_depth < 0 || C < 1 || Ca < 1 || reinterpret_cast<uintptr_t>(states) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Rgd t{static_cast<const int*>(states), static_cast<const uint8_t*>(E), static_cast<const int*>(Dflat),
        static_cast<const int*>(vidx), static_cast<const int*>(doff), static_cast<const int*>(dstride),
        static_cast<const float*>(DG), static_cast<const int16_t*>(contacts),
        static_cast<const uint8_t*>(contacts_mask), static_cast<const int16_t*>(cvidx_a),
        static_cast<const int*>(goal_pos), static_cast<const uint8_t*>(goal_mask),
        static_cast<const uint8_t*>(valid), static_cast<float*>(total),
        static_cast<uint8_t*>(deeper), B, n, n_real, max_goals, H, W, C, Ca, max_depth};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (deepest(max_depth, n_real) < 1) {
    rgd_kernel_d0<<<(B + kStatesD0 - 1) / kStatesD0, kStatesD0 * 32, 0, st>>>(t);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(layout(n, n_real, max_goals, max_depth).words) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(rgd_kernel_deep, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rgd_kernel_deep<<<B, kThreads, smem, st>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// pw_rgd_heuristic's wide path, for any n (the wrapper takes it above
// pw_rgd_max_objects()): the same arguments, and `scratch`, null or
// pw_rgd_wide_scratch_floats() floats of device memory (16-byte aligned).
extern "C" int pw_rgd_heuristic_wide(const void* states, const void* E, const void* Dflat, const void* vidx,
                                     const void* doff, const void* dstride, const void* DG, const void* contacts,
                                     const void* contacts_mask, const void* cvidx_a, const void* goal_pos,
                                     const void* goal_mask, const void* valid, void* total, void* deeper, int B,
                                     int n, int n_real, int max_goals, int H, int W, int C, int Ca, int max_depth,
                                     void* scratch, void* stream) {
  if (B <= 0 || n < 1 || n_real < 1 || n_real > n || max_goals < 0 || max_goals >= n || max_depth < 0 || C < 1 ||
      Ca < 1 || reinterpret_cast<uintptr_t>(states) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Rgd t{static_cast<const int*>(states), static_cast<const uint8_t*>(E), static_cast<const int*>(Dflat),
        static_cast<const int*>(vidx), static_cast<const int*>(doff), static_cast<const int*>(dstride),
        static_cast<const float*>(DG), static_cast<const int16_t*>(contacts),
        static_cast<const uint8_t*>(contacts_mask), static_cast<const int16_t*>(cvidx_a),
        static_cast<const int*>(goal_pos), static_cast<const uint8_t*>(goal_mask),
        static_cast<const uint8_t*>(valid), static_cast<float*>(total),
        static_cast<uint8_t*>(deeper), B, n, n_real, max_goals, H, W, C, Ca, max_depth};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (deepest(max_depth, n_real) < 1) {
    rgd_wide_kernel_d0<<<(B + kStatesD0 - 1) / kStatesD0, kStatesD0 * 32, 0, st>>>(t);
    return static_cast<int>(cudaGetLastError());
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long words = wide_words(n, n_real, max_goals, max_depth);
  if (wide_fits_shared(words, device)) {
    const size_t smem = static_cast<size_t>(words) * 4;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(rgd_wide_kernel_deep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    rgd_wide_kernel_deep<<<B, kThreads, smem, st>>>(t, nullptr);
  } else {
    if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    rgd_wide_kernel_deep<<<wide_scratch_ctas(B, device), kThreads, 0, st>>>(t, static_cast<float*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}
