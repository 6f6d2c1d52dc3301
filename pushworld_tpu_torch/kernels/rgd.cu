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
// (chains of dependent gathers) is what the design works on.
//
// Design.  One CTA of kThreads threads a state: no state waits on another,
// and the recursion's memo lives in the CTA's shared memory, as in the
// reference's per-state PushingCostCache (recursive_graph_distance.cc
// 176-252).  With q the pushee, a its move, r a pusher and a2 the pusher's
// own first move:
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
// r != o, a2 of M[o][a][r][a2] + T({o}, D - 1)[r][a2].  Rows of A0 and M are
// filled on first use (a bitmask says which), so a state whose goals are
// finite at depth 0 touches neither.  T(S, 1) is one parallel pass, T(S, 2)
// two (every T(S u {q}, 1) at once, then the min), deeper tables a loop over
// q on top of T(., 2).  Lanes go over table entries with a serial min inside;
// the gathers of a row of M go one (q, a, r) triple a thread, its contacts
// in a loop.  Goals run in order, depths from 0 up, and a goal stops at its
// first finite depth (fewest tools); the sum over goals is made by one
// thread in goal order.
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
// sel_valid lanes), a CTA whose state is not valid writes the fill
// (total INF, deeper false) and returns before it reads the state: the
// search drops those lanes' values, and at a closed gate their states are
// never written.  The plain version applies the same fill.
//
// Limits: n <= kMaxObjects (skip sets are 32-bit masks; M is 64 KB at 32
// objects), any max_depth (depths above 3 run the loop of T(., 2) tables).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e9f;
constexpr float kFinite = 1e8f;
constexpr int kDInf = 65535;     // the packed distance blocks' INF
constexpr int kNoNext = -2;      // IU entry: the pusher's own move is infeasible
constexpr int kMaxObjects = 32;
constexpr int kThreads = 128;

struct Rgd {
  const int* states;         // (B, n, 2) int32 (x, y)
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
  int n, n_real, max_goals, H, W, C, Ca, max_depth;
};

// Word offsets of the CTA's shared arrays; the host sizes the launch with
// the same function.
struct Layout {
  int A0, M, TX, L, GD, EOK, PC, Q, IU, words;
};

__host__ __device__ inline int deepest(int max_depth, int n_real) {
  return max_depth < n_real - 2 ? max_depth : n_real - 2;
}

__host__ __device__ inline Layout layout(int n, int n_real, int goals, int max_depth) {
  const int dmax = deepest(max_depth, n_real);
  const int nr = n_real;
  Layout l;
  int w = 0;
  l.A0 = w; w += n * 4;
  l.M = w; w += dmax >= 1 ? n * 4 * nr * 4 : 0;
  l.TX = w; w += dmax >= 3 ? nr * nr * 4 : 0;
  const int levels = dmax >= 2 ? dmax : 0;  // T(., d) for d = 1 .. dmax - 1
  l.L = w; w += levels * nr * 4;
  l.GD = w; w += goals * 4;
  l.EOK = w; w += goals * 4;
  l.PC = w; w += 4;
  l.Q = w; w += n * 2;
  l.IU = w; w += dmax >= 1 ? nr * 4 : 0;
  l.words = w;
  return l;
}

struct Shared {
  float *A0, *M, *TX, *L, *GD, *PC;
  int *EOK, *Q, *IU;
  int nr;
  __device__ float* level(int d) const { return L + (d - 1) * nr * 4; }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
__device__ __forceinline__ int move_dx(int a) { return a < 2 ? (a & 1) * 2 - 1 : 0; }
__device__ __forceinline__ int move_dy(int a) { return a < 2 ? 0 : (a & 1) * 2 - 1; }

// E[a, o, y, x], false outside the grid.
__device__ __forceinline__ bool edge(const Rgd& t, int a, int o, int x, int y) {
  if (x < 0 || x >= t.W || y < 0 || y >= t.H) return false;
  return t.E[(static_cast<size_t>(a * t.n + o) * t.H + y) * t.W + x] != 0;
}

// dist(u -> v) in object r's movement graph from its compact block.
__device__ __forceinline__ float dist(const Rgd& t, int r, int iu, int iv) {
  if (iu < 0 || iv < 0) return kInf;
  const int d = t.Dflat[static_cast<long long>(t.doff[r]) + static_cast<long long>(iu) * t.dstride[r] + iv];
  return d != kDInf ? static_cast<float>(d) : kInf;
}

// Depth-0 cost of object q's move a: the agent pushes it (+1 for the push).
__device__ float agent_cost(const Rgd& t, const int* Q, int q, int a) {
  const int HW = t.H * t.W;
  const int iA = t.vidx[clampi(Q[1] * t.W + Q[0], 0, HW - 1)];
  const int pf = clampi(Q[2 * q + 1] * t.W + Q[2 * q], 0, HW - 1);
  const int16_t* cv = t.cvidx_a + (static_cast<size_t>(a * t.n + q) * HW + pf) * t.Ca;
  float best = kInf;
  for (int c = 0; c < t.Ca; ++c) best = fminf(best, dist(t, 0, iA, cv[c]));
  return 1.0f + best;
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
      const float base = (same && a2 == a) ? 0.0f : dist(t, r, iu, iv) + 1.0f;
      m[a2] = fminf(m[a2], base);
    }
  }
#pragma unroll
  for (int a2 = 0; a2 < 4; ++a2) out[a2] = m[a2];
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

// Fills the rows of A0 in `rows` not filled yet.  Called by the whole CTA.
__device__ void ensure_a0(const Rgd& t, const Shared& s, unsigned rows, unsigned* done) {
  const unsigned todo = rows & ~*done;
  if (!todo) return;
  for (int i = threadIdx.x; i < t.n * 4; i += blockDim.x)
    if (todo >> (i >> 2) & 1u) s.A0[i] = agent_cost(t, s.Q, i >> 2, i & 3);
  __syncthreads();
  if (threadIdx.x == 0) *done |= todo;
  __syncthreads();
}

// Fills the rows of M in `rows` not filled yet.  Called by the whole CTA.
__device__ void ensure_m(const Rgd& t, const Shared& s, unsigned rows, unsigned* done) {
  const unsigned todo = rows & ~*done;
  if (!todo) return;
  const int nr = s.nr;
  for (int i = threadIdx.x; i < t.n * 4 * nr; i += blockDim.x) {
    const int q = i / (4 * nr), a = (i / nr) & 3, r = i % nr;
    if ((todo >> q & 1u) && r >= 1 && r != q) push_row(t, s, q, a, r, s.M + ((q * 4 + a) * nr + r) * 4);
  }
  __syncthreads();
  if (threadIdx.x == 0) *done |= todo;
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

__global__ void __launch_bounds__(kThreads) rgd_kernel(Rgd t) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned a0_done, m_done;
  const Layout l = layout(t.n, t.n_real, t.max_goals, t.max_depth);
  Shared s;
  s.A0 = smem + l.A0;
  s.M = smem + l.M;
  s.TX = smem + l.TX;
  s.L = smem + l.L;
  s.GD = smem + l.GD;
  s.PC = smem + l.PC;
  s.EOK = reinterpret_cast<int*>(smem + l.EOK);
  s.Q = reinterpret_cast<int*>(smem + l.Q);
  s.IU = reinterpret_cast<int*>(smem + l.IU);
  s.nr = t.n_real;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (t.valid != nullptr && !t.valid[b]) {
    if (tid == 0) {
      t.total[b] = kInf;
      t.deeper[b] = 0;
    }
    return;
  }
  const int HW = t.H * t.W;
  const int dmax = deepest(t.max_depth, t.n_real);

  for (int i = tid; i < t.n * 2; i += blockDim.x) s.Q[i] = t.states[static_cast<size_t>(b) * t.n * 2 + i];
  if (tid == 0) a0_done = m_done = 0u;
  __syncthreads();

  // Each goal's four first moves: feasible?  distance to goal after it.
  for (int i = tid; i < t.max_goals * 4; i += blockDim.x) {
    const int o = (i >> 2) + 1, a = i & 3;
    const int x = s.Q[2 * o] + move_dx(a), y = s.Q[2 * o + 1] + move_dy(a);
    s.EOK[i] = edge(t, a, o, s.Q[2 * o], s.Q[2 * o + 1]);
    s.GD[i] = t.DG[(static_cast<size_t>(o) * t.H + clampi(y, 0, t.H - 1)) * t.W + clampi(x, 0, t.W - 1)];
  }
  // Each pusher's own first moves: feasible?  the cell it leads to.
  if (dmax >= 1)
    for (int i = tid; i < s.nr * 4; i += blockDim.x) {
      const int r = i >> 2, a2 = i & 3;
      const int x = s.Q[2 * r], y = s.Q[2 * r + 1];
      s.IU[i] = edge(t, a2, r, x, y)
                    ? t.vidx[static_cast<size_t>(r) * HW + clampi((y + move_dy(a2)) * t.W + x + move_dx(a2), 0, HW - 1)]
                    : kNoNext;
    }
  unsigned goal_rows = 0u, pushers = 0u;
  for (int k = 0; k < t.max_goals; ++k) {
    const int o = k + 1;
    if (t.goal_mask[o] && !(s.Q[2 * o] == t.goal_pos[2 * o] && s.Q[2 * o + 1] == t.goal_pos[2 * o + 1]))
      goal_rows |= 1u << o;
  }
  for (int r = 1; r < s.nr; ++r) pushers |= 1u << r;
  __syncthreads();
  ensure_a0(t, s, goal_rows, &a0_done);

  float total = 0.0f;
  bool deeper = false;
  for (int k = 0; k < t.max_goals; ++k) {
    const int o = k + 1;
    float cost = 0.0f;
    if (goal_rows >> o & 1u) {  // a goal object not at its goal
      const int* eok = s.EOK + k * 4;
      const float* gd = s.GD + k * 4;
      bool finite_dg = false, any_move = false;
      for (int a = 0; a < 4; ++a) {
        finite_dg |= eok[a] && gd[a] < kFinite;
        any_move |= eok[a] != 0;
      }
      float last = kInf;
      bool found = false;
      for (int D = 0; D <= dmax && !found; ++D) {
        float pd = kInf;
        if (D == 0) {
          for (int a = 0; a < 4; ++a) pd = fminf(pd, eok[a] ? gd[a] + s.A0[o * 4 + a] : kInf);
        } else if (any_move) {
          ensure_a0(t, s, pushers, &a0_done);
          ensure_m(t, s, D == 1 ? 1u << o : (pushers | 1u << o), &m_done);
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
      // Fewest tools: the first finite depth; else the deepest one, which
      // is INF when it lies above n_real - 2.
      cost = found ? last : (t.max_depth > t.n_real - 2 ? kInf : last);
      if (t.max_depth < t.n_real - 2 && finite_dg && cost >= kFinite) deeper = true;
      cost = fminf(cost, kInf);
    }
    total = total + cost;
  }
  if (tid == 0) {
    t.total[b] = total;
    t.deeper[b] = deeper;
  }
}

}  // namespace

// The largest number of objects (the states' second dimension) the kernel takes.
extern "C" int pw_rgd_max_objects() { return kMaxObjects; }

extern "C" int pw_rgd_heuristic(const void* states, const void* E, const void* Dflat, const void* vidx,
                                const void* doff, const void* dstride, const void* DG, const void* contacts,
                                const void* contacts_mask, const void* cvidx_a, const void* goal_pos,
                                const void* goal_mask, const void* valid, void* total, void* deeper, int B,
                                int n, int n_real, int max_goals, int H, int W, int C, int Ca, int max_depth,
                                void* stream) {
  if (B <= 0 || n < 1 || n > kMaxObjects || n_real < 1 || n_real > n || max_goals < 0 || max_goals >= n ||
      max_depth < 0 || C < 1 || Ca < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Rgd t{static_cast<const int*>(states), static_cast<const uint8_t*>(E), static_cast<const int*>(Dflat),
        static_cast<const int*>(vidx), static_cast<const int*>(doff), static_cast<const int*>(dstride),
        static_cast<const float*>(DG), static_cast<const int16_t*>(contacts),
        static_cast<const uint8_t*>(contacts_mask), static_cast<const int16_t*>(cvidx_a),
        static_cast<const int*>(goal_pos), static_cast<const uint8_t*>(goal_mask),
        static_cast<const uint8_t*>(valid), static_cast<float*>(total),
        static_cast<uint8_t*>(deeper), n, n_real, max_goals, H, W, C, Ca, max_depth};
  const size_t smem = static_cast<size_t>(layout(n, n_real, max_goals, max_depth).words) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(rgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rgd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
