// The batched one-hot observation: (B, H, W, 6) float32 semantic channels
// [wall, agent-wall, agent, goal object, movable, goal] of a state batch.
//
// Replaces XLA code of the JAX package, not a TPU kernel:
// pushworld_tpu/ops/render.py render_cells_onehot_batched (line 128), which
// computes each dynamic class's occupancy as one-hot bf16 matrix products
// (a form for the TPU's matrix unit).  The plain PyTorch form
// (pushworld_tpu_torch/ops/render.py render_cells_onehot_batched_reference)
// copies the base grid's channels into the output, then scatters every
// movable cell's five dynamic channels with index_put_: a dozen kernels.
//
// What it computes, per state b and cell (x, y), as the plain version does:
//   top      the highest-indexed movable k with a cell of k at (x, y) (cells
//            that draw nothing: padding of the cell lists and cells outside
//            the grid, are dropped), or none;
//   channel 0      base[y, x] == 1 (a wall is never covered);
//   channel c > 0  class == c + 1, where class is obj_class[top] if some
//                  movable covers the cell, else base[y, x].
// For valid states (no two movables on a cell) this is the per-state
// renderer's one-hot; where movables overlap, the one of highest index
// wins, so the result does not depend on the order the threads draw in.
//
// Bound.  The output: 4 * 6 * H * W bytes a state, 249.5 MB at B = 4096 on
// 47 x 54, 0.0745 ms at 3.35 TB/s; the inputs are 8N bytes a state and the
// tables once.  Bytes bound: every output byte is written once.
//
// Design.  One CTA a state.  It stages the state's cell grid in shared
// memory, one int a cell: the base class, then each movable cell of the
// state (a thread each) an atomicMax of (k + 1) << 8 over it, then each
// cell rewritten as its six channel bits.  Then the CTA writes the state's
// 6 H W floats as one contiguous run: 16-byte stores (a warp writes 512
// contiguous bytes), each float's cell and channel from its index, and
// scalar stores at an unaligned head and tail.  The grid must fit the
// shared memory (4 bytes a cell: 58,112 cells); the wrapper raises above.
//
// The framed variant (render_onehot_framed_kernel, PushWorld's standard
// padding): states of a stacked pool of puzzles, each rendered into one
// frame of H x W cells, centred at its puzzle's offset there, every other
// cell all-zero; each state's base, movables and offset are read by its
// puzzle index.  Bound: the same 24 H W output bytes a state, 8N + 4 input
// bytes (its cells and puzzle index), the tables once.
//
// Where one CTA a state (the design above) lost its time: 91.6 us a launch
// at B = 4096 on 47 x 54 on an H100, against a bytes bound of 74.7 us and
// 76.3 us for a fill of the same bytes.  Its stages took 20 us alone, mostly
// hidden.  Its stores, 16-byte aligned but starting 112 bytes into a
// 128-byte line (a frame is 60,912 bytes), wrote a quarter of the lines in
// two pieces: such stores alone take 90 us, 78 us where each frame starts
// on a line.  And every state's base came from HBM between the writes.
// This design:
//   - Persistent CTAs, kFramedCtasPerSm an SM (fewer where the output holds
//     fewer rounds of slabs).  The launch's output is one run of B 6 H W
//     floats, L lines of 128 bytes; CTA c of G writes floats [32 (L c / G),
//     32 (L (c + 1) / G)) (the last clipped to the run's end): every CTA the
//     same bytes to one line, every share starting and ending on a line but
//     the run's last, and cutting frames where it falls.  ops/render.py
//     framed_ctas and framed_shares are the same formulas, and
//     pw_render_framed_ctas returns the count a launch takes.
//   - Every line is written whole by a bulk asynchronous copy (cp.async.bulk,
//     TMA) from shared memory, under the L2 policy evict-first, so that the
//     streamed frames leave the tables and the states in L2; the threads do
//     not issue the store stream.  Only the run's last line, where it is not
//     whole, is plain stores.
//   - A CTA walks the states its share touches, loading the next state's
//     cells into registers (its puzzle and geometry a state earlier still)
//     while it writes the current one.  At a state's start one thread copies
//     its pad rows, above and below the puzzle's rows (three quarters of a
//     47 x 54 frame at level 0), from a 32 KB block of zeros.  Then the CTA
//     stages the puzzle's rows alone, as the single-puzzle kernel stages a
//     grid (base, the movables' atomicMax, channel bits); a cell outside the
//     puzzle's rectangle is pad, all-zero, whatever the base table holds
//     there.  Each warp fills 4 KB slabs of those rows as float4 values (from
//     two cells' channel bits, in integer operations), its lane 0 copies
//     each out, and it refills a slab of its ring of kRing only after
//     cp.async.bulk.wait_group.read says that the slab's last copy has read
//     it: no barrier between warps until the next state.
//   - The line that a frame boundary cuts is assembled by warp 0 in a carry
//     line in shared memory, from the frame's tail and the next frame's head,
//     and copied once whole by its own thread.
//   - A frame too large for the buffers beside its grid (4 H W bytes plus
//     kBufferFloats floats over kMaxSharedBytes) writes its lines with plain
//     16-byte stores from registers, on the same split.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 6;
constexpr int kMaxSharedBytes = 232448;  // what a CTA may have on Hopper

struct Render {
  const int2* states;         // (B, n) cells
  const int8_t* base;         // (H, W) base classes
  const int16_t* cells;       // (n, C, 2) cell offsets (x, y)
  const uint8_t* cell_mask;   // (n, C)
  const int8_t* obj_class;    // (n,)
  float* out;                 // (B, H, W, 6)
  int n, C, H, W;
};

// Float f of a state's run (f < 6 H W, an int): channel f % 6 of cell f / 6.
__device__ __forceinline__ float channel(const int* grid, int f) {
  const int cell = f / kChannels, c = f - cell * kChannels;
  return static_cast<float>((grid[cell] >> c) & 1);
}

// Rewrites each staged cell of the grid (``(top + 1) << 8 | base``: the
// highest-indexed movable on it, 0 for none, and its base class) as its
// six channel bits.
__device__ __forceinline__ void to_channel_bits(int* grid, int HW, const int8_t* obj_class, int t, int T) {
  for (int c = t; c < HW; c += T) {
    const int v = grid[c], top = v >> 8, base = v & 0xFF;
    const int cls = top ? obj_class[top - 1] : base;
    grid[c] = (base == 1 ? 1 : 0) | (cls >= 2 && cls <= kChannels ? 1 << (cls - 1) : 0);
  }
}

// State b's run of 6 HW floats [b S, (b + 1) S) from its grid of channel
// bits: an unaligned head, 16-byte stores, an unaligned tail.
__device__ __forceinline__ void store_run(const int* grid, float* out, long long b, int HW, int t, int T) {
  const long long S = static_cast<long long>(HW) * kChannels, start = b * S, end = start + S;
  long long a0 = (start + 3) & ~3ll, a1 = end & ~3ll;
  if (a0 > end) a0 = end;
  if (a1 < a0) a1 = a0;
  for (long long g = start + t; g < a0; g += T) out[g] = channel(grid, static_cast<int>(g - start));
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long q = a0 / 4 + t; q < a1 / 4; q += T) {
    const int f = static_cast<int>(4 * q - start);
    out4[q] = make_float4(channel(grid, f), channel(grid, f + 1), channel(grid, f + 2), channel(grid, f + 3));
  }
  for (long long g = a1 + t; g < end; g += T) out[g] = channel(grid, static_cast<int>(g - start));
}

__global__ void render_onehot_kernel(Render r) {
  extern __shared__ int grid[];  // a cell: base class, then (top + 1) << 8 | base, then channel bits
  const int t = threadIdx.x, T = blockDim.x, HW = r.H * r.W;
  const long long b = blockIdx.x;
  for (int c = t; c < HW; c += T) grid[c] = static_cast<uint8_t>(r.base[c]);
  __syncthreads();
  const int2* st = r.states + b * r.n;
  for (int e = t; e < r.n * r.C; e += T) {
    if (!r.cell_mask[e]) continue;
    const int k = e / r.C;
    const int2 p = st[k];
    const long long x = static_cast<long long>(p.x) + r.cells[2 * e];
    const long long y = static_cast<long long>(p.y) + r.cells[2 * e + 1];
    if (x < 0 || x >= r.W || y < 0 || y >= r.H) continue;
    const int at = static_cast<int>(y) * r.W + static_cast<int>(x);
    atomicMax(grid + at, ((k + 1) << 8) | (grid[at] & 0xFF));  // the low byte (the base) never changes
  }
  __syncthreads();
  to_channel_bits(grid, HW, r.obj_class, t, T);
  __syncthreads();
  store_run(grid, r.out, b, HW, t, T);
}

// The framed render over stacked puzzles: state b belongs to puzzle
// puzzle_idx[b], whose base classes sit at its centre offset in one frame
// of H x W cells (pad cells class 0: every channel 0), and whose movables'
// cells, classes and own height and width are indexed by puzzle.
struct Framed {
  const int2* states;         // (B, n) cells, in the puzzle's own grid
  const int32_t* puzzle_idx;  // (B,) each state's puzzle, in [0, P)
  const int8_t* base;         // (P, H, W) base classes, placed in the frame
  const int16_t* cells;       // (P, n, C, 2) cell offsets (x, y)
  const uint8_t* cell_mask;   // (P, n, C)
  const int8_t* obj_class;    // (P, n)
  const int4* geom;           // (P,) top, left, height, width of the puzzle in the frame
  float* out;                 // (B, H, W, 6)
  int n, C, H, W;
};

// Phase marks for scripts/profile_kernel_phases.py: a build with
// -DPW_STOP_AT=k skips, for every state, the work after mark k (no-ops in
// the normal build).
#ifndef PW_NEXT
#define PW_NEXT(k, v)
#endif

constexpr int kFramedThreads = 256;
constexpr int kWarps = kFramedThreads / 32;
constexpr int kFramedCtasPerSm = 2;
constexpr int kSlabFloats = 1024;  // a warp's slab: 4 KB, 8 quads a lane
constexpr int kRing = 2;           // slabs a warp
constexpr int kRingFloats = kWarps * kRing * kSlabFloats;
constexpr int kZeroFloats = 8192;  // the zeros that pad rows are copied from: 32 KB
constexpr int kZeroThread = 1;     // the thread that copies them (issues no slab)
constexpr int kLine = 32;          // floats of a 128-byte line: every copy starts and ends on one
constexpr int kCarryThread = 2;    // the thread that copies the lines frame boundaries cut
constexpr int kBufferFloats = kRingFloats + kZeroFloats + 2 * kLine;  // before the grid: ring, zeros, carry
constexpr int kBaseRegs = 4;       // base bytes a thread prefetches: all of a puzzle's rows of up to 4 T cells

// CTAs of a framed launch of B states on H x W frames: kFramedCtasPerSm an
// SM, at most one a round of slabs (one a warp) of output (ops/render.py
// framed_ctas).
long long framed_ctas(long long B, int H, int W, int sms) {
  const long long lines = (B * H * W * kChannels + kLine - 1) / kLine, round = kWarps * kSlabFloats / kLine;
  const long long rounds = (lines + round - 1) / round, most = static_cast<long long>(kFramedCtasPerSm) * sms;
  return rounds < 1 ? 1 : (rounds < most ? rounds : most);
}

// Whether a frame's grid and the buffers (the warps' rings, the zeros, two
// carry lines) fit a CTA's shared memory.
bool framed_bulk(int H, int W) { return 4ll * (H * W + kBufferFloats) <= kMaxSharedBytes; }

// 1.0f where bit 0 of v is set, else 0.0f, in integer operations (a
// conversion runs at a quarter of their rate).
__device__ __forceinline__ float one_if(int v) { return __int_as_float(-(v & 1) & 0x3F800000); }

// The channel bits of frame cell c: the grid's where c lies in the rows
// [in0, in1) that hold the puzzle, else 0 (a pad row, never staged).
__device__ __forceinline__ int bits_of(const int* grid, int c, int in0, int in1) {
  return static_cast<unsigned>(c - in0) < static_cast<unsigned>(in1 - in0) ? grid[c] : 0;
}

// Float f of a frame (f < 6 H W): channel f % 6 of cell f / 6.
__device__ __forceinline__ float single(const int* grid, int f, int in0, int in1) {
  const int cell = f / kChannels;
  return one_if(bits_of(grid, cell, in0, in1) >> (f - cell * kChannels));
}

// Four floats of a frame from float f on (f + 3 < 6 H W): channel (f + i) % 6
// of cell (f + i) / 6, from the channel bits of cell f / 6 and the next.
__device__ __forceinline__ float4 quad(const int* grid, int f, int in0, int in1) {
  const int cell = f / kChannels, c = f - cell * kChannels;
  const int bits = (bits_of(grid, cell, in0, in1) | bits_of(grid, cell + 1, in0, in1) << kChannels) >> c;
  return make_float4(one_if(bits), one_if(bits >> 1), one_if(bits >> 2), one_if(bits >> 3));
}

// L2's policy for the output: evict first, so that the streamed frames do
// not push the render tables and the states out of L2.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// Writes the bytes [dst, dst + bytes) from shared memory src as one bulk
// asynchronous copy (both 16-byte aligned, bytes a multiple of 16) under L2
// policy, and commits it as a bulk group of its own.
// (A build with -DPW_NO_BULK copies nothing: the threads' work alone, for
// scripts/profile_kernel_phases.py.)
__device__ __forceinline__ void bulk_store(float* dst, const void* src, int bytes, uint64_t policy) {
#ifndef PW_NO_BULK
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(static_cast<unsigned>(__cvta_generic_to_shared(src))),
               "r"(bytes), "l"(policy)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// The bytes of one copy from the zeros of a run of n floats still to write.
__device__ __forceinline__ int zero_bytes(long long n) {
  return 4 * static_cast<int>(n < kZeroFloats ? n : kZeroFloats);
}

// A state's inputs, loaded into registers while the CTA writes the state
// before it: the first kBaseRegs T cells of the puzzle's rows (a base cell
// inside the puzzle's columns, else 0) and a thread's first movable cell.
// Its puzzle p and geometry g were loaded a state earlier still.
struct Prefetch {
  int base[kBaseRegs];
  int2 q = {0, 0};
  int dx = 0, dy = 0, on = 0;
};

__device__ __forceinline__ void prefetch(Prefetch& x, const Framed& r, long long b, long long p, int4 g, int t) {
  const int W = r.W, nC = r.n * r.C;
  const long long e = p * nC + t;
  x.on = t < nC ? r.cell_mask[e] : 0;
  if (x.on) {
    x.q = r.states[b * r.n + t / r.C];
    x.dx = r.cells[2 * e];
    x.dy = r.cells[2 * e + 1];
  }
  const int8_t* rows = r.base + (p * r.H + g.x) * W;
#pragma unroll
  for (int i = 0; i < kBaseRegs; ++i) {
    const int c = t + i * kFramedThreads, col = c % W;
    x.base[i] = c < g.z * W && col >= g.y && col < g.y + g.w ? static_cast<uint8_t>(rows[c]) : 0;
  }
}

// Where movable cell (q + (dx, dy)) of puzzle geometry g draws in the frame
// (-1 outside the puzzle's own grid).
__device__ __forceinline__ int frame_cell(int2 q, int dx, int dy, int4 g, int W) {
  const long long x = static_cast<long long>(q.x) + dx, y = static_cast<long long>(q.y) + dy;
  if (x < 0 || x >= g.w || y < 0 || y >= g.z) return -1;
  return (static_cast<int>(y) + g.x) * W + static_cast<int>(x) + g.y;
}

// Persistent: CTA blockIdx.x writes its share of the output run (the header
// note), a state at a time, with the next state's inputs in flight.  bulk:
// the zeros, the slabs and their copies, else direct 16-byte stores.
__global__ void __launch_bounds__(kFramedThreads) render_onehot_framed_kernel(Framed r, long long B, int bulk) {
  extern __shared__ __align__(16) int smem[];
  int* grid = smem + (bulk ? kBufferFloats : 0);  // the puzzle's rows of the frame's cells
  const int t = threadIdx.x, T = kFramedThreads, HW = r.H * r.W, W = r.W, nC = r.n * r.C, lane = t & 31;
  float* ring = reinterpret_cast<float*>(smem) + (t >> 5) * kRing * kSlabFloats;  // this warp's slabs, where bulk
  float* zeros = reinterpret_cast<float*>(smem) + kRingFloats;
  float* carry = zeros + kZeroFloats;  // two lines
  int cur = 0;                         // the carry line being assembled
  if (bulk) {
    for (int i = t; i < kZeroFloats / 4; i += T) reinterpret_cast<float4*>(zeros)[i] = make_float4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros, to the copies
  }
  __syncthreads();
  const long long S = static_cast<long long>(HW) * kChannels, F = B * S, L = (F + kLine - 1) / kLine;
  const long long f0 = min(F, kLine * (L * blockIdx.x / gridDim.x));
  const long long f1 = min(F, kLine * (L * (blockIdx.x + 1) / gridDim.x));
  int slabs = 0;  // slabs this warp has filled
  const uint64_t policy = evict_first();
  // The inputs in flight at state b: b's cells in x, b + 1's puzzle and
  // geometry (p1, g1), b + 2's puzzle (p2); past the share's last state,
  // its last's again.
  const long long b0 = f0 / S, last = (f1 + S - 1) / S - 1;
  if (f0 >= f1) return;
  Prefetch x;
  long long pc = r.puzzle_idx[b0];
  int4 gc = r.geom[pc];
  prefetch(x, r, b0, pc, gc, t);
  long long p1 = r.puzzle_idx[min(b0 + 1, last)], p2 = r.puzzle_idx[min(b0 + 2, last)];
  int4 g1 = r.geom[p1];
  for (long long b = b0; b <= last; ++b) {
    const long long p = pc;
    const int4 g = gc;
    const int2 q0 = x.q;
    const int dx0 = x.dx, dy0 = x.dy, on0 = x.on;
    // The frame's rows [g.x, g.x + g.z) hold the puzzle: its cells [in0, in1).
    // The grid holds them alone, pad columns 0; every other cell is pad.
    const int in0 = g.x * W, in1 = (g.x + g.z) * W;
    // This frame's floats [lo, hi) of the run: a head and a tail off the
    // 128-byte lines (carry lines, below), the lines [a0, a1) between: the
    // puzzle's rows' lines [c0, c1) from slabs, the pad rows' from the
    // zeros, copied at once.
    const long long s0 = b * S, lo = max(f0, s0), hi = min(f1, s0 + S);
    const long long a0 = min(hi, (lo + kLine - 1) / kLine * kLine), a1 = max(a0, hi / kLine * kLine);
    const long long c0 = bulk ? min(a1, max(a0, (s0 + kChannels * in0) / kLine * kLine)) : a0;
    const long long c1 = bulk ? max(c0, min(a1, (s0 + kChannels * in1 + kLine - 1) / kLine * kLine)) : a1;
    if (t == kZeroThread) {
      for (long long z = a0; z < c0; z += kZeroFloats) bulk_store(r.out + z, zeros, zero_bytes(c0 - z), policy);
      for (long long z = c1; z < a1; z += kZeroFloats) bulk_store(r.out + z, zeros, zero_bytes(a1 - z), policy);
    }
    __syncthreads();  // the last state's reads of the grid are done
#pragma unroll
    for (int i = 0; i < kBaseRegs; ++i)
      if (t + i * T < in1 - in0) grid[in0 + t + i * T] = x.base[i];
    if (b < last) prefetch(x, r, b + 1, p1, g1, t);  // in flight while this state is written
    pc = p1;
    gc = g1;
    p1 = p2;
    g1 = r.geom[p2];
    p2 = r.puzzle_idx[min(b + 3, last)];
    for (int c = t + kBaseRegs * T; c < in1 - in0; c += T) {
      const int col = c % W;
      grid[in0 + c] = col >= g.y && col < g.y + g.w ? static_cast<uint8_t>(r.base[p * HW + in0 + c]) : 0;
    }
    __syncthreads();
    PW_NEXT(1, grid[t % HW]);  // phase: pad rows' zero copies, base staged
    // The movables' cells: the first from registers, the rest (more than T
    // cells a state) from memory.
    for (int e = t; e < nC; e += T) {
      int at = -1;
      if (e == t) {
        if (on0) at = frame_cell(q0, dx0, dy0, g, W);
      } else if (r.cell_mask[p * nC + e]) {
        at = frame_cell(r.states[b * r.n + e / r.C], r.cells[2 * (p * nC + e)], r.cells[2 * (p * nC + e) + 1], g,
                        W);
      }
      if (at >= 0) atomicMax(grid + at, ((e / r.C + 1) << 8) | (grid[at] & 0xFF));  // the base byte never changes
    }
    __syncthreads();
    PW_NEXT(2, grid[t % HW]);  // phase: movables' atomicMax
#pragma unroll 4
    for (int c = in0 + t; c < in1; c += T) {
      const int v = grid[c], top = v >> 8, bc = v & 0xFF;
      const int k = top ? r.obj_class[p * r.n + top - 1] : bc;
      grid[c] = (bc == 1 ? 1 : 0) | (k >= 2 && k <= kChannels ? 1 << (k - 1) : 0);
    }
    __syncthreads();
    PW_NEXT(3, grid[t % HW]);  // phase: channel bits
    if (!bulk) {
      for (int f = static_cast<int>(lo - s0) + t; f < a0 - s0; f += T) r.out[s0 + f] = single(grid, f, in0, in1);
      for (int f = static_cast<int>(a1 - s0) + t; f < hi - s0; f += T) r.out[s0 + f] = single(grid, f, in0, in1);
      float4* out4 = reinterpret_cast<float4*>(r.out);
      for (long long q = a0 / 4 + t; q < a1 / 4; q += T) out4[q] = quad(grid, static_cast<int>(4 * q - s0), in0, in1);
      continue;
    }
    // A line that a frame boundary cuts (in the share: shares end on lines)
    // is assembled by warp 0 in a carry line, from this frame's head [lo,
    // a0) after the frames before it, and copied once whole; this frame's
    // tail [a1, hi) begins the next carry line.  The run's last line, where
    // it is not whole, is plain stores.
    if (t < 32) {
      const long long line = lo / kLine * kLine, end = F % kLine ? F / kLine * kLine : F;
      if (lo > line && line == end) {
        for (long long f = lo + lane; f < a0; f += 32) r.out[f] = single(grid, static_cast<int>(f - s0), in0, in1);
      } else if (lo > line) {
        for (long long f = lo + lane; f < a0; f += 32)
          carry[cur * kLine + (f - line)] = single(grid, static_cast<int>(f - s0), in0, in1);
        if (a0 == line + kLine) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the line, to the copy
          __syncwarp();
          if (t == kCarryThread) bulk_store(r.out + line, carry + cur * kLine, 4 * kLine, policy);
          cur ^= 1;
        }
      }
      if (a1 < hi && a1 == end) {
        for (long long f = a1 + lane; f < hi; f += 32) r.out[f] = single(grid, static_cast<int>(f - s0), in0, in1);
      } else if (a1 < hi) {
        if (t == kCarryThread) bulk_wait_read<1>();  // the line's last copy has read it
        __syncwarp();
        for (long long f = a1 + lane; f < hi; f += 32)
          carry[cur * kLine + (f - a1)] = single(grid, static_cast<int>(f - s0), in0, in1);
      }
    }
    // Slab j of [c0, c1) to warp j % kWarps, each warp on its own ring: no
    // barrier between warps until the next state.
    for (long long s = c0 + (t >> 5) * kSlabFloats; s < c1; s += kWarps * kSlabFloats, ++slabs) {
      const int n4 = static_cast<int>(min(static_cast<long long>(kSlabFloats), c1 - s) / 4);
      float4* slab = reinterpret_cast<float4*>(ring + (slabs % kRing) * kSlabFloats);
      if (slabs >= kRing) {  // the slab's last copy has read it
        if (lane == 0) bulk_wait_read<kRing - 1>();
        __syncwarp();
      }
      const int f = static_cast<int>(s - s0);
      if (n4 == kSlabFloats / 4) {
#pragma unroll
        for (int i = 0; i < kSlabFloats / 128; ++i)
          slab[lane + 32 * i] = quad(grid, f + 4 * (lane + 32 * i), in0, in1);
      } else {
        for (int q = lane; q < n4; q += 32) slab[q] = quad(grid, f + 4 * q, in0, in1);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the slab, to the copy
      __syncwarp();
      PW_NEXT(4, static_cast<int>(slab[lane % n4].x));  // phase: slabs filled, no slab copies
      if (lane == 0) bulk_store(r.out + s, slab, 16 * n4, policy);
    }
  }
  if (lane == 0 || t == kZeroThread || t == kCarryThread) bulk_wait_read<0>();  // smem outlives the copies' reads
}

}  // namespace

// Writes out (B, H, W, 6) float32 from states (B, n, 2) int32 and the
// render tables.  states are 8-byte aligned, out 16-byte aligned.  A grid
// whose 4 H W bytes exceed kMaxSharedBytes is refused.
extern "C" int pw_render_onehot(const void* states, const void* base, const void* cells, const void* cell_mask,
                                const void* obj_class, void* out, long long B, int n, int C, int H, int W,
                                void* stream) {
  if (B < 0 || B > (1ll << 31) - 1 || n < 1 || C < 1 || H < 1 || W < 1 || n >= (1 << 23))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 4ll * H * W;
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(render_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long vec = static_cast<long long>(H) * W * kChannels / 4;
  const int threads = vec >= 256 ? 256 : (vec >= 128 ? 128 : (vec >= 64 ? 64 : 32));
  Render r{static_cast<const int2*>(states),      static_cast<const int8_t*>(base),
           static_cast<const int16_t*>(cells),    static_cast<const uint8_t*>(cell_mask),
           static_cast<const int8_t*>(obj_class), static_cast<float*>(out),
           n, C, H, W};
  render_onehot_kernel<<<static_cast<unsigned>(B), threads, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(r);
  return static_cast<int>(cudaGetLastError());
}

// Writes out (B, H, W, 6) float32, the frame of each state of states (B, n,
// 2) int32 of the stacked puzzles puzzle_idx (B,) int32 names, from their
// framed render tables (P puzzles; geom (P, 4) int32, 16-byte aligned).
// states are 8-byte aligned, out 16-byte aligned; puzzle_idx is not
// checked.  A frame whose 4 H W bytes exceed kMaxSharedBytes is refused.
extern "C" int pw_render_onehot_framed(const void* states, const void* puzzle_idx, const void* base,
                                       const void* cells, const void* cell_mask, const void* obj_class,
                                       const void* geom, void* out, long long B, int n, int C, int H, int W,
                                       void* stream) {
  if (B < 0 || B > (1ll << 31) - 1 || n < 1 || C < 1 || H < 1 || W < 1 || n >= (1 << 23))
    return static_cast<int>(cudaErrorInvalidValue);
  if (4ll * H * W > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bulk = framed_bulk(H, W) ? 1 : 0;
  const long long smem = 4ll * (H * W + (bulk ? kBufferFloats : 0));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(render_onehot_framed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Framed r{static_cast<const int2*>(states),    static_cast<const int32_t*>(puzzle_idx),
           static_cast<const int8_t*>(base),    static_cast<const int16_t*>(cells),
           static_cast<const uint8_t*>(cell_mask), static_cast<const int8_t*>(obj_class),
           static_cast<const int4*>(geom),      static_cast<float*>(out),
           n, C, H, W};
  render_onehot_framed_kernel<<<static_cast<unsigned>(framed_ctas(B, H, W, sms)), kFramedThreads,
                                static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(r, B, bulk);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs a framed launch of B states on H x W frames takes on the current
// device (the check of ops/render.py's mirror); -1 where the device cannot
// be read.
extern "C" long long pw_render_framed_ctas(long long B, int H, int W) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                cudaSuccess)
    return -1;
  return framed_ctas(B, H, W, sms);
}
