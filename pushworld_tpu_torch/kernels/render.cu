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
// cell all-zero.  The same stages, with each state's base, movables and
// offset read by its puzzle index.  Bound: the same 24 H W output bytes a
// state, and 8N + 4 input bytes (its cells and puzzle index).
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

// As render_onehot_kernel, one CTA a state; a movable cell draws where it
// lies inside its puzzle's own grid, at the puzzle's offset in the frame.
__global__ void render_onehot_framed_kernel(Framed r) {
  extern __shared__ int grid[];
  const int t = threadIdx.x, T = blockDim.x, HW = r.H * r.W;
  const long long b = blockIdx.x;
  const long long p = r.puzzle_idx[b];
  const int8_t* base = r.base + p * HW;
  for (int c = t; c < HW; c += T) grid[c] = static_cast<uint8_t>(base[c]);
  const int4 g = r.geom[p];
  __syncthreads();
  const int2* st = r.states + b * r.n;
  const long long first = p * r.n * r.C;
  for (int e = t; e < r.n * r.C; e += T) {
    if (!r.cell_mask[first + e]) continue;
    const int k = e / r.C;
    const int2 q = st[k];
    const long long x = static_cast<long long>(q.x) + r.cells[2 * (first + e)];
    const long long y = static_cast<long long>(q.y) + r.cells[2 * (first + e) + 1];
    if (x < 0 || x >= g.w || y < 0 || y >= g.z) continue;
    const int at = (static_cast<int>(y) + g.x) * r.W + static_cast<int>(x) + g.y;
    atomicMax(grid + at, ((k + 1) << 8) | (grid[at] & 0xFF));
  }
  __syncthreads();
  to_channel_bits(grid, HW, r.obj_class + p * r.n, t, T);
  __syncthreads();
  store_run(grid, r.out, b, HW, t, T);
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
  const long long smem = 4ll * H * W;
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(render_onehot_framed_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long vec = static_cast<long long>(H) * W * kChannels / 4;
  const int threads = vec >= 256 ? 256 : (vec >= 128 ? 128 : (vec >= 64 ? 64 : 32));
  Framed r{static_cast<const int2*>(states),    static_cast<const int32_t*>(puzzle_idx),
           static_cast<const int8_t*>(base),    static_cast<const int16_t*>(cells),
           static_cast<const uint8_t*>(cell_mask), static_cast<const int8_t*>(obj_class),
           static_cast<const int4*>(geom),      static_cast<float*>(out),
           n, C, H, W};
  render_onehot_framed_kernel<<<static_cast<unsigned>(B), threads, static_cast<size_t>(smem),
                                static_cast<cudaStream_t>(stream)>>>(r);
  return static_cast<int>(cudaGetLastError());
}
