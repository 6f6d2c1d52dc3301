// Batched wavefront distance fields: a level-synchronous, bit-parallel
// breadth-first frontier, one warp per field.
//
// Replaces the Pallas TPU kernel pushworld_tpu/ops/graphs_pallas.py
// (_wavefront_kernel, lines 38-78, launched by distance_fields_pallas).  It
// computes, for every field b,
//
//   d[p] = min(d[p], min_a (E[a, p] ? d[p + disp_a] + 1 : INF))
//
// swept (Jacobi: every sweep reads the previous sweep's field) until a sweep
// changes nothing or after max_iters sweeps; out-of-grid neighbours read INF
// (1e9).  Results are bit-equal to the plain PyTorch version
// (graphs.distance_fields_reference).
//
// Bound: bytes.  The function reads its seeds and its masks once and writes
// its fields once (47.5 MB for 2,340 fields of 47 x 54: 0.0142 ms at
// 3.35 TB/s); one visit per cell per field is the smaller term.  Relaxing a
// field with full float sweeps costs (largest finite distance + 1) sweeps
// of H*W cells, about 100 times the function's work on an open 47 x 54 grid.
//
// Design.  The table build always seeds a field with 0 at its targets and
// INF elsewhere.  With such seeds k Jacobi sweeps give exactly "breadth-first
// distance if it is <= k, else INF" (INF + 1 rounds back to INF in float32),
// so a level-synchronous search that stops after max_iters levels is
// bit-equal to the sweeps at every cap.  A grid row is ceil(W/64) 64-bit
// words.  A field keeps one "reached" bit per cell, and one level of a row
// word is
//
//   next = (reached << 1 & E_L) | (reached >> 1 & E_R)
//        | (reached[y-1] & E_U) | (reached[y+1] & E_D)     new = next & ~reached
//
// (cell p is reached when E[a, p] and p + disp_a is reached; action order
// L (-1, 0), R (1, 0), U (0, -1), D (0, 1); shifts carry between the words of
// a row; bits beyond W and rows beyond H read as unreached).  One WARP owns a
// field, and records the level of each newly set bit in a per-warp plane of
// 16-bit levels in shared memory (0xFFFF = unreached).  A level ends in a
// warp vote, not a CTA barrier; the loop ends when no lane found a new bit.
// At the end the warp writes the float32 field once, coalesced.  Device
// memory sees the seeds once, the bool masks once and the output once.
//
// Two forms of the level loop.  A grid of at most 64 x 64 cells (every
// benchmark puzzle) keeps its rows in registers: lane l holds the reached
// words and the four mask words of rows 2l and 2l + 1, so a row finds one
// vertical neighbour in its own lane and the other one lane away by shuffle,
// and a level is two shuffles, a few dozen logic instructions and the vote.
// Any other grid keeps the reached words in shared memory: lane l updates
// row words l, l + 32, ... between two buffers (ping-pong, so a level never
// reads its own writes) with a __syncwarp per level.
//
// A call is two launches.  pack_masks_kernel first packs the bool mask
// planes into bit rows (one warp per row word, 1.5 KB per stack at 47 x 54),
// once per call: all fields of an all-pairs block share one stack
// (e_stride == 0).  Packing in every CTA of the fields' kernel instead cost
// each CTA 18 us of dependent byte loads, a fifth of the call.  Then
// wavefront_kernel: a CTA is up to kMaxWarps warps, each on one of as many
// consecutive fields, and copies the packed rows into shared memory, one
// copy per CTA for a shared stack, else one per warp.  While a warp loads
// its seeds (sixteen independent loads per lane at a time, to keep the
// memory system busy) it checks that each is exactly 0 or INF.  A field
// with any other seed takes the general path: after a CTA barrier the whole
// CTA relaxes it with the float Jacobi sweeps of the definition above, in the
// shared memory the planes occupied (two float planes; the masks stay bit
// rows).  The decision is per field and on the device.
//
// Occupancy.  At 47 x 54 a warp holds 2 * 47 reached words (752 B) and a
// 5,080 B level plane, and the CTA 4 * 47 mask words (1,504 B): 24.8 KB for 4
// warps, so nine CTAs (36 warps) fit an SM's 227 KB.  The 2,340 fields of a
// block are 585 CTAs over 132 SMs, all resident at once, 4 or 5 CTAs (at
// most 20 warps) per SM; with 8 warps per CTA the fullest SM held 24 warps
// against a mean of 18 and set the time.  A level is about 90 instructions
// per warp in a dependent chain, so the level loop is bound by the instruction
// rate of the fullest SM (about 0.4 us per level there), not by bytes.
// Larger grids take the most warps (4, 2, 1) whose planes fit 227 KB.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr float kInf = 1e9f;
constexpr int kMaxWarps = 4;
// Per-block shared memory on sm_90, less the static general-path flags.
constexpr size_t kMaxSmem = 232448 - 32 * sizeof(int);
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxCells = 65534;  // levels fit 16 bits, 0xFFFF = unreached

// Phase timers for scripts/profile_wavefront.py, compiled in only with
// -DPW_PHASE_TIMERS: thread 0 of each of the first kTimedCtas CTAs stamps
// the global nanosecond timer at five points of wavefront_kernel.
#ifdef PW_PHASE_TIMERS
constexpr int kTimedCtas = 8192;
__device__ long long g_phase_ns[5 * kTimedCtas];
#define PW_MARK(k)                                                       \
  if (threadIdx.x == 0 && blockIdx.x < kTimedCtas)                       \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_phase_ns[blockIdx.x * 5 + (k)]))
#else
#define PW_MARK(k)
#endif

struct Layout {
  int nw;           // 64-bit words per grid row
  int rw;           // row words per bit plane: H * nw
  size_t warp_off;  // bytes of the mask rows ahead of the warps' regions
  size_t per_warp;  // bytes of one warp's reached buffers and level plane
  size_t total;
};

__host__ __device__ inline Layout layout(int H, int W, int warps, bool shared_masks) {
  Layout l;
  l.nw = (W + 63) / 64;
  l.rw = H * l.nw;
  l.warp_off = static_cast<size_t>(shared_masks ? 1 : warps) * 4 * l.rw * sizeof(u64);
  const size_t plane = (static_cast<size_t>(H) * W * sizeof(uint16_t) + 7) / 8 * 8;
  l.per_warp = 2 * l.rw * sizeof(u64) + plane;
  // The general path's two float planes reuse the warps' regions.
  const size_t general = 2 * static_cast<size_t>(H) * W * sizeof(float);
  const size_t regions = warps * l.per_warp;
  l.total = l.warp_off + (regions > general ? regions : general);
  return l;
}

// Packs the bool mask planes into bit rows, one warp per row word: stack s,
// plane a, row y, word j of packed (Be, 4, H * nw) gets bit x - 64 j set iff
// emask[s * e_stride + a * plane_stride + y * W + x].  Run once per call,
// ahead of wavefront_kernel, so that the fields' CTAs load finished words.
__global__ void pack_masks_kernel(const uint8_t* __restrict__ emask, long long e_stride,
                                  long long plane_stride, u64* __restrict__ packed, int H,
                                  int W, int nw, long long n_words) {
  const long long word = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (word >= n_words) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int rw = H * nw;
  const long long s = word / (4 * rw);
  const int idx = static_cast<int>(word - s * 4 * rw);
  const int a = idx / rw;
  const int r = idx - a * rw;
  const int y = r / nw;
  const int x = (r - y * nw) * 64 + lane;
  const uint8_t* row = emask + s * e_stride + a * plane_stride + static_cast<size_t>(y) * W;
  const unsigned lo = __ballot_sync(kFull, x < W && row[x]);
  const unsigned hi = __ballot_sync(kFull, x + 32 < W && row[x + 32]);
  if (lane == 0) packed[word] = static_cast<u64>(hi) << 32 | lo;
}

// Records `level` for the cells of one row word whose bits are set in fresh.
__device__ __forceinline__ void record(uint16_t* __restrict__ cells, u64 fresh, int level) {
  for (unsigned lo = static_cast<unsigned>(fresh); lo; lo &= lo - 1)
    cells[__ffs(lo) - 1] = static_cast<uint16_t>(level);
  for (unsigned hi = static_cast<unsigned>(fresh >> 32); hi; hi &= hi - 1)
    cells[31 + __ffs(hi)] = static_cast<uint16_t>(level);
}

// One level of one row word: the cells newly reached from reached word r, its
// row neighbours (left, right: carry bits only) and the words above and below.
__device__ __forceinline__ u64 spread(u64 r, u64 fromL, u64 fromR, u64 up, u64 down, u64 eL,
                                      u64 eR, u64 eU, u64 eD) {
  return ((fromL & eL) | (fromR & eR) | (up & eU) | (down & eD)) & ~r;
}

// The levels of a grid of at most 64 rows of at most 64 cells: lane l keeps
// rows 2l and 2l + 1 and their masks in registers, so each row finds one
// vertical neighbour in its own lane and the other one lane away, by
// shuffle; the loop touches shared memory only to record a level.  ra holds
// the seeds' reached words.
__device__ void levels_in_registers(const u64* __restrict__ masks, const u64* __restrict__ ra,
                                    uint16_t* __restrict__ plane, int H, int W, int max_iters,
                                    int lane) {
  const int y0 = 2 * lane, y1 = 2 * lane + 1;
  u64 r0 = 0, r1 = 0, e0[4] = {0, 0, 0, 0}, e1[4] = {0, 0, 0, 0};
  if (y0 < H) {
    r0 = ra[y0];
    for (int a = 0; a < 4; ++a) e0[a] = masks[a * H + y0];
  }
  if (y1 < H) {
    r1 = ra[y1];
    for (int a = 0; a < 4; ++a) e1[a] = masks[a * H + y1];
  }
  // Rows at and beyond H keep reached = 0 and masks = 0, so they stay inert.
  for (int level = 1; level <= max_iters; ++level) {
    u64 up0 = __shfl_up_sync(kFull, r1, 1);      // row 2l - 1
    u64 down1 = __shfl_down_sync(kFull, r0, 1);  // row 2l + 2
    if (lane == 0) up0 = 0;
    if (lane == 31) down1 = 0;
    const u64 fresh0 = spread(r0, r0 << 1, r0 >> 1, up0, r1, e0[0], e0[1], e0[2], e0[3]);
    const u64 fresh1 = spread(r1, r1 << 1, r1 >> 1, r0, down1, e1[0], e1[1], e1[2], e1[3]);
    r0 |= fresh0;
    r1 |= fresh1;
    record(plane + y0 * W, fresh0, level);
    record(plane + y1 * W, fresh1, level);
    if (!__any_sync(kFull, (fresh0 | fresh1) != 0)) break;
  }
  __syncwarp();
}

// The levels of any grid: the reached words live in shared memory, lane l
// updates row words l, l + 32, ... from buffer ra into buffer rb, and the two
// swap after every level.
__device__ void levels_in_shared(const u64* __restrict__ masks, u64* ra, u64* rb,
                                 uint16_t* __restrict__ plane, int H, int W, int nw,
                                 int max_iters, int lane) {
  const int rw = H * nw;
  const u64* eL = masks;
  const u64* eR = masks + rw;
  const u64* eU = masks + 2 * rw;
  const u64* eD = masks + 3 * rw;
  for (int level = 1; level <= max_iters; ++level) {
    bool found = false;
    for (int i = lane; i < rw; i += 32) {
      const int y = i / nw;
      const int j = i - y * nw;
      const u64 r = ra[i];
      u64 fromL = r << 1;
      u64 fromR = r >> 1;
      if (j > 0) fromL |= ra[i - 1] >> 63;
      if (j < nw - 1) fromR |= ra[i + 1] << 63;
      const u64 up = y > 0 ? ra[i - nw] : 0;
      const u64 down = y < H - 1 ? ra[i + nw] : 0;
      const u64 fresh = spread(r, fromL, fromR, up, down, eL[i], eR[i], eU[i], eD[i]);
      rb[i] = r | fresh;
      found |= fresh != 0;
      record(plane + y * W + j * 64, fresh, level);
    }
    __syncwarp();
    u64* t = ra;
    ra = rb;
    rb = t;
    if (!__any_sync(kFull, found)) break;
  }
}

__global__ void wavefront_kernel(const u64* __restrict__ packed, bool shared_masks,
                                 const float* __restrict__ d0, float* __restrict__ out, int B,
                                 int H, int W, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int general[32];

  PW_MARK(0);
  const int HW = H * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const Layout l = layout(H, W, warps, shared_masks);
  const int nw = l.nw, rw = l.rw;

  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  const bool active = b < B;
  u64* masks = reinterpret_cast<u64*>(smem) + (shared_masks ? 0 : static_cast<size_t>(warp) * 4 * rw);
  unsigned char* region = smem + l.warp_off + warp * l.per_warp;
  u64* ra = reinterpret_cast<u64*>(region);
  u64* rb = ra + rw;
  uint16_t* plane = reinterpret_cast<uint16_t*>(rb + rw);

  if (shared_masks) {
    for (int i = threadIdx.x; i < 4 * rw; i += blockDim.x) masks[i] = packed[i];
  } else if (active) {
    for (int i = lane; i < 4 * rw; i += 32) masks[i] = packed[b * 4 * rw + i];
  }

  PW_MARK(1);  // masks copied (by warp 0; the others may still be at it)
  // Seeds: levels 0 / unreached, the reached bits, and the 0-or-INF check.
  // kLoads independent loads are in flight per lane.
  bool odd = false;
  if (active) {
    const float* src = d0 + b * HW;
    for (int i = lane; i < rw; i += 32) ra[i] = 0;
    __syncwarp();
    constexpr int kLoads = 16;
    for (int base = lane; base < HW; base += 32 * kLoads) {
      float v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) v[k] = base + 32 * k < HW ? __ldcs(src + base + 32 * k) : kInf;
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int p = base + 32 * k;
        const bool seed = v[k] == 0.0f;
        odd |= !seed && v[k] != kInf;
        if (p < HW) plane[p] = seed ? 0 : 0xFFFF;
        if (p < HW && seed) {
          const int y = p / W;
          const int x = p - y * W;
          atomicOr(ra + y * nw + (x >> 6), 1ull << (x & 63));
        }
      }
    }
    odd = __any_sync(kFull, odd);
  }
  if (lane == 0) general[warp] = odd;
  __syncthreads();  // the shared mask rows are complete
  PW_MARK(2);  // seeds loaded

  if (active && !odd) {
    if (nw == 1 && H <= 64) {
      levels_in_registers(masks, ra, plane, H, W, max_iters, lane);
    } else {
      levels_in_shared(masks, ra, rb, plane, H, W, nw, max_iters, lane);
    }
    PW_MARK(3);  // levels done
    float* dst = out + b * HW;
    for (int p = lane; p < HW; p += 32) {
      const uint16_t v = plane[p];
      __stcs(dst + p, v == 0xFFFF ? kInf : static_cast<float>(v));
    }
  }

  PW_MARK(4);  // field stored
  // General path: fields whose seeds are not all 0 or INF, one at a time by
  // the whole CTA, with the float sweeps of the definition.
  for (int w = 0; w < warps; ++w) {
    if (!general[w]) continue;  // uniform over the CTA
    __syncthreads();  // every warp is done with the shared memory reused here
    const long long f = static_cast<long long>(blockIdx.x) * warps + w;
    float* cur = reinterpret_cast<float*>(smem + l.warp_off);
    float* nxt = cur + HW;
    const u64* m = reinterpret_cast<u64*>(smem) + (shared_masks ? 0 : static_cast<size_t>(w) * 4 * rw);
    const float* src = d0 + f * HW;
    for (int p = threadIdx.x; p < HW; p += blockDim.x) cur[p] = src[p];
    __syncthreads();
    for (int it = 0; it < max_iters; ++it) {
      int changed = 0;
      for (int p = threadIdx.x; p < HW; p += blockDim.x) {
        const int y = p / W;
        const int x = p - y * W;
        const int i = y * nw + (x >> 6);
        const int s = x & 63;
        const float old = cur[p];
        float best = old;
        best = fminf(best, (m[i] >> s & 1) ? (x > 0 ? cur[p - 1] : kInf) + 1.0f : kInf);
        best = fminf(best, (m[rw + i] >> s & 1) ? (x < W - 1 ? cur[p + 1] : kInf) + 1.0f : kInf);
        best = fminf(best, (m[2 * rw + i] >> s & 1) ? (y > 0 ? cur[p - W] : kInf) + 1.0f : kInf);
        best = fminf(best, (m[3 * rw + i] >> s & 1) ? (y < H - 1 ? cur[p + W] : kInf) + 1.0f : kInf);
        nxt[p] = best;
        changed |= (best != old);
      }
      // The barrier also orders this sweep's writes before the next sweep's reads.
      const int any = __syncthreads_or(changed);
      float* t = cur;
      cur = nxt;
      nxt = t;
      if (!any) break;
    }
    float* dst = out + f * HW;
    for (int p = threadIdx.x; p < HW; p += blockDim.x) dst[p] = cur[p];
  }
}

}  // namespace

#ifdef PW_PHASE_TIMERS
// Copies the last launch's stamps to host memory: (kTimedCtas, 5) int64.
extern "C" int pw_phase_times(void* host, int n_ctas) {
  const size_t n = static_cast<size_t>(n_ctas < kTimedCtas ? n_ctas : kTimedCtas);
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phase_ns, n * 5 * sizeof(long long)));
}
#endif

// Whether the kernel takes an H x W grid: at most 65,534 cells, and the
// planes of a single warp within a CTA's shared memory.
extern "C" int pw_wavefront_fits(int H, int W) {
  return static_cast<long long>(H) * W <= kMaxCells && layout(H, W, 1, true).total <= kMaxSmem;
}

// emask: bool bytes; field b reads the four contiguous H x W planes at
// emask + b * e_stride + a * plane_stride (e_stride = 0: one stack shared by
// all fields).  packed: scratch of (e_stride ? B : 1) * 4 * H * ceil(W / 64)
// 64-bit words.  d0, out: (B, H, W) float32, contiguous.  Two launches: the
// masks' packing, then the fields.  Returns a cudaError_t (0 on success).
extern "C" int pw_wavefront(const void* emask, long long e_stride, long long plane_stride,
                            void* packed, const void* d0, void* out, int B, int H, int W,
                            int max_iters, void* stream) {
  if (B <= 0 || max_iters < 1 || !pw_wavefront_fits(H, W))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool shared_masks = e_stride == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nw = (W + 63) / 64;
  const long long n_words = (shared_masks ? 1LL : B) * 4 * H * nw;
  constexpr int kPackWarps = 4;
  pack_masks_kernel<<<static_cast<unsigned>((n_words + kPackWarps - 1) / kPackWarps),
                      kPackWarps * 32, 0, st>>>(static_cast<const uint8_t*>(emask), e_stride,
                                                plane_stride, static_cast<u64*>(packed), H, W,
                                                nw, n_words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  int warps = kMaxWarps;
  while (layout(H, W, warps, shared_masks).total > kMaxSmem) warps /= 2;
  const size_t smem = layout(H, W, warps, shared_masks).total;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wavefront_kernel<<<(B + warps - 1) / warps, warps * 32, smem, st>>>(
      static_cast<const u64*>(packed), shared_masks, static_cast<const float*>(d0),
      static_cast<float*>(out), B, H, W, max_iters);
  return static_cast<int>(cudaGetLastError());
}
