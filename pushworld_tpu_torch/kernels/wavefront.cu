// Batched wavefront distance fields, one CTA per field, resident in shared
// memory.
//
// Replaces the Pallas TPU kernel pushworld_tpu/ops/graphs_pallas.py
// (_wavefront_kernel, lines 38-78, launched by distance_fields_pallas).  It
// computes, for every field b,
//
//   d[p] = min(d[p], min_a (E[a, p] ? d[p + disp_a] + 1 : INF))
//
// swept (Jacobi: every sweep reads the previous sweep's field) until a sweep
// changes nothing or after max_iters sweeps; out-of-grid neighbours read INF
// (1e9).  Results are small integers in float32, bit-equal to the plain
// PyTorch version (graphs.distance_fields_reference).  INF + 1 rounds back to
// INF in float32, exactly as in the plain version.
//
// Design: the TPU kernel relaxed 16 fields in lockstep with roll/iota-masked
// full-tile shifts to keep its vector unit fed.  Here one CTA owns one field:
// its H*W distance plane (two buffers, ping-pong) and its four feasibility
// masks (packed into one byte per cell, bit a = direction a) live in shared
// memory for the whole relaxation, so device memory sees each input once and
// the output once.  A __syncthreads_or of the per-thread "changed" flags ends
// the loop.  At the benchmark's largest grid (47 x 54) a CTA holds
// 2538 * 9 bytes = 22.8 KB of shared memory.  Fields that share one mask
// stack (all-pairs blocks: one field per source vertex of one object) pass
// e_stride = 0 and the masks are read from one copy.
//
// Bound: operations.  A field needs (its largest finite distance + 1) sweeps
// of H*W cells with four add+min pairs each, against one read of d0 and the
// masks and one write of the field.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (see _build.py);
// plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e9f;
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // per-block shared memory on sm_90

__global__ void wavefront_kernel(const uint8_t* __restrict__ emask, long long e_stride,
                                 const float* __restrict__ d0, float* __restrict__ out,
                                 int H, int W, int max_iters) {
  extern __shared__ float smem[];
  const int HW = H * W;
  float* cur = smem;
  float* nxt = smem + HW;
  uint8_t* m = reinterpret_cast<uint8_t*>(smem + 2 * HW);

  const long long b = blockIdx.x;
  const uint8_t* e = emask + b * e_stride;
  const float* src = d0 + b * static_cast<long long>(HW);
  for (int p = threadIdx.x; p < HW; p += blockDim.x) {
    cur[p] = src[p];
    m[p] = e[p];
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    int changed = 0;
    for (int p = threadIdx.x; p < HW; p += blockDim.x) {
      const int y = p / W;
      const int x = p - y * W;
      const uint8_t mk = m[p];
      const float old = cur[p];
      float best = old;
      // Action order and displacements: L (-1, 0), R (1, 0), U (0, -1), D (0, 1).
      best = fminf(best, (mk & 1) ? (x > 0 ? cur[p - 1] : kInf) + 1.0f : kInf);
      best = fminf(best, (mk & 2) ? (x < W - 1 ? cur[p + 1] : kInf) + 1.0f : kInf);
      best = fminf(best, (mk & 4) ? (y > 0 ? cur[p - W] : kInf) + 1.0f : kInf);
      best = fminf(best, (mk & 8) ? (y < H - 1 ? cur[p + W] : kInf) + 1.0f : kInf);
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

  float* dst = out + b * static_cast<long long>(HW);
  for (int p = threadIdx.x; p < HW; p += blockDim.x) dst[p] = cur[p];
}

}  // namespace

// emask: (Be, H, W) uint8, bit a set iff E[a, y, x]; field b reads
// emask + b * e_stride (e_stride = 0: one stack shared by all fields).
// d0, out: (B, H, W) float32.  Returns a cudaError_t (0 on success).
extern "C" int pw_wavefront(const void* emask, long long e_stride, const void* d0, void* out,
                            int B, int H, int W, int max_iters, void* stream) {
  const size_t smem = static_cast<size_t>(H) * W * (2 * sizeof(float) + 1);
  if (smem > kMaxSmem || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wavefront_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(emask), e_stride, static_cast<const float*>(d0),
      static_cast<float*>(out), H, W, max_iters);
  return static_cast<int>(cudaGetLastError());
}
