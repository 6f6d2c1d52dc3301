"""What a device-side loop's body costs beyond its kernels, on the card.

``python -m pushworld_tpu_torch.scripts.profile_loop_floor [--bodies N]``

A search chunk on the card is a CUDA graph whose WHILE node runs one
iteration a body (``kernels/chunk_loop.cu``).  This script builds, from the
CUDA source below, bodies of K chained empty kernels followed by a one-thread
kernel that sets the loop's condition (as ``chunk_continue`` does), and
times ``--bodies`` of them in one launch of the loop, beside the same K + 1
kernels as a plain graph launched ``--bodies`` times back to back from the
host.  CUDA events around each; the first of two runs is a warm-up.  Prints
one JSON line: the card, its power limit, and microseconds a body for each
K and each way.  Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import json
import subprocess

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void empty_kernel() {}
__global__ void setter(int* n, int limit, cudaGraphConditionalHandle h) {
  int k = ++*n;
  if (h) cudaGraphSetConditional(h, k < limit);
}

static cudaError_t chain(cudaGraph_t g, int k, int* n, int limit, cudaGraphConditionalHandle h) {
  cudaGraphNode_t prev = nullptr, node;
  cudaKernelNodeParams p = {};
  void* none[] = {nullptr};
  p.func = (void*)empty_kernel; p.gridDim = dim3(1); p.blockDim = dim3(32); p.kernelParams = none;
  for (int i = 0; i < k; ++i) {
    cudaError_t e = cudaGraphAddKernelNode(&node, g, prev ? &prev : nullptr, prev ? 1 : 0, &p);
    if (e) return e;
    prev = node;
  }
  void* args[] = {&n, &limit, &h};
  p.func = (void*)setter; p.kernelParams = args;
  return cudaGraphAddKernelNode(&node, g, prev ? &prev : nullptr, prev ? 1 : 0, &p);
}

// loop 1: one launch of a WHILE loop of n bodies; loop 0: a plain graph of
// the body launched n times.  *ms: the events' time of the second run.
extern "C" int pw_time_bodies(int loop, int k, int n, int* counter, float* ms, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaGraph_t g;
  cudaGraphExec_t ex;
  cudaEvent_t a, b;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e) return e;
  if (loop) {
    cudaGraphConditionalHandle h;
    e = cudaGraphConditionalHandleCreate(&h, g, 1, cudaGraphCondAssignDefault);
    if (e) return e;
    cudaGraphNodeParams c = {};
    c.type = cudaGraphNodeTypeConditional; c.conditional.handle = h;
    c.conditional.type = cudaGraphCondTypeWhile; c.conditional.size = 1;
    cudaGraphNode_t w;
    e = cudaGraphAddNode(&w, g, nullptr, 0, &c);
    if (!e) e = chain(c.conditional.phGraph_out[0], k, counter, n, h);
  } else {
    e = chain(g, k, counter, n, 0);
  }
  if (!e) e = cudaGraphInstantiate(&ex, g, 0);
  if (e) return e;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int rep = 0; rep < 2 && !e; ++rep) {
    cudaMemsetAsync(counter, 0, 4, stream);
    cudaEventRecord(a, stream);
    if (loop) e = cudaGraphLaunch(ex, stream);
    else for (int i = 0; i < n && !e; ++i) e = cudaGraphLaunch(ex, stream);
    cudaEventRecord(b, stream);
    if (!e) e = cudaEventSynchronize(b);
  }
  if (!e) e = cudaEventElapsedTime(ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  cudaGraphExecDestroy(ex);
  cudaGraphDestroy(g);
  return e;
}
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bodies", type=int, default=2000)
    args = ap.parse_args(argv)

    import torch

    from pushworld_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib_path = _build.BUILD_DIR / "loop_floor.cu", _build.BUILD_DIR / "libloop_floor.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.pw_time_bodies.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    counter = torch.zeros((), dtype=torch.int32, device="cuda")
    rows = []
    for k in (0, 1, 4, 8):
        row = {"empty_kernels": k}
        for loop, name in ((1, "while_loop_us_per_body"), (0, "graph_launches_us_per_body")):
            ms = ctypes.c_float(0)
            rc = lib.pw_time_bodies(loop, k, args.bodies, counter.data_ptr(), ctypes.byref(ms),
                                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"pw_time_bodies(loop={loop}, k={k}) failed: CUDA error {rc}")
            row[name] = ms.value / args.bodies * 1e3
        rows.append(row)
    print(json.dumps({"card": card, "bodies": args.bodies, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
