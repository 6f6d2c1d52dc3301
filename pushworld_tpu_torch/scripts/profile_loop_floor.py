"""What a device-side loop's body costs beyond its kernels, on the card.

``python -m pushworld_tpu_torch.scripts.profile_loop_floor [--bodies N]``

A search chunk on the card is a CUDA graph whose WHILE node runs one
iteration a body (``kernels/chunk_loop.cu``), and whose one memset node
sets the loop's countdown at each launch.  This script builds, from the
CUDA source below, bodies of empty kernels that end in a one-thread kernel
setting the loop's condition from a countdown (as the append's loop tail
does), and times ``--bodies`` of them in one launch of the loop, beside the
same body as a plain graph launched ``--bodies`` times back to back from
the host.  The bodies:

- ``chained``: K empty kernels one after another, then the setter (K = 0,
  1, 4, 8);
- ``forked``: K empty kernels in 1, 2 or 3 parallel branches (chains of
  about K / branches each), all joined by the setter (K = 6 and 8);
- ``iteration``: the search iteration's shapes: the body before the fork,
  9 nodes in one chain (8 kernels, then the setter), and the body with it,
  8 nodes whose longest chain is 6 (3 kernels, then branches of 2, 1 and 1
  kernels, joined by the setter, which stands for the append).

Then ``launches``: a loop that runs one body a launch (the setter alone, or
the forked iteration's shape), launched ``--bodies`` times back to back,
with no memset node before its WHILE node (the countdown runs below 1, and
the WHILE node runs its first body whatever it holds), with one and with
two (the second on a scalar of its own): the cost of a launch on a search
that has ended.

CUDA events around each; the first of two runs is a warm-up.  Prints one
JSON line: the card, its power limit, and microseconds a body (or a
launch) for each row.  Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import json
import subprocess

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void empty_kernel() {}
__global__ void setter(int* left, cudaGraphConditionalHandle h) {
  const int k = --*left;
  if (h) cudaGraphSetConditional(h, k > 0);
}

// A body: `pre` chained empty kernels, then `nb` branches after them, branch
// b `len[b]` chained empty kernels, then the setter after every branch.
static cudaError_t body(cudaGraph_t g, int pre, int nb, const int* len, int* left,
                        cudaGraphConditionalHandle h) {
  cudaKernelNodeParams p = {};
  void* none[] = {nullptr};
  p.func = (void*)empty_kernel; p.gridDim = dim3(1); p.blockDim = dim3(32); p.kernelParams = none;
  cudaGraphNode_t prev = nullptr, node, ends[16];
  int ne = 0;
  for (int i = 0; i < pre; ++i) {
    cudaError_t e = cudaGraphAddKernelNode(&node, g, prev ? &prev : nullptr, prev ? 1 : 0, &p);
    if (e) return e;
    prev = node;
  }
  for (int b = 0; b < nb && b < 16; ++b) {
    cudaGraphNode_t last = prev;
    for (int i = 0; i < len[b]; ++i) {
      cudaError_t e = cudaGraphAddKernelNode(&node, g, last ? &last : nullptr, last ? 1 : 0, &p);
      if (e) return e;
      last = node;
    }
    if (last) ends[ne++] = last;
  }
  if (ne == 0 && prev) ends[ne++] = prev;
  void* args[] = {&left, &h};
  p.func = (void*)setter; p.kernelParams = args;
  return cudaGraphAddKernelNode(&node, g, ne ? ends : nullptr, ne, &p);
}

// loop 1: `launches` launches of an outer graph [memsets] -> WHILE(body),
// its first memset setting the countdown scalars[0] to n (n bodies a
// launch), the second (memsets 2) scalars[1] to 0; loop 0: the body as a
// plain graph launched n times.  *ms: the events' time of the second run.
extern "C" int pw_time_bodies(int loop, int pre, int nb, const int* len, int memsets, int n, int launches,
                              int* scalars, float* ms, void* stream_ptr) {
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
    cudaGraphNode_t sets[2];
    for (int i = 0; i < memsets && !e; ++i) {
      cudaMemsetParams m = {};
      m.dst = scalars + i; m.value = i == 0 ? n : 0; m.elementSize = 4; m.width = 1; m.height = 1;
      e = cudaGraphAddMemsetNode(&sets[i], g, nullptr, 0, &m);
    }
    cudaGraphNodeParams c = {};
    c.type = cudaGraphNodeTypeConditional; c.conditional.handle = h;
    c.conditional.type = cudaGraphCondTypeWhile; c.conditional.size = 1;
    cudaGraphNode_t w;
    if (!e) e = cudaGraphAddNode(&w, g, sets, memsets, &c);
    if (!e) e = body(c.conditional.phGraph_out[0], pre, nb, len, scalars, h);
  } else {
    e = body(g, pre, nb, len, scalars, 0);
  }
  if (!e) e = cudaGraphInstantiate(&ex, g, 0);
  if (e) return e;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int rep = 0; rep < 2 && !e; ++rep) {
    cudaEventRecord(a, stream);
    const int count = loop ? launches : n;
    for (int i = 0; i < count && !e; ++i) e = cudaGraphLaunch(ex, stream);
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


def _branches(k, n):
    """``k`` kernels in ``n`` chains of about equal length."""
    return [k // n + (i < k % n) for i in range(n)]


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
    lib.pw_time_bodies.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_void_p]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    scalars = torch.zeros((2,), dtype=torch.int32, device="cuda")

    def us(loop, pre, branches, memsets=1, n=args.bodies, launches=1):
        """Microseconds a body (a launch where the loop runs one a launch)."""
        lens = (ctypes.c_int * max(1, len(branches)))(*branches)
        ms = ctypes.c_float(0)
        rc = lib.pw_time_bodies(loop, pre, len(branches), lens, memsets, n, launches, scalars.data_ptr(),
                                ctypes.byref(ms), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pw_time_bodies(loop={loop}, pre={pre}, branches={branches}) failed: CUDA error {rc}")
        return ms.value * 1e3 / (n if loop == 0 else n * launches)

    def both(row, pre, branches):
        return dict(row, while_loop_us_per_body=us(1, pre, branches), graph_launches_us_per_body=us(0, pre, branches))

    rows = [both({"body": "chained", "empty_kernels": k, "branches": 1}, k, []) for k in (0, 1, 4, 8)]
    rows += [both({"body": "forked", "empty_kernels": k, "branches": n, "chains": _branches(k, n)}, 0,
                  _branches(k, n)) for k in (6, 8) for n in (1, 2, 3)]
    rows.append(both({"body": "iteration, one chain", "nodes": 9, "longest_chain": 9}, 8, []))
    rows.append(both({"body": "iteration, forked", "nodes": 8, "longest_chain": 6}, 3, [2, 1, 1]))
    for name, pre, branches in (("setter alone", 0, []), ("iteration, forked", 3, [2, 1, 1])):
        for memsets in (0, 1, 2):
            rows.append({"launches": args.bodies, "body": name, "bodies_a_launch": 1, "memsets": memsets,
                         "us_per_launch": us(1, pre, branches, memsets=memsets, n=1, launches=args.bodies)})
    print(json.dumps({"card": card, "bodies": args.bodies, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
