// The search chunk as one device-side loop: a CUDA graph whose WHILE node
// runs one captured, gated search iteration until the card says stop.
//
// Replaces the JAX package's chunk, pushworld_tpu/search/batched.py:625-656
// (run_chunk: lax.fori_loop(0, chunk, body), each iteration gated by
// lax.cond on `active`, :646-655).  There is no Pallas counterpart: jit makes
// the chunk one device program, enqueued at once.  On the card a search
// iteration is eight hand-kernel launches (search/batched.py _iterate), which
// PyTorch captures into a CUDA graph (search/chunk_graph.py); this file turns
// that graph into a loop:
//
//   outer graph:  [memset remaining = b] -> WHILE(handle)
//   WHILE body:   child graph (the captured iteration)
//
// The handle's default is 1, applied at every launch
// (cudaGraphCondAssignDefault), so a launch runs at least one body.  The
// iteration's last kernel, the append (frontier.cu), ends each body with
// the loop's tail:
//
//   c = gate && !solved && hist_cursor < limit && --remaining > 0
//
// `gate` is the select kernel's gate of this iteration (JAX's `active`: not
// solved, a live frontier entry, history below its limit), `solved` and
// `hist_cursor` the state after it.  So a solve or a full history stops the
// loop at once; a frontier that empties costs one more body, whose gate is
// closed (an exact no-op); a launch on a search that has already ended runs
// that one no-op body.  The state after a launch is the state after JAX's
// fori_loop of `bound` iterations.  The tail writes c to the loop's flag,
// adds one to its body count (the host folds bodies x the body's kernels
// into its launch counts) and sets the loop's condition to c.
//
// The loop's scalars are one 16-byte device block (frontier.cu's
// LoopScalars: remaining, flag, bodies).  The outer graph's one memset node
// sets `remaining` to the launch's bound; its value is updated in the
// executable graph (cudaGraphExecMemsetNodeSetParams) only when a launch
// asks for another bound: no host read, no new instantiation.
//
// Every host function returns CUDA's error code (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ChunkLoop {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t bound_node = nullptr;
  cudaGraphConditionalHandle handle = 0;
  int* remaining = nullptr;
  int bound_value = 0;
};

cudaMemsetParams scalar_memset(void* dst, unsigned int value) {
  cudaMemsetParams p = {};
  p.dst = dst;
  p.value = value;
  p.elementSize = 4;
  p.width = 1;
  p.height = 1;
  return p;
}

}  // namespace

// A new loop: its outer graph and its condition handle (default 1, set at
// every launch).  The handle goes into the body's append launch (its loop
// tail), which is captured before pw_chunk_loop_build.
extern "C" int pw_chunk_loop_new(void** loop_out, unsigned long long* handle_out) {
  ChunkLoop* loop = new ChunkLoop();
  cudaError_t err = cudaGraphCreate(&loop->graph, 0);
  if (err == cudaSuccess)
    err = cudaGraphConditionalHandleCreate(&loop->handle, loop->graph, 1, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) {
    if (loop->graph) cudaGraphDestroy(loop->graph);
    delete loop;
    return static_cast<int>(err);
  }
  *loop_out = loop;
  *handle_out = loop->handle;
  return 0;
}

// Builds and instantiates the outer graph around `body` (a CUgraph, cloned
// into the WHILE node's body as a child graph).  remaining: the int32
// countdown (the first word of the loop's scalars) on the device.
extern "C" int pw_chunk_loop_build(void* loop_ptr, void* body, void* remaining, int bound_value) {
  ChunkLoop* loop = static_cast<ChunkLoop*>(loop_ptr);
  if (loop->exec || bound_value < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaGraphNode_t set_bound, while_node, child;
  cudaMemsetParams p = scalar_memset(remaining, static_cast<unsigned int>(bound_value));
  cudaError_t err = cudaGraphAddMemsetNode(&set_bound, loop->graph, nullptr, 0, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams cond = {};
  cond.type = cudaGraphNodeTypeConditional;
  cond.conditional.handle = loop->handle;
  cond.conditional.type = cudaGraphCondTypeWhile;
  cond.conditional.size = 1;
  err = cudaGraphAddNode(&while_node, loop->graph, &set_bound, 1, &cond);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGraphAddChildGraphNode(&child, cond.conditional.phGraph_out[0], nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGraphInstantiate(&loop->exec, loop->graph, 0);
  if (err != cudaSuccess) {
    loop->exec = nullptr;
    return static_cast<int>(err);
  }
  loop->bound_node = set_bound;
  loop->remaining = static_cast<int*>(remaining);
  loop->bound_value = bound_value;
  return 0;
}

// One launch of the loop on `stream`: at most `bound` bodies.
extern "C" int pw_chunk_loop_launch(void* loop_ptr, int bound, void* stream) {
  ChunkLoop* loop = static_cast<ChunkLoop*>(loop_ptr);
  if (!loop->exec || bound < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bound != loop->bound_value) {
    cudaMemsetParams p = scalar_memset(loop->remaining, static_cast<unsigned int>(bound));
    cudaError_t err = cudaGraphExecMemsetNodeSetParams(loop->exec, loop->bound_node, &p);
    if (err != cudaSuccess) return static_cast<int>(err);
    loop->bound_value = bound;
  }
  return static_cast<int>(cudaGraphLaunch(loop->exec, static_cast<cudaStream_t>(stream)));
}

// Frees the loop's executable and graph.  The caller has waited for its
// last launch.
extern "C" int pw_chunk_loop_free(void* loop_ptr) {
  ChunkLoop* loop = static_cast<ChunkLoop*>(loop_ptr);
  cudaError_t err = cudaSuccess;
  if (loop->exec) err = cudaGraphExecDestroy(loop->exec);
  cudaError_t err2 = cudaGraphDestroy(loop->graph);
  delete loop;
  return static_cast<int>(err != cudaSuccess ? err : err2);
}
