"""Search chunks on the card as device-side loops.

The JAX package runs a chunk as one jitted program: ``lax.fori_loop(0,
chunk, body)``, each iteration gated by ``lax.cond`` on ``active``
(pushworld_tpu/search/batched.py:625-656).  Here a search iteration is eight
launches of hand kernels that read nothing back (``search/batched.py``
``_iterate``), and a chunk is a CUDA graph that loops on the card
(``kernels/chunk_loop.cu``):

- One gated iteration is captured once into a ``torch.cuda.CUDAGraph``
  (``keep_graph=True``: PyTorch's allocator keeps the iteration's
  temporaries in the graph's pool).  Its novelty, RGD and compaction
  kernels are three branches after the dedup (``batched._branches``), so
  the body's 8 kernel nodes form a longest dependent chain of 6.  That graph
  is the body of a conditional WHILE node of an outer graph, whose one
  memset node sets the loop's countdown to its bound at each launch.
- The loop's tail, in the append kernel (``kernels/frontier.cu``), ends the
  loop when this iteration's gate was closed, the search is solved, the
  history is full or the countdown has run out.  So a launch of bound ``k``
  runs the iterations that JAX's ``fori_loop`` of ``k`` runs with the gate
  open, plus at most one closed body (after a frontier that emptied), and a
  launch on a search that has ended runs one closed body.  A closed
  iteration is an exact no-op: each kernel reads the gate on the device and
  returns (the append's tail still runs).
- A chunk of ``k`` iterations is ``ceil(k / LOOP_MAX)`` launches, each of at
  most :data:`LOOP_MAX` (JAX's chunk of 128) iterations.
- Before the capture, one iteration runs on the capture stream with the
  gate closed (an exact no-op), its branches on the same side streams as
  the capture's: the ctypes kernel libraries are loaded, any
  ``cudaFuncSetAttribute`` has run, and PyTorch's lazy initialisations (the
  allocator's pools of each stream among them) are done, none of which may
  happen during a capture.
- The capture uses ``capture_error_mode="thread_local"``: the fleet's device
  worker captures while native workers and the portfolio's table prefetch
  run in other threads.  Its streams are the capturing thread's own
  (``batched.thread_streams``).
- Graphs may share a memory pool (``pool``): the fleet's lanes of one wave
  do.  Their loops run on one stream, one after another, and a body's
  temporaries are dead once it ends.
- A loop belongs to its search state (``SearchState.graph``) and is
  released with it; a state, tables or configuration it was not captured
  for (an escalation to a deeper RGD depth starts a new state) captures
  anew.
- Launch counts: a capture launches nothing, so the wrappers' counts are
  recorded during it (``kernels.recording_launches``: the body's launches).
  The loop counts the bodies it runs on the device, and
  ``kernels.settle_launches()`` (or the loop's release) adds bodies x the
  body's launches to ``kernels.LAUNCHES``.

Nothing falls back: a failed capture, build or launch raises.
"""

import ctypes
import dataclasses
import sys
import threading
import time
from collections import Counter, deque
from typing import Dict, Optional, Tuple

import torch

from pushworld_tpu_torch import kernels
from pushworld_tpu_torch.core.compiled import CompiledPuzzle
from pushworld_tpu_torch.kernels import _build
from pushworld_tpu_torch.ops.rgd import RGDTables
from pushworld_tpu_torch.search.batched import CHUNK, SearchConfig, SearchState, _iterate, thread_streams
from pushworld_tpu_torch.utils import tracing

# Iterations of one launch of a loop: JAX's chunk.
LOOP_MAX = CHUNK

# CUgraphNodeType, by value (cuda.h).
_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event", "event_record",
               "ext_semaphore_signal", "ext_semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op",
               "conditional")


def chunk_continue_reference(gate, solved, hist_cursor, remaining, limit: int):
    """Plain version of the loop's tail (``frontier.cu``'s ``loop_tail``, at
    the end of the append): whether the loop runs another body after this
    one, and the countdown after it.  ``gate`` and ``solved`` are bool
    tensors, ``hist_cursor`` and ``remaining`` int32 tensors (any matching
    shapes); ``remaining`` counts this body, so a launch of bound ``b``
    starts it at ``b``."""
    remaining = remaining - 1
    return gate & ~solved & (hist_cursor < limit) & (remaining > 0), remaining


def chunk_continue(gate, solved, hist_cursor, remaining, limit: int, flag, bodies) -> None:
    """The loop's tail on its scalars, in place, in plain PyTorch on any
    device (the card runs it inside the append kernel):
    ``remaining`` - 1, ``flag`` = whether the loop goes on, ``bodies`` + 1."""
    c, left = chunk_continue_reference(gate, solved, hist_cursor, remaining, limit)
    remaining.copy_(left)
    flag.copy_(c)
    bodies.add_(1)


@dataclasses.dataclass(frozen=True)
class LoopTail:
    """A device-side loop's scalars, which the append's tail updates
    (``batched.append_children``'s ``loop``): ``scalars``, one (2,) int64
    tensor laid out as ``frontier.cu``'s ``LoopScalars`` (the countdown
    ``remaining``, int32 at bytes 0-3; ``flag``, int32 at bytes 4-7;
    ``bodies``, int64 at bytes 8-15); ``limit``, the history cursor's limit
    of an active iteration; ``handle``, the loop's condition (0: none)."""

    scalars: torch.Tensor
    limit: int
    handle: int = 0

    @staticmethod
    def new(device, cfg: SearchConfig, remaining: int = 0, handle: int = 0) -> "LoopTail":
        scalars = torch.zeros((2,), dtype=torch.int64, device=device)
        scalars.view(torch.int32)[0] = remaining
        return LoopTail(scalars, cfg.history_capacity - 8 * cfg.expand, handle)

    @property
    def remaining(self) -> torch.Tensor:
        return self.scalars.view(torch.int32)[0]

    @property
    def flag(self) -> torch.Tensor:
        return self.scalars.view(torch.int32)[1]

    @property
    def bodies(self) -> torch.Tensor:
        return self.scalars[1]


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def _buffers(s: SearchState):
    """Data pointers of every tensor of the state (the addresses a graph
    writes)."""
    return [
        v.data_ptr()
        for v in (
            s.frontier_states, s.frontier_h, s.frontier_hist, s.frontier_key, s.ring_cursor,
            s.hist_parent, s.hist_action, s.hist_cursor, s.visited.keys, s.novelty.seen_pos,
            s.novelty.pair_table, s.solved, s.solved_hist, s.iterations, s.expansions,
            s.evictions, s.needs_deeper,
        )
    ]


def _graph_shape(graph: int) -> Tuple[Dict[str, int], int]:
    """Node counts by type of a CUDA graph, and its longest dependent chain
    counted in kernel nodes (``cuGraphGetNodes``, ``cuGraphNodeGetType``
    and ``cuGraphGetEdges`` of libcuda)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    get_nodes, get_type, get_edges = cuda.cuGraphGetNodes, cuda.cuGraphNodeGetType, cuda.cuGraphGetEdges
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    get_type.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    get_edges.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    _check(get_nodes(ctypes.c_void_p(graph), None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(get_nodes(ctypes.c_void_p(graph), nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kinds = {}
    for node in nodes[: n.value]:
        t = ctypes.c_int(-1)
        _check(get_type(ctypes.c_void_p(node), ctypes.byref(t)), "cuGraphNodeGetType")
        kinds[node] = _NODE_TYPES[t.value] if 0 <= t.value < len(_NODE_TYPES) else str(t.value)
    e = ctypes.c_size_t(0)
    _check(get_edges(ctypes.c_void_p(graph), None, None, ctypes.byref(e)), "cuGraphGetEdges")
    src, dst = (ctypes.c_void_p * e.value)(), (ctypes.c_void_p * e.value)()
    _check(get_edges(ctypes.c_void_p(graph), src, dst, ctypes.byref(e)), "cuGraphGetEdges")
    preds = {node: [] for node in kinds}
    for a, b in zip(src[: e.value], dst[: e.value]):
        preds[b].append(a)
    chain: Dict[int, int] = {}  # kernel nodes on the longest chain ending at a node

    def longest(node):
        if node not in chain:
            chain[node] = (kinds[node] == "kernel") + max((longest(p) for p in preds[node]), default=0)
        return chain[node]

    return dict(Counter(kinds.values())), max((longest(node) for node in kinds), default=0)


class ChunkGraph:
    """A device-side loop over one gated iteration of a search state.

    Attributes: ``nodes``, ``node_types`` and ``longest_chain`` (of the
    captured body: its node count, its node counts by type and its longest
    dependent chain in kernel nodes), ``capture_s`` and ``instantiate_s``
    (host seconds; the latter builds the loop around the body; under
    ``torch.profiler`` the span ``pw.solve.capture`` holds both and the
    warm iteration),
    ``launches`` (hand-kernel launches of one body), ``tail`` (the loop's
    :class:`LoopTail`) and ``bodies`` (its int64 device scalar: bodies
    run)."""

    def __init__(self, cp: CompiledPuzzle, tables: RGDTables, cfg: SearchConfig,
                 s: SearchState, pool=None):
        self.key = (id(cp), id(tables), cfg)
        self._refs = (cp, tables)  # the graph reads their memory by address
        self._lib = _build.load("chunk_loop")
        self._loop: Optional[int] = None
        self._last: Optional[torch.cuda.Event] = None
        self._settled = 0
        self._lock = threading.Lock()
        dev = s.frontier_h.device
        # The span holds the warm iteration, the capture and the loop's build;
        # it is a host range around the capture, none inside it.
        with tracing.span("pw.solve.capture"), torch.cuda.device(dev):
            main = torch.cuda.current_stream()
            side = thread_streams(dev)[0]
            side.wait_stream(main)
            with torch.cuda.stream(side):
                closed = dataclasses.replace(s, solved=torch.ones((), dtype=torch.bool, device=dev))
                warm = LoopTail.new(dev, cfg, remaining=1)
                _iterate(cp, tables, cfg, closed, warm)
            main.wait_stream(side)

            loop, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
            _check(self._lib.pw_chunk_loop_new(ctypes.byref(loop), ctypes.byref(handle)), "pw_chunk_loop_new")
            self._loop = loop.value
            if not handle.value:  # the tail would leave the condition at its default: no end
                raise RuntimeError("pw_chunk_loop_new gave a null condition handle")
            self.tail = LoopTail.new(dev, cfg, handle=handle.value)
            self.bodies = self.tail.bodies
            before = _buffers(s)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.monotonic()
            with torch.cuda.stream(side), kernels.recording_launches() as recorded:
                self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    _iterate(cp, tables, cfg, s, self.tail)
                finally:
                    self.graph.capture_end()
            self.capture_s = time.monotonic() - t0
            if _buffers(s) != before:
                raise RuntimeError("the captured iteration rebound a search-state tensor")
            self.launches = dict(recorded)
            body = self.graph.raw_cuda_graph()
            self.node_types, self.longest_chain = _graph_shape(body)
            self.nodes = sum(self.node_types.values())
            t0 = time.monotonic()
            rc = self._lib.pw_chunk_loop_build(self._loop, body, self.tail.scalars.data_ptr(), LOOP_MAX)
            _check(rc, f"pw_chunk_loop_build (body nodes {self.node_types})")
            self.instantiate_s = time.monotonic() - t0
        kernels.track_unsettled(self)

    def replay(self, bound: int) -> torch.cuda.Event:
        """Enqueues one launch of the loop, at most ``bound`` iterations, on
        the current stream; returns an event recorded after it."""
        _check(kernels.launch_on(self.bodies.device, self._lib.pw_chunk_loop_launch, self._loop, bound),
               "pw_chunk_loop_launch")
        self._last = torch.cuda.Event()
        self._last.record()
        return self._last

    def settle(self) -> None:
        """Waits for the last launch and adds the kernels of the bodies run
        since the last settle to ``kernels.LAUNCHES``."""
        with self._lock:
            if self._last is not None:
                self._last.synchronize()
            n = int(self.bodies)
            if n > self._settled:
                for name, k in self.launches.items():
                    kernels.count_launch(name, k * (n - self._settled))
                self._settled = n

    def __del__(self):
        # The executable and the graph's pool go with this object: let its
        # last launch finish and settle its count first.  (Released during a
        # capture on this thread, which no caller does, it cannot read its
        # count, and its unsettled bodies go uncounted.)
        if getattr(self, "_loop", None) is None or sys.is_finalizing():
            return
        if hasattr(self, "launches") and not torch.cuda.is_current_stream_capturing():
            self.settle()
        elif self._last is not None:
            self._last.synchronize()
        self._lib.pw_chunk_loop_free(self._loop)
        self._loop = None


def attach(cp: CompiledPuzzle, tables: RGDTables, cfg: SearchConfig, s: SearchState,
           pool=None) -> ChunkGraph:
    """The state's loop for (cp, tables, cfg), captured now if it has none
    (or one captured for something else)."""
    g = s.graph
    if g is None or g.key != (id(cp), id(tables), cfg):
        s.graph = None  # the old loop goes before the new one is captured
        g = s.graph = ChunkGraph(cp, tables, cfg, s, pool)
    return g


def run_graphed(cp: CompiledPuzzle, tables: RGDTables, cfg: SearchConfig, s: SearchState,
                chunk: int, deadline: Optional[float]) -> SearchState:
    """:func:`search.batched.run_chunk` on the card (see there)."""
    g = attach(cp, tables, cfg, s)
    bounds = (min(LOOP_MAX, chunk - start) for start in range(0, chunk, LOOP_MAX))
    with torch.cuda.device(s.frontier_h.device):
        if deadline is None:
            for bound in bounds:
                g.replay(bound)
            return s
        unconfirmed = deque()
        for bound in bounds:
            if len(unconfirmed) == 2:
                unconfirmed.popleft().synchronize()
            if time.monotonic() > deadline:
                break
            unconfirmed.append(g.replay(bound))
    return s
