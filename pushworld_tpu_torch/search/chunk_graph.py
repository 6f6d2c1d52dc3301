"""Search chunks on the card as CUDA graphs.

The JAX package needs no counterpart: ``jit`` makes its ``run_chunk`` one
program, enqueued at once.  Here a search iteration is nine launches of hand
kernels (PERF.md §5), and when the host launches them one by one its launch
time is most of an iteration.  The iteration reads nothing back
(``search/batched.py``), so ``G`` gated iterations are captured once into
one ``torch.cuda.CUDAGraph`` and a chunk is ``ceil(chunk / G)`` replays of
it.

An iteration whose gate is closed (after a solve, an exhaustion or a full
history) is a no-op: each of its kernels reads the gate on the device and
returns at once.  It still costs its nine launches, since the PyTorch this
runs on has no conditional graph nodes (JAX's ``lax.cond``).  So a chunk on
the card is short (:data:`GRAPH_ITERS` iterations, one replay), and a search
that has ended wastes at most the chunks its caller has in flight.

- ``G`` is chosen per RGD depth (:data:`GRAPH_ITERS`).
- Before the capture, one iteration runs on a side stream with the gate
  closed (an exact no-op): the ctypes kernel libraries are loaded, any
  ``cudaFuncSetAttribute`` has run, and PyTorch's lazy initialisations are
  done, none of which may happen during a capture.
- The capture uses ``capture_error_mode="thread_local"``: the fleet's device
  worker captures while native workers and the portfolio's table prefetch
  run in other threads.
- Graphs may share a memory pool (``pool``): the fleet's lanes of one wave
  do.  Their replays run on one stream, one after another, and a graph's
  temporaries are dead once its replay ends.
- A graph belongs to its search state (``SearchState.graph``) and is
  released with it; a state, tables or configuration it was not captured
  for (an escalation to a deeper RGD depth starts a new state) captures
  anew.
- Launch counts: a capture launches nothing, so the wrappers' counts are
  recorded during it (``kernels.recording_launches``) and added to
  ``kernels.LAUNCHES`` at every replay.

Nothing falls back: a failed capture or replay raises.
"""

import ctypes
import dataclasses
import time
from collections import deque
from typing import Dict, Optional

import torch

from pushworld_tpu_torch import kernels
from pushworld_tpu_torch.core.compiled import CompiledPuzzle
from pushworld_tpu_torch.ops.rgd import RGDTables
from pushworld_tpu_torch.search.batched import SearchConfig, SearchState, _iterate

# Iterations in one graph, by RGD depth (depths above 3 use 3's), and the
# length of a chunk on the card where the caller leaves it to the depth.
# At production capacities an active iteration is 0.037-0.041 ms of device
# time at depths 0-3 and a closed one 0.0107-0.0115 ms, about 1/3.5 of it
# (scripts/profile_search.py on an H100, PERF.md §5).  A replay in flight
# after a search's end wastes up to G - 1 closed iterations, and the chunk
# length rises only where a closed iteration costs at most 1/8 of an active
# one (PERF.md §6): nine launches cannot, since 1/8 of an active iteration
# is under six launch floors.  So a graph holds one or two iterations.
GRAPH_ITERS: Dict[int, int] = {0: 2, 1: 1, 2: 1, 3: 1}


def graph_iters(depth: int) -> int:
    return GRAPH_ITERS[min(depth, 3)]


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


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """Node count of a captured graph (``cuGraphGetNodes`` of libcuda)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    fn = cuda.cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = fn(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {rc}")
    return int(n.value)


class ChunkGraph:
    """``G`` gated iterations of one search state, captured as a CUDA graph.

    Attributes: ``iters`` (G), ``nodes`` (of the graph), ``capture_s`` and
    ``instantiate_s`` (host seconds), ``launches`` (hand-kernel launches of
    one replay)."""

    def __init__(self, cp: CompiledPuzzle, tables: RGDTables, cfg: SearchConfig,
                 s: SearchState, pool=None):
        self.key = (id(cp), id(tables), cfg)
        self._refs = (cp, tables)  # the graph reads their memory by address
        self.iters = graph_iters(cfg.max_depth)
        dev = s.frontier_h.device
        with torch.cuda.device(dev):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                closed = dataclasses.replace(s, solved=torch.ones((), dtype=torch.bool, device=dev))
                _iterate(cp, tables, cfg, closed)
            main.wait_stream(side)

            before = _buffers(s)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.monotonic()
            with torch.cuda.stream(side), kernels.recording_launches() as recorded:
                self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    for _ in range(self.iters):
                        _iterate(cp, tables, cfg, s)
                finally:
                    self.graph.capture_end()
            self.capture_s = time.monotonic() - t0
            if _buffers(s) != before:
                raise RuntimeError("the captured iteration rebound a search-state tensor")
            self.launches = dict(recorded)
            self.nodes = _graph_nodes(self.graph)
            t0 = time.monotonic()
            self.graph.instantiate()
            self.instantiate_s = time.monotonic() - t0
        self._last: Optional[torch.cuda.Event] = None

    def replay(self) -> torch.cuda.Event:
        """Enqueues one replay on the current stream; returns an event
        recorded after it."""
        self.graph.replay()
        for name, n in self.launches.items():
            kernels.count_launch(name, n)
        self._last = torch.cuda.Event()
        self._last.record()
        return self._last

    def __del__(self):
        # The graph's executable and pool go with this object: let its last
        # replay finish first.
        if getattr(self, "_last", None) is not None:
            self._last.synchronize()


def attach(cp: CompiledPuzzle, tables: RGDTables, cfg: SearchConfig, s: SearchState,
           pool=None) -> ChunkGraph:
    """The state's graph for (cp, tables, cfg), captured now if it has none
    (or one captured for something else)."""
    g = s.graph
    if g is None or g.key != (id(cp), id(tables), cfg):
        s.graph = None  # the old graph goes before the new one is captured
        g = s.graph = ChunkGraph(cp, tables, cfg, s, pool)
    return g


def run_graphed(cp: CompiledPuzzle, tables: RGDTables, cfg: SearchConfig, s: SearchState,
                chunk: int, deadline: Optional[float]) -> SearchState:
    """:func:`search.batched.run_chunk` on the card (see there)."""
    g = attach(cp, tables, cfg, s)
    replays = -(-chunk // g.iters)
    with torch.cuda.device(s.frontier_h.device):
        if deadline is None:
            for _ in range(replays):
                g.replay()
            return s
        unconfirmed = deque()
        for _ in range(replays):
            if len(unconfirmed) == 2:
                unconfirmed.popleft().synchronize()
            if time.monotonic() > deadline:
                break
            unconfirmed.append(g.replay())
    return s
