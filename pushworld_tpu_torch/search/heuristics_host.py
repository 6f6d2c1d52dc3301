"""Exact host implementations of the movement graphs and the RGD heuristic.

The port's copy of the parts of the JAX package's
``search/heuristics_host.py`` that the port needs: the feasible movement
graphs (the table builder's ``E``) and ``RecursiveGraphDistance`` (for
``search.batched.required_depth``).  Semantics mirror the reference C++
heuristics:

- feasible movement graphs — reference: cpp/src/heuristics/
  domain_transition_graph.cc:113-216 (fixpoint over dependent transitions),
- lazy per-target path distances — domain_transition_graph.cc:218-300,
- recursive graph distance (RGD) — recursive_graph_distance.cc:43-252.
"""

import math
from collections import deque
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from pushworld_tpu_torch.core.compiled import CompiledPuzzle, compile_puzzle
from pushworld_tpu_torch.core.puzzle import AGENT_IDX, NUM_ACTIONS, Actions, Puzzle

INF = math.inf

Point = Tuple[int, int]


class MovementGraphs:
    """Per-object feasible movement graphs.

    A transition (object o at p -> p + d_a) is *feasible* iff p is reachable
    for o, the move has no static collision, and (for o != agent) some other
    object q has a feasible transition that pushes o from a contact offset.
    The graphs over-approximate the motions reachable from the initial state.

    Attributes:
        edges: per object, dict position -> set of successor positions.
                Every reached position has an entry (possibly empty).
    """

    def __init__(self, puzzle: Puzzle, compiled: Optional[CompiledPuzzle] = None):
        cp = compiled if compiled is not None else compile_puzzle(puzzle)
        n = puzzle.num_movables
        self.num_movables = n
        sb = np.asarray(cp.static_block)  # (4, N, H, W)
        push = np.asarray(cp.push)  # (4, N, N, K, K)
        delta = cp.delta
        disp = Actions.DISPLACEMENTS

        # Sparse pusher-contact offsets: offsets[a][o] = list of (q, (rx, ry))
        # where q at pos_o + (rx, ry) pushes o when moving in direction a.
        offsets: List[List[List[Tuple[int, Point]]]] = [
            [[] for _ in range(n)] for _ in range(NUM_ACTIONS)
        ]
        # Pushee lists per pusher: pushees[a][q] = list of (o, (rx, ry)).
        pushees: List[List[List[Tuple[int, Point]]]] = [
            [[] for _ in range(n)] for _ in range(NUM_ACTIONS)
        ]
        for a in range(NUM_ACTIONS):
            for q in range(n):
                for o in range(1, n):
                    if q == o:
                        continue
                    ys, xs = np.nonzero(push[a, q, o])
                    for ry, rx in zip(ys - delta, xs - delta):
                        offsets[a][o].append((q, (int(rx), int(ry))))
                        pushees[a][q].append((o, (int(rx), int(ry))))
        self._offsets = offsets
        self._pushees = pushees
        self._sb = sb
        self._disp = disp

        self.edges: List[Dict[Point, Set[Point]]] = [dict() for _ in range(n)]

        # Worklist fixpoint.  Two event kinds:
        #   ("pos", o, p)        — position p newly reached for object o
        #   ("edge", q, p, a)    — transition (q, p -> p + d_a) newly feasible
        work = deque()
        for i, p in enumerate(puzzle.initial_state):
            self.edges[i][p] = set()
            work.append(("pos", i, p))

        def blocked(o: int, a: int, p: Point) -> bool:
            return bool(sb[a, o, p[1], p[0]])

        def has_pusher(o: int, a: int, p: Point) -> bool:
            for q, (rx, ry) in offsets[a][o]:
                start = (p[0] + rx, p[1] + ry)
                succ = self.edges[q].get(start)
                if succ is not None:
                    end = (start[0] + disp[a][0], start[1] + disp[a][1])
                    if end in succ:
                        return True
            return False

        def add_edge(o: int, p: Point, a: int) -> None:
            end = (p[0] + disp[a][0], p[1] + disp[a][1])
            succ = self.edges[o].setdefault(p, set())
            if end in succ:
                return
            succ.add(end)
            work.append(("edge", o, p, a))
            if end not in self.edges[o]:
                self.edges[o][end] = set()
                work.append(("pos", o, end))

        while work:
            ev = work.popleft()
            if ev[0] == "pos":
                _, o, p = ev
                for a in range(NUM_ACTIONS):
                    if blocked(o, a, p):
                        continue
                    if o == AGENT_IDX or has_pusher(o, a, p):
                        add_edge(o, p, a)
            else:
                _, q, p, a = ev
                # This new pusher transition may enable pushee transitions.
                for o, (rx, ry) in pushees[a][q]:
                    pushee_pos = (p[0] - rx, p[1] - ry)
                    if pushee_pos in self.edges[o] and not blocked(o, a, pushee_pos):
                        add_edge(o, pushee_pos, a)

    def successors(self, o: int, p: Point) -> Set[Point]:
        return self.edges[o][p]


class PathDistances:
    """Lazy graph distances ``dist(source -> target)`` for one object's
    movement graph, computed by BFS over reversed edges per target and cached.
    reference semantics: domain_transition_graph.cc:218-300."""

    def __init__(self, edges: Dict[Point, Set[Point]]):
        self._redges: Dict[Point, List[Point]] = {p: [] for p in edges}
        for p, succ in edges.items():
            for q in succ:
                self._redges.setdefault(q, []).append(p)
        self._dist: Dict[Point, Dict[Point, float]] = {}

    def get(self, source: Point, target: Point) -> float:
        if target not in self._redges:
            return INF
        d = self._dist.get(target)
        if d is None:
            d = {target: 0.0}
            frontier = deque([target])
            while frontier:
                p = frontier.popleft()
                for q in self._redges.get(p, ()):
                    if q not in d:
                        d[q] = d[p] + 1.0
                        frontier.append(q)
            self._dist[target] = d
        return d.get(source, INF)


class RecursiveGraphDistance:
    """The RGD heuristic.  reference: recursive_graph_distance.cc:43-252.

    Only the per-depth goal cost (``_goal_cost``) is kept: it is what
    ``search.batched.required_depth`` evaluates at depths 0, 1, ...
    """

    def __init__(
        self,
        puzzle: Puzzle,
        compiled: Optional[CompiledPuzzle] = None,
    ):
        self.puzzle = puzzle
        cp = compiled if compiled is not None else compile_puzzle(puzzle)
        self.cp = cp
        self.graphs = MovementGraphs(puzzle, cp)
        self.distances = [PathDistances(e) for e in self.graphs.edges]
        self._push_cost_cache: Dict[tuple, Dict[Point, float]] = {}
        # Sparse contact offsets per (action, pusher, pushee).
        push = np.asarray(cp.push)
        delta = cp.delta
        n = puzzle.num_movables
        self._contacts: Dict[Tuple[int, int, int], List[Point]] = {}
        for a in range(NUM_ACTIONS):
            for q in range(n):
                for o in range(1, n):
                    if q == o:
                        continue
                    ys, xs = np.nonzero(push[a, q, o])
                    if len(ys):
                        self._contacts[(a, q, o)] = [
                            (int(rx), int(ry))
                            for ry, rx in zip(ys - delta, xs - delta)
                        ]

    # -------------------------------------------------------------- internal

    def _goal_cost(self, state, object_id, goal_position, pushing_depth) -> float:
        current = state[object_id]
        if goal_position == current:
            return 0.0
        min_cost = INF
        for effect in self.graphs.successors(object_id, current):
            goal_dist = self.distances[object_id].get(effect, goal_position)
            if goal_dist >= min_cost:
                continue
            min_cost = goal_dist + self._recursive_pushing_cost(
                state,
                object_id,
                current,
                effect,
                frozenset(),
                pushing_depth,
                min_cost - goal_dist,
            )
        return min_cost

    def _recursive_pushing_cost(
        self,
        state,
        object_id: int,
        current: Point,
        effect: Point,
        skipped: FrozenSet[int],
        pushing_depth: int,
        cost_upper_bound: float,
    ) -> float:
        """Minimum cost for some pusher chain (of exactly ``pushing_depth``
        tools below the agent) to realize the transition current -> effect
        of ``object_id``, bounded above by ``cost_upper_bound``."""
        min_cost = cost_upper_bound
        next_skipped = skipped | {object_id}

        if pushing_depth == 0:
            pusher_ids = (AGENT_IDX,)
        else:
            pusher_ids = range(1, len(state))

        for pusher_id in pusher_ids:
            if pusher_id in next_skipped:
                continue
            pusher_position = state[pusher_id]
            pushing_costs = self._pushing_costs(
                pusher_id, pusher_position, object_id, current, effect
            )
            for pusher_next, dist_cost in pushing_costs.items():
                if dist_cost >= min_cost:
                    continue
                if pusher_id == AGENT_IDX:
                    # Direct push: +1 for the pushing action itself.
                    total = dist_cost + 1.0
                    if total < min_cost:
                        min_cost = total
                else:
                    min_cost = dist_cost + self._recursive_pushing_cost(
                        state,
                        pusher_id,
                        pusher_position,
                        pusher_next,
                        next_skipped,
                        pushing_depth - 1,
                        min_cost - dist_cost,
                    )
        return min_cost

    def _pushing_costs(
        self,
        pusher_id: int,
        pusher_position: Point,
        pushee_id: int,
        pushee_start: Point,
        pushee_end: Point,
    ) -> Dict[Point, float]:
        """Map from the pusher's next positions to the min cost of reaching a
        contact from which it pushes ``pushee_id`` along start -> end.
        A simultaneous push (contact == pusher's current position and the
        pushing move == that next position) costs 0.
        reference: recursive_graph_distance.cc:176-252."""
        key = (pusher_id, pusher_position, pushee_id, pushee_start, pushee_end)
        cached = self._push_cost_cache.get(key)
        if cached is not None:
            return cached

        costs: Dict[Point, float] = {}
        d = (pushee_end[0] - pushee_start[0], pushee_end[1] - pushee_start[1])
        action = Actions.DISPLACEMENTS.index(d)
        pusher_edges = self.graphs.edges[pusher_id]
        pusher_next_positions = pusher_edges[pusher_position]
        dist = self.distances[pusher_id]

        for rx, ry in self._contacts.get((action, pusher_id, pushee_id), ()):
            contact = (pushee_start[0] + rx, pushee_start[1] + ry)
            contact_end = (contact[0] + d[0], contact[1] + d[1])
            succ = pusher_edges.get(contact)
            if succ is None or contact_end not in succ:
                continue  # the pushing move itself is infeasible
            for pusher_next in pusher_next_positions:
                if contact == pusher_position and contact_end == pusher_next:
                    dist_cost = 0.0  # simultaneous push
                else:
                    dc = dist.get(pusher_next, contact)
                    if dc == INF:
                        continue
                    dist_cost = dc + 1.0  # +1 for the first transition
                prev = costs.get(pusher_next)
                if prev is None or dist_cost < prev:
                    costs[pusher_next] = dist_cost

        self._push_cost_cache[key] = costs
        return costs
