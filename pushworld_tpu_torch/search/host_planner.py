"""Host greedy best-first planner (exact reference semantics).

This is the single-state analog of the reference C++ planner (reference:
cpp/include/search/best_first_search.h:45-98, cpp/src/run_planner.cc:37-61):
greedy best-first search ordered purely by heuristic value, expanding the 4
actions in deterministically pre-shuffled order, deduplicating via a visited
set, returning the first plan that reaches the goal.

It serves as (a) a correctness oracle for the batched device planner and
(b) the fallback planning path on hosts without an accelerator.  Unlike the
reference it stores the generating action in each node, so plans are
recovered by backtracking without re-simulation (reference re-simulates:
cpp/src/search/search.cc:25-54).
"""

import heapq
import itertools
import random
import time
from typing import List, Optional, Tuple

from pushworld_tpu_torch.core.compiled import CompiledPuzzle, compile_puzzle
from pushworld_tpu_torch.core.puzzle import NUM_ACTIONS, Puzzle
from pushworld_tpu_torch.search.heuristics_host import (
    NoveltyHeuristic,
    RecursiveGraphDistance,
)

# Lexicographic stacking weight for novelty over RGD (reference:
# run_planner.cc:48-55: max novelty is 3, so 1e6 keeps float precision).
NOVELTY_WEIGHT = 1e6


class RandomActionOrder:
    """Deterministically pre-shuffled action orders, cycled per expansion.
    reference semantics: cpp/src/search/random_action_iterator.cc:26-51
    (1000 fixed-seed permutations of the 4 actions)."""

    def __init__(self, num_permutations: int = 1000, seed: int = 42):
        rng = random.Random(seed)
        base = list(range(NUM_ACTIONS))
        self._perms = []
        for _ in range(num_permutations):
            perm = base[:]
            rng.shuffle(perm)
            self._perms.append(tuple(perm))
        self._it = itertools.cycle(self._perms)

    def next(self) -> Tuple[int, ...]:
        return next(self._it)


def best_first_search(
    puzzle: Puzzle,
    heuristic_fn,
    max_expansions: Optional[int] = None,
    deadline: Optional[float] = None,
) -> Optional[List[int]]:
    """Greedy best-first search.

    ``heuristic_fn(state, moved_indices) -> float`` is called once per
    generated state (novelty-style heuristics mutate on call).
    Returns a plan (list of actions), or None if no solution exists, or
    raises TimeoutError when the deadline/expansion budget is exhausted.
    """
    initial = puzzle.initial_state
    if puzzle.is_goal_state(initial):
        return []

    actions_order = RandomActionOrder()
    visited = {initial}
    # Node = (state, parent_node, action); heap entries (h, tiebreak, node).
    counter = itertools.count()
    root = (initial, None, None)
    h0 = heuristic_fn(initial, list(range(len(initial))))
    frontier = [(h0, next(counter), root)]
    expansions = 0

    while frontier:
        if max_expansions is not None and expansions >= max_expansions:
            raise TimeoutError("expansion budget exhausted")
        if deadline is not None and expansions % 256 == 0 and time.monotonic() > deadline:
            raise TimeoutError("time budget exhausted")
        _, _, parent = heapq.heappop(frontier)
        parent_state = parent[0]
        expansions += 1

        for action in actions_order.next():
            state = puzzle.get_next_state(parent_state, action)
            if state in visited:
                continue
            node = (state, parent, action)
            if puzzle.is_goal_state(state):
                plan = []
                while node[2] is not None:
                    plan.append(node[2])
                    node = node[1]
                plan.reverse()
                return plan
            moved = [
                i for i in range(len(state)) if state[i] != parent_state[i]
            ]
            h = heuristic_fn(state, moved)
            heapq.heappush(frontier, (h, next(counter), node))
            visited.add(state)

    return None


def solve_host(
    puzzle: Puzzle,
    mode: str = "N+RGD",
    compiled: Optional[CompiledPuzzle] = None,
    max_expansions: Optional[int] = None,
    time_limit: Optional[float] = None,
) -> Optional[List[int]]:
    """Solves a puzzle with the given heuristic mode ("RGD" or "N+RGD").
    reference: run_planner.cc:37-61."""
    cp = compiled if compiled is not None else compile_puzzle(puzzle)
    rgd = RecursiveGraphDistance(puzzle, cp)

    if mode == "RGD":
        def heuristic_fn(state, moved):
            return rgd.estimate(state)
    elif mode == "N+RGD":
        novelty = NoveltyHeuristic(puzzle.num_movables)

        def heuristic_fn(state, moved):
            return NOVELTY_WEIGHT * novelty.estimate(state, moved) + rgd.estimate(
                state
            )
    else:
        raise ValueError(f"Unrecognized mode: {mode}")

    deadline = None if time_limit is None else time.monotonic() + time_limit
    return best_first_search(
        puzzle, heuristic_fn, max_expansions=max_expansions, deadline=deadline
    )
