"""PDDL export for third-party classical planners.

The port's copy of the JAX package's ``tools/pddl.py``: the same templates
and the same atoms, character for character.

Reproduces the reference's PDDL representation design (reference:
python3/src/pushworld/pddl.py:20-443):

1. one position atom per object, with all pairwise collisions precomputed
   into ``in-collision`` / ``wall-collision`` ground atoms for O(1) checks;
2. chain pushes decomposed into a ``move-agent`` action plus repeated
   ``push`` actions with conditional effects (no derived predicates);
3. a ``for_bfws`` mode that reduces the ``in-collision`` arity from 4 to 3
   via object-pair constants to cap libff memory.

Deviation: the reference accidentally names the domain/problem after the
last movable object (pddl.py:256 shadows the ``name`` argument); here the
puzzle name is used (the names only need to agree between the two files).

Template provenance: the PDDL domain/problem templates below follow the
reference's template text (reference: pddl.py:77-226) nearly verbatim by
design — the PDDL encoding (predicate names, action structure, typing) is
the interchange format that downstream planners (Fast Downward, BFWS/libff)
consume, and the reference's encoding choices were tuned for those
planners' grounders, so diverging would change what is being benchmarked.
The generating code around the templates is an independent implementation.
"""

import itertools
import os
from typing import List, Tuple

from pushworld_tpu_torch import config
from pushworld_tpu_torch.core.puzzle import AGENT_IDX, Puzzle
from pushworld_tpu_torch.utils.filesystem import map_files_with_extension

_DIRECTIONS = ["left", "right", "up", "down"]

_DOMAIN_TEMPLATE = """(define
    (domain {problem_name})
    (:requirements :typing :strips :conditional-effects :negative-preconditions)

    (:types
        position - object
        direction - object
        moveable-object - object
        agent-object - moveable-object
        object-pair - object
    )

    (:constants
        agent - agent-object
        up down left right - direction
        {moveable_objects} - moveable-object
        {object_pair_names}
    )

    (:predicates
        (should-move ?obj - moveable-object ?dir - direction)
        (has-moved ?obj - moveable-object)
        (at ?obj - moveable-object ?pos - position)
        (connected ?from - position ?to - position ?dir - direction)
        (wall-collision ?obj - moveable-object ?next-pos - position)
        {in_collision_predicate}
        {is_pair_predicate}
    )

    (:action move-agent
        :parameters (?dir - direction)
        :precondition (and
{no_objects_should_move}
        )
        :effect (and
            (should-move agent ?dir)
            (forall
                (?obj - moveable-object)
                (not (has-moved ?obj)))
        )
    )

    (:action push
        :parameters ( ?obj - moveable-object ?dir - direction ?pos - position ?next-pos - position
        )
        :precondition (and
            (should-move ?obj ?dir)
            (not (has-moved ?obj))
            (at ?obj ?pos)
            (connected ?pos ?next-pos ?dir)
            (not (wall-collision ?obj ?next-pos))
        )
        :effect (and
            (not (at ?obj ?pos))
            (at ?obj ?next-pos)
            (has-moved ?obj)
            (not (should-move ?obj ?dir))
            (forall (?other-obj - moveable-object)
                (when
                    (and
                        (not (has-moved ?other-obj)){push_condition}
                    )
                    (should-move ?other-obj ?dir)
                )
            )
        )
    )
)"""

_PUSH_CONDITION = """
                        (exists (?other-pos - position)
                            (and
                                (at ?other-obj ?other-pos)
                                (in-collision ?obj ?next-pos ?other-obj ?other-pos)
                            )
                        )
"""

_BFWS_PUSH_CONDITION = """
                        (exists (?pair - object-pair ?other-pos - position)
                            (and
                                (at ?other-obj ?other-pos)
                                (is-pair ?pair ?obj ?other-obj)
                                (in-collision ?pair ?next-pos ?other-pos)
                            )
                        )
"""

_IS_PAIR_PREDICATE = """
        (is-pair
            ?pair - object-pair
            ?obj - moveable-object
            ?other-obj - moveable-object
        )
"""

_IN_COLLISION_PREDICATE = """
        (in-collision
            ?obj - moveable-object
            ?pos - position
            ?other-obj - moveable-object
            ?other-pos - position
        )
"""

_BFWS_IN_COLLISION_PREDICATE = """
        (in-collision
            ?pair - object-pair
            ?pos - position
            ?other-pos - position
        )
"""

_PROBLEM_TEMPLATE = """(define
    (problem {problem_name})
    (:domain {problem_name})

    (:objects
{positions_decl}
    )

    (:init
{initial_object_positions}
{wall_collisions}
        ; The grid of positions; (0, 0) is the top-left content cell.
{position_connections}
        ; All pairwise object collisions at collision-free positions.  The
        ; agent never occurs on the right side: it is always the first pusher.
{object_collisions}
{object_pairs}
    )

    (:goal
        (and
{position_goals}
{no_objects_should_move}
        )
    )
)"""


def _cells_overlap(cells_a, cells_b, offset) -> bool:
    ox, oy = offset
    return any((x + ox, y + oy) in cells_b for x, y in cells_a)


def puzzle_to_pddl(name: str, puzzle: Puzzle, for_bfws: bool = False) -> Tuple[str, str]:
    """Returns (domain, problem) PDDL strings for ``puzzle``."""
    n = puzzle.num_movables
    object_names = ["agent"] + [f"m{i}" for i in range(1, n)]
    moveable_objects = " ".join(object_names[1:])
    width, height = puzzle.dimensions  # includes the 1-cell border

    positions_decl = "\n".join(
        "        "
        + " ".join(f"pos{x}-{y}" for x in range(width - 2))
        + " - position"
        for y in range(height - 2)
    )

    initial_object_positions = "".join(
        f"        (at {object_names[i]} pos{p[0] - 1}-{p[1] - 1})\n"
        for i, p in enumerate(puzzle.initial_state)
    )

    # Wall collisions + collision-free position lists (content coordinates).
    wall_collisions = ""
    free_positions: List[List[Tuple[int, int]]] = []
    sizes = []
    agent_obstacles = puzzle.wall_cells | puzzle.agent_wall_cells
    for i in range(n):
        cells = puzzle.movable_cells[i]
        w_obj = max(x for x, _ in cells) + 1
        h_obj = max(y for _, y in cells) + 1
        sizes.append((w_obj, h_obj))
        obstacles = agent_obstacles if i == AGENT_IDX else puzzle.wall_cells
        obj_free = []
        free_positions.append(obj_free)
        # Deviation from the reference exporter (pddl.py:276-286): positions
        # where a multi-cell object would stick into the outer border are
        # enumerated as wall collisions too — the reference omits them
        # entirely, leaving `push` into such positions unblocked (unsound).
        for x, y in itertools.product(range(width - 2), range(height - 2)):
            out_of_range = x > width - 2 - w_obj or y > height - 2 - h_obj
            if out_of_range or _cells_overlap(cells, obstacles, (x + 1, y + 1)):
                wall_collisions += (
                    f"        (wall-collision {object_names[i]} pos{x}-{y})\n"
                )
            else:
                obj_free.append((x, y))

    position_connections = ""
    for y in range(height - 2):
        for x in range(width - 2):
            if x > 0:
                position_connections += (
                    f"        (connected pos{x}-{y} pos{x - 1}-{y} left)\n"
                )
            if x + 1 < width - 2:
                position_connections += (
                    f"        (connected pos{x}-{y} pos{x + 1}-{y} right)\n"
                )
            if y > 0:
                position_connections += (
                    f"        (connected pos{x}-{y} pos{x}-{y - 1} up)\n"
                )
            if y + 1 < height - 2:
                position_connections += (
                    f"        (connected pos{x}-{y} pos{x}-{y + 1} down)\n"
                )

    collisions: List[str] = []
    for i in range(n):
        for j in range(i + 1, n):
            overlap_cache = {}
            for (xa, ya), (xb, yb) in itertools.product(
                free_positions[i], free_positions[j]
            ):
                off = (xa - xb, ya - yb)
                hit = overlap_cache.get(off)
                if hit is None:
                    hit = _cells_overlap(
                        puzzle.movable_cells[i], puzzle.movable_cells[j], off
                    )
                    overlap_cache[off] = hit
                if not hit:
                    continue
                na, nb = object_names[i], object_names[j]
                if for_bfws:
                    collisions.append(
                        f"(in-collision {na}-{nb} pos{xa}-{ya} pos{xb}-{yb})"
                    )
                else:
                    collisions.append(
                        f"(in-collision {na} pos{xa}-{ya} {nb} pos{xb}-{yb})"
                    )
                if i != AGENT_IDX:
                    if for_bfws:
                        collisions.append(
                            f"(in-collision {nb}-{na} pos{xb}-{yb} pos{xa}-{ya})"
                        )
                    else:
                        collisions.append(
                            f"(in-collision {nb} pos{xb}-{yb} {na} pos{xa}-{ya})"
                        )
    object_collisions = ("\n" + " " * 8).join(collisions)

    position_goals = "".join(
        f"            (at {object_names[k + 1]} pos{x - 1}-{y - 1})\n"
        for k, (x, y) in enumerate(puzzle.goal_state)
    )

    no_objects_should_move = "\n".join(
        f"            (not (should-move {obj} {d}))"
        for obj in object_names
        for d in _DIRECTIONS
    )

    if for_bfws:
        pair_names = [
            f"{a}-{b}" for a in object_names for b in object_names if a != b
        ]
        object_pairs = "\n        ".join(
            f"(is-pair {a}-{b} {a} {b})"
            for a in object_names
            for b in object_names
            if a != b
        )
        object_pair_names = " ".join(pair_names) + " - object-pair"
    else:
        object_pairs = ""
        object_pair_names = ""

    problem_name = name.replace(" ", "_")
    domain = _DOMAIN_TEMPLATE.format(
        problem_name=problem_name,
        moveable_objects=moveable_objects,
        object_pair_names=object_pair_names,
        in_collision_predicate=(
            _BFWS_IN_COLLISION_PREDICATE if for_bfws else _IN_COLLISION_PREDICATE
        ),
        is_pair_predicate=_IS_PAIR_PREDICATE if for_bfws else "",
        no_objects_should_move=no_objects_should_move,
        push_condition=_BFWS_PUSH_CONDITION if for_bfws else _PUSH_CONDITION,
    )
    problem = _PROBLEM_TEMPLATE.format(
        problem_name=problem_name,
        positions_decl=positions_decl,
        initial_object_positions=initial_object_positions,
        wall_collisions=wall_collisions,
        position_connections=position_connections,
        object_collisions=object_collisions,
        object_pairs=object_pairs,
        position_goals=position_goals,
        no_objects_should_move=no_objects_should_move,
    )
    return domain, problem


def convert_all_puzzles_to_pddl(
    pddl_path: str,
    puzzle_path: str = config.BENCHMARK_PUZZLES_PATH,
    for_bfws: bool = False,
) -> None:
    """Converts every puzzle under ``puzzle_path`` into a PDDL domain/problem
    pair under ``pddl_path``, mirroring subdirectories."""
    for puzzle_file, out_base in map_files_with_extension(
        puzzle_path, config.PUZZLE_EXTENSION, pddl_path, ""
    ):
        puzzle = Puzzle.from_file(puzzle_file)
        name = os.path.splitext(os.path.basename(puzzle_file))[0]
        domain, problem = puzzle_to_pddl(name, puzzle, for_bfws)
        with open(out_base + config.DOMAIN_SUFFIX, "w") as f:
            f.write(domain)
        with open(out_base + config.PROBLEM_SUFFIX, "w") as f:
            f.write(problem)
