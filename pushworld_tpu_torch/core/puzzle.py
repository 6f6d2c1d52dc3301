"""Host-side PushWorld puzzle core: ``.pwp`` parsing, exact dynamics, rendering.

The port's own copy of the semantic oracle (the JAX package's
``core/puzzle.py``), so that the port imports nothing of that package.  It
parses puzzles, computes the exact transition function, validates plans and
renders states to pixel images (numpy only).

Semantics match the reference exactly:
  - grid & token format  — reference: python3/src/pushworld/puzzle.py:130-257,
    cpp/src/pushworld_puzzle.cc:191-322
  - push propagation with transitive stopping — reference: puzzle.py:348-394,
    pushworld_puzzle.cc:386-460
  - goal / plan validity — reference: puzzle.py:409-424

Object ordering convention: element ids are processed in ascending
lexicographic order, so the movable order is ``agent, goal movables (ascending
goal id order), remaining movables (ascending)`` (the reference C++ planner's
``std::map`` order, pushworld_puzzle.cc:274-322).
"""

from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np

NUM_ACTIONS = 4
AGENT_IDX = 0

# The default pixel width of the border drawn to indicate object boundaries.
DEFAULT_BORDER_WIDTH = 2
# The default pixel width/height of one grid cell when rendering.
DEFAULT_PIXELS_PER_CELL = 20

Point = Tuple[int, int]
State = Tuple[Point, ...]


class Actions:
    """Action enumeration.  reference: puzzle.py:32-50, pushworld_puzzle.h:60-71."""

    LEFT, RIGHT, UP, DOWN = range(NUM_ACTIONS)

    FROM_CHAR = {"L": LEFT, "R": RIGHT, "U": UP, "D": DOWN}
    TO_CHAR = "LRUD"
    DISPLACEMENTS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _hex(h: str) -> Tuple[int, int, int]:
    return tuple(int(h[i : i + 2], 16) for i in (0, 2, 4))


class Colors:
    """Rendering palette.  reference: puzzle.py:65-79."""

    AGENT = _hex("00DC00")
    AGENT_BORDER = _hex("006E00")
    AGENT_WALL = _hex("FAC71E")
    AGENT_WALL_BORDER = _hex("7D640F")
    GOAL = None  # transparent fill
    GOAL_BORDER = _hex("B90000")
    GOAL_OBJECT = _hex("DC0000")
    GOAL_OBJECT_BORDER = _hex("6E0000")
    MOVABLE = _hex("469BFF")
    MOVABLE_BORDER = _hex("23487F")
    WALL = _hex("0A0A0A")
    WALL_BORDER = _hex("050505")


@dataclass(frozen=True)
class PushWorldObject:
    """A renderable object: a set of cells relative to a position."""

    position: Point
    fill_color: Optional[Tuple[int, int, int]]
    border_color: Tuple[int, int, int]
    cells: FrozenSet[Point]


def _cells_bbox(cells: Iterable[Point]) -> Tuple[int, int, int, int]:
    xs = [c[0] for c in cells]
    ys = [c[1] for c in cells]
    return min(xs), min(ys), max(xs), max(ys)


def parse_pwp_text(text: str) -> Dict[str, set]:
    """Parses ``.pwp`` text into ``{element_id: set of absolute cells}``.

    Cells are 1-indexed (the 1-cell wall border added later occupies row/col 0
    and W-1/H-1).  Tokens are whitespace-separated; overlapping elements are
    ``+``-joined; ``.`` is empty; ids are lowercased.
    Blank lines are ignored (reference: pushworld_puzzle.cc:210-213); all other
    rows must have the same number of tokens as the first row.
    """
    elem_cells: Dict[str, set] = {}
    elems_per_row = -1
    y = 0
    for raw_line in text.splitlines():
        tokens = raw_line.split()
        if not tokens:
            continue
        y += 1
        if y == 1:
            elems_per_row = len(tokens)
        elif len(tokens) != elems_per_row:
            raise ValueError(
                f"Row {y} does not have the same number of elements as the first row."
            )
        for x, token in enumerate(tokens, start=1):
            for elem_id in token.split("+"):
                elem_id = elem_id.lower()
                if elem_id != ".":
                    elem_cells.setdefault(elem_id, set()).add((x, y))
    if y == 0:
        raise ValueError("Empty puzzle file.")
    if "a" not in elem_cells:
        raise ValueError("Every puzzle must have an agent object, indicated by 'a'.")
    return elem_cells, elems_per_row, y


def _shift(cells: Iterable[Point], d: Point) -> FrozenSet[Point]:
    dx, dy = d
    return frozenset((x + dx, y + dy) for x, y in cells)


class Puzzle:
    """A PushWorld puzzle with exact dynamics.

    Construct from a file path via :meth:`from_file` or from text via
    :meth:`from_text`.

    Attributes:
        width, height: grid dimensions *including* the auto-added 1-cell border.
        initial_state: tuple of (x, y) positions, agent first.
        goal_state: tuple of goal positions for movables ``1..len(goal_state)``.
        movable_names: element ids of movables in state order.
        wall_cells: absolute cells of walls (including the border).
        agent_wall_cells: absolute cells of agent-only walls.
        movable_cells: per movable, the frozenset of position-relative cells.
    """

    def __init__(
        self, elem_cells: Dict[str, set], content_width: int, content_height: int
    ) -> None:
        # Grid dimensions: content spans x in [1, W-2], y in [1, H-2].
        self.width = content_width + 2
        self.height = content_height + 2

        # Border walls. reference: puzzle.py:159-168.
        walls = set(elem_cells.get("w", ()))
        for xx in range(self.width):
            walls.add((xx, 0))
            walls.add((xx, self.height - 1))
        for yy in range(self.height):
            walls.add((0, yy))
            walls.add((self.width - 1, yy))
        self.wall_cells: FrozenSet[Point] = frozenset(walls)
        self.agent_wall_cells: FrozenSet[Point] = frozenset(elem_cells.get("aw", ()))

        # Movable ordering: agent, then goal movables ascending by goal id,
        # then remaining movables ascending.
        goal_ids = sorted(e for e in elem_cells if e[0] == "g" and e != "g")
        movable_names: List[str] = ["a"]
        goal_positions: List[Point] = []
        for gid in goal_ids:
            mid = "m" + gid[1:]
            if mid not in elem_cells:
                raise ValueError(f"Goal has no associated movable object: {mid}")
            movable_names.append(mid)
        for eid in sorted(elem_cells):
            if eid[0] == "m" and eid != "m" and eid not in movable_names:
                movable_names.append(eid)

        self.movable_names: List[str] = movable_names
        self.num_movables = len(movable_names)
        self.num_goals = len(goal_ids)
        self.goal_ids = goal_ids

        def origin(cells) -> Point:
            x0, y0, _, _ = _cells_bbox(cells)
            return (x0, y0)

        positions = {}
        rel_cells = {}
        for eid in list(elem_cells):
            if eid in ("w", "aw"):
                continue
            pos = origin(elem_cells[eid])
            positions[eid] = pos
            rel_cells[eid] = frozenset(
                (x - pos[0], y - pos[1]) for x, y in elem_cells[eid]
            )

        for gid in goal_ids:
            goal_positions.append(positions[gid])

        self.initial_state: State = tuple(positions[m] for m in movable_names)
        self.goal_state: Tuple[Point, ...] = tuple(goal_positions)
        self.movable_cells: List[FrozenSet[Point]] = [
            rel_cells[m] for m in movable_names
        ]
        self.goal_cells: List[FrozenSet[Point]] = [rel_cells[g] for g in goal_ids]

        # Static obstacle sets used by dynamics.
        self._agent_obstacles = self.wall_cells | self.agent_wall_cells

        # Renderable objects (state-independent parts).
        self._walls_obj = PushWorldObject(
            (0, 0), Colors.WALL, Colors.WALL_BORDER, frozenset(self.wall_cells)
        )
        # Render parity quirk: the reference merges the wall cells into its
        # agent-wall pixel set IN PLACE for the agent's collision map
        # (reference: puzzle.py:273 ``obj_pixels["aw"].update(...)``), and
        # its renderable agent-walls object aliases that same set — so the
        # reference draws agent-walls with borders suppressed against walls
        # (walls are painted afterwards and overpaint their own cells).
        # Pixel-exact goldens (tests/goldens) pin this behavior.
        self._agent_walls_obj = (
            PushWorldObject(
                (0, 0),
                Colors.AGENT_WALL,
                Colors.AGENT_WALL_BORDER,
                frozenset(self.agent_wall_cells | self.wall_cells),
            )
            if self.agent_wall_cells
            else None
        )
        movable_objs = []
        for i, name in enumerate(movable_names):
            if i == AGENT_IDX:
                fill, border = Colors.AGENT, Colors.AGENT_BORDER
            elif i <= self.num_goals:
                fill, border = Colors.GOAL_OBJECT, Colors.GOAL_OBJECT_BORDER
            else:
                fill, border = Colors.MOVABLE, Colors.MOVABLE_BORDER
            movable_objs.append(
                PushWorldObject((0, 0), fill, border, self.movable_cells[i])
            )
        self.movable_objects: List[PushWorldObject] = movable_objs
        self.goal_objects: List[PushWorldObject] = [
            PushWorldObject(
                goal_positions[k], Colors.GOAL, Colors.GOAL_BORDER, self.goal_cells[k]
            )
            for k in range(self.num_goals)
        ]

    # ------------------------------------------------------------------ I/O

    @classmethod
    def from_text(cls, text: str) -> "Puzzle":
        return cls(*parse_pwp_text(text))

    @classmethod
    def from_file(cls, file_path: str) -> "Puzzle":
        with open(file_path, "r") as f:
            return cls.from_text(f.read())

    @property
    def dimensions(self) -> Tuple[int, int]:
        """(width, height) including the border."""
        return (self.width, self.height)

    # ------------------------------------------------------------- dynamics

    def get_next_state(self, state: State, action: int) -> State:
        """The exact PushWorld transition.

        The agent moves one cell in the action direction, transitively pushing
        any movables it (or a pushed movable) would overlap.  If the agent
        would hit a wall or agent-wall, or any transitively pushed movable
        would hit a wall, *nothing moves* (transitive stopping).
        reference: puzzle.py:348-394, pushworld_puzzle.cc:386-460.
        """
        d = Actions.DISPLACEMENTS[action]
        abs_cells = [
            _shift(self.movable_cells[i], state[i]) for i in range(self.num_movables)
        ]

        if _shift(abs_cells[AGENT_IDX], d) & self._agent_obstacles:
            return state  # the agent cannot move

        pushed = [False] * self.num_movables
        pushed[AGENT_IDX] = True
        frontier = [AGENT_IDX]
        while frontier:
            i = frontier.pop()
            target = _shift(abs_cells[i], d)
            for j in range(1, self.num_movables):
                if pushed[j]:
                    continue
                if target & abs_cells[j]:
                    # j is pushed by i; transitive stop if j would hit a wall.
                    if _shift(abs_cells[j], d) & self.wall_cells:
                        return state
                    pushed[j] = True
                    frontier.append(j)

        return tuple(
            (x + d[0], y + d[1]) if pushed[i] else (x, y)
            for i, (x, y) in enumerate(state)
        )

    def get_pushed_objects(self, state: State, action: int) -> List[int]:
        """Indices of movables that move when ``action`` is taken in ``state``
        (empty if nothing moves).  Used by tests and the PDDL exporter."""
        nxt = self.get_next_state(state, action)
        return [i for i in range(self.num_movables) if nxt[i] != state[i]]

    def count_achieved_goals(self, state: State) -> int:
        """reference: puzzle.py:396-407."""
        return sum(
            1
            for k in range(self.num_goals)
            if state[1 + k] == self.goal_state[k]
        )

    def is_goal_state(self, state: State) -> bool:
        return tuple(state[1 : 1 + self.num_goals]) == self.goal_state

    def is_valid_plan(self, plan: Iterable[int]) -> bool:
        """True iff applying ``plan`` from the initial state ends in a goal
        state, without reaching the goal early.  reference: puzzle.py:413-424."""
        state = self.initial_state
        for action in plan:
            if self.is_goal_state(state):
                return False
            state = self.get_next_state(state, action)
        return self.is_goal_state(state)

    def apply_plan(self, plan: Iterable[int], state: Optional[State] = None) -> State:
        if state is None:
            state = self.initial_state
        for action in plan:
            state = self.get_next_state(state, action)
        return state

    # ------------------------------------------------------------ rendering

    def render(
        self,
        state: State,
        border_width: int = DEFAULT_BORDER_WIDTH,
        pixels_per_cell: int = DEFAULT_PIXELS_PER_CELL,
    ) -> np.ndarray:
        """Renders ``state`` to an RGB uint8 image of shape
        (height*ppc, width*ppc, 3).  reference: puzzle.py:426-469, 596-638."""
        from pushworld_tpu_torch.core.render import draw_object

        if border_width < 1:
            raise ValueError("border_width must be >= 1")
        if pixels_per_cell < 1 + 2 * border_width:
            raise ValueError("pixels_per_cell must be >= 1 + 2*border_width")

        image = np.full(
            (self.height * pixels_per_cell, self.width * pixels_per_cell, 3),
            255,
            np.uint8,
        )
        layers: List[Tuple[PushWorldObject, Point]] = []
        if self._agent_walls_obj is not None:
            layers.append((self._agent_walls_obj, (0, 0)))
        layers.append((self._walls_obj, (0, 0)))
        layers.extend(zip(self.movable_objects, state))
        layers.extend((g, g.position) for g in self.goal_objects)
        for obj, pos in layers:
            draw_object(obj, pos, image, pixels_per_cell, border_width)
        return image

    def render_plan(
        self,
        plan: Iterable[int],
        border_width: int = DEFAULT_BORDER_WIDTH,
        pixels_per_cell: int = DEFAULT_PIXELS_PER_CELL,
    ) -> List[np.ndarray]:
        """Frames of the trajectory induced by ``plan`` from the initial state."""
        state = self.initial_state
        frames = [self.render(state, border_width, pixels_per_cell)]
        for action in plan:
            state = self.get_next_state(state, action)
            frames.append(self.render(state, border_width, pixels_per_cell))
        return frames


def plan_from_string(plan: str) -> List[int]:
    """Converts an ``LRUD`` action string into a list of action ints."""
    return [Actions.FROM_CHAR[c] for c in plan.strip().upper()]


def plan_to_string(plan: Sequence[int]) -> str:
    return "".join(Actions.TO_CHAR[a] for a in plan)
