from pushworld_tpu_torch.search.heuristics_host import (  # noqa: F401
    MovementGraphs,
    NoveltyHeuristic,
    PathDistances,
    RecursiveGraphDistance,
    WeightedSumHeuristic,
)
from pushworld_tpu_torch.search.host_planner import best_first_search, solve_host  # noqa: F401
