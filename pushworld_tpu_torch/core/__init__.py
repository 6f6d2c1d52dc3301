from pushworld_tpu_torch.core.puzzle import Actions, Puzzle  # noqa: F401
from pushworld_tpu_torch.core.compiled import CompiledPuzzle, compile_puzzle  # noqa: F401
