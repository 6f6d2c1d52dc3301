"""The toolkit: puzzle generation, symmetry transforms, the benchmark harness,
PDDL / SAS export, plots and previews (the port's copy of the JAX package's
``tools``).  ``python -m pushworld_tpu_torch.scripts.tools_cli`` drives it.

The tools that plan (``generate``, ``benchmark``) take ``device`` (default
``"cuda"``) and read ``planner`` through :func:`resolve_planner`.
"""

from typing import Tuple

import torch

from pushworld_tpu_torch.device import DeviceLike, resolve_device


def resolve_planner(planner: str, device: DeviceLike = "cuda") -> Tuple[str, torch.device]:
    """The planner a tool runs, and its device.

    The JAX package's rule (``tools/benchmark.py:56-61``,
    ``search/planner.py:251-253``) with the caller's device in place of
    JAX's default backend: ``"auto"`` is the batched search on a card and
    the host planner on ``"cpu"``; ``"batched"`` is always the batched
    search on ``device``; ``"host"`` is the host planner.
    ``device="cuda"`` without a card raises, whatever the planner: nothing
    falls back to the CPU.
    """
    if planner not in ("auto", "batched", "host"):
        raise ValueError(f"unknown planner {planner!r}")
    dev = resolve_device(device)
    if planner == "auto":
        planner = "batched" if dev.type == "cuda" else "host"
    return planner, dev
