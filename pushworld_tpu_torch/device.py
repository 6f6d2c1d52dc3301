"""Device resolution shared by every entry point of the port."""

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Returns ``device`` as a ``torch.device``.

    ``cuda`` is the default of every entry point; ``cpu`` runs the plain
    PyTorch versions of the kernels.  Asking for ``cuda`` without a card
    raises: nothing falls back to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def card_info() -> dict:
    """The first card's name and power limit, as ``nvidia-smi`` gives them."""
    import subprocess

    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, _, limit = line.partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}
