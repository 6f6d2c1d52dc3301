"""Carries state across from the JAX package, as numpy arrays.

Each function takes a dict of numpy arrays — one entry per field of the JAX
dataclass, as ``np.asarray`` gives them (static fields may be plain ints or
0-d arrays; nested dataclasses are nested dicts) — and returns the port's
dataclass on ``device``.  The JAX visited set's two uint32 lanes
(``key_lo`` / ``key_hi``) and the frontier's (``frontier_lo`` /
``frontier_hi``) are packed into the port's one int64 word per key.

The environment's state and the render tables carry over field by field.

This module imports no JAX: the caller converts the JAX arrays.
"""

from typing import Any, Dict

import numpy as np
import torch

from pushworld_tpu_torch.core.compiled import CompiledPuzzle
from pushworld_tpu_torch.device import DeviceLike, resolve_device
from pushworld_tpu_torch.envs.vector_env import EnvState
from pushworld_tpu_torch.ops.hashset import HashSet, pack_key
from pushworld_tpu_torch.ops.novelty import NoveltyTables
from pushworld_tpu_torch.ops.rgd import RGDTables
from pushworld_tpu_torch.search.batched import SearchState

Arrays = Dict[str, Any]


def _t(x, dev: torch.device, dtype=None) -> torch.Tensor:
    x = np.array(x)  # a writable copy
    if dtype is torch.bfloat16:
        return torch.as_tensor(x.astype(np.float32), device=dev).to(torch.bfloat16)
    return torch.as_tensor(x, device=dev, dtype=dtype)


def _packed(lo, hi, dev: torch.device) -> torch.Tensor:
    lo = torch.as_tensor(np.asarray(lo).astype(np.int64), device=dev)
    hi = torch.as_tensor(np.asarray(hi).astype(np.int64), device=dev)
    return pack_key(lo, hi)


def compiled_from_numpy(d: Arrays, device: DeviceLike = "cuda") -> CompiledPuzzle:
    dev = resolve_device(device)
    return CompiledPuzzle(
        static_block=_t(d["static_block"], dev),
        push=_t(d["push"], dev),
        init_state=_t(d["init_state"], dev, torch.int32),
        goal_pos=_t(d["goal_pos"], dev, torch.int32),
        obj_mask=_t(d["obj_mask"], dev),
        goal_mask=_t(d["goal_mask"], dev),
        n=int(d["n"]),
        height=int(d["height"]),
        width=int(d["width"]),
        delta=int(d["delta"]),
    )


def rgd_tables_from_numpy(d: Arrays, device: DeviceLike = "cuda") -> RGDTables:
    dev = resolve_device(device)
    return RGDTables(
        E=_t(d["E"], dev),
        Dflat=_t(np.asarray(d["Dflat"]).astype(np.int32), dev),
        vidx=_t(d["vidx"], dev, torch.int32),
        doff=_t(d["doff"], dev, torch.int32),
        dstride=_t(d["dstride"], dev, torch.int32),
        DG=_t(d["DG"], dev, torch.float32),
        contacts=_t(d["contacts"], dev, torch.int16),
        contacts_mask=_t(d["contacts_mask"], dev),
        contacts_a=_t(d["contacts_a"], dev, torch.int16),
        contacts_a_mask=_t(d["contacts_a_mask"], dev),
        cvidx_a=_t(d["cvidx_a"], dev, torch.int16),
        goal_pos=_t(d["goal_pos"], dev, torch.int32),
        goal_mask=_t(d["goal_mask"], dev),
        n_real=int(d["n_real"]),
        n=int(d["n"]),
        max_goals=int(d["max_goals"]),
        height=int(d["height"]),
        width=int(d["width"]),
        cmax=int(d["cmax"]),
        cmax_agent=int(d["cmax_agent"]),
    )


def search_state_from_numpy(d: Arrays, device: DeviceLike = "cuda") -> SearchState:
    dev = resolve_device(device)
    vis, nov = d["visited"], d["novelty"]

    def scalar(name, dtype=torch.int32):
        return _t(d[name], dev, dtype).reshape(())

    return SearchState(
        frontier_states=_t(d["frontier_states"], dev, torch.int32),
        frontier_h=_t(d["frontier_h"], dev, torch.int32),
        frontier_hist=_t(d["frontier_hist"], dev, torch.int32),
        frontier_key=_packed(d["frontier_lo"], d["frontier_hi"], dev),
        ring_cursor=scalar("ring_cursor"),
        hist_parent=_t(d["hist_parent"], dev, torch.int32),
        hist_action=_t(d["hist_action"], dev, torch.int32),
        hist_cursor=scalar("hist_cursor"),
        visited=HashSet(
            keys=_packed(vis["key_lo"], vis["key_hi"], dev),
            capacity_bits=int(vis["capacity_bits"]),
        ),
        novelty=NoveltyTables(
            seen_pos=_t(nov["seen_pos"], dev, torch.bool),
            pair_table=_t(nov["pair_table"], dev, torch.bfloat16),
            n=int(nov["n"]),
            width=int(nov["width"]),
            height=int(nov["height"]),
            pair_bits=int(nov["pair_bits"]),
        ),
        solved=scalar("solved", torch.bool),
        solved_hist=scalar("solved_hist"),
        iterations=scalar("iterations"),
        expansions=scalar("expansions"),
        evictions=scalar("evictions"),
        needs_deeper=scalar("needs_deeper"),
    )


def env_state_from_numpy(d: Arrays, device: DeviceLike = "cuda") -> EnvState:
    """The JAX package's ``EnvState`` (its four fields as numpy arrays)."""
    dev = resolve_device(device)
    return EnvState(
        positions=_t(d["positions"], dev, torch.int32),
        steps=_t(d["steps"], dev, torch.int32),
        achieved=_t(d["achieved"], dev, torch.int32),
        puzzle_idx=_t(d["puzzle_idx"], dev, torch.int32),
    )


def render_tables_from_numpy(d: Arrays, device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """The dict of ``pushworld_tpu.ops.render.compile_render_tables`` as the
    port's render tables on ``device``."""
    dev = resolve_device(device)
    return {
        "base": _t(d["base"], dev, torch.int8),
        "obj_cells": _t(d["obj_cells"], dev, torch.int16),
        "obj_mask": _t(d["obj_mask"], dev, torch.bool),
        "obj_class": _t(d["obj_class"], dev, torch.int8),
    }
