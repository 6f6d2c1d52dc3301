"""Builds the CUDA kernels at first use and loads them with ctypes.

Each ``.cu`` source in this directory has a plain C interface and is compiled
by ``nvcc`` alone (no PyTorch headers, so a build takes seconds) into a
shared library under ``.torch_ext_build/`` at the repository root, named by
the hash of its source, of the headers beside it (``*.cuh``, which the
sources include) and of the nvcc flags, so an edited kernel, an edited
header or a changed flag is rebuilt.  Missing libraries are
built in parallel, one ``nvcc`` per source, all started together.

Nothing here runs at import: the CPU tests import every module of the port
and never touch ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, Iterable

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[1] / ".torch_ext_build"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_vp, _i, _u, _ll, _ull = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, ctypes.c_ulonglong
# C signatures of every exported function, by source.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "wavefront": {
        "pw_wavefront": [_vp, _ll, _ll, _vp, _vp, _vp, _i, _i, _i, _i, _vp],
        "pw_wavefront_fits": [_i, _i],
    },
    "visited_set": {
        "pw_probe_and_insert": [_vp, _vp, _vp, _vp, _i, _u, _vp],
        "pw_probe_delete": [_vp, _vp, _vp, _vp, _i, _u, _vp],
        "pw_dedup_shared_slots": [],
        "pw_fingerprint_dedup_insert": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _u, _u, _i, _vp],
        "pw_fingerprint": [_vp, _vp, _i, _i, _u, _vp],
    },
    "rgd": {
        "pw_rgd_heuristic": [_vp] * 15 + [_i] * 9 + [_vp],
        "pw_rgd_heuristic_wide": [_vp] * 15 + [_i] * 9 + [_vp, _vp],
        "pw_rgd_wide_scratch_floats": [_i] * 6,
        "pw_rgd_max_objects": [],
    },
    "expand": {
        "pw_expand": [_vp] * 13 + [_i] * 5 + [_vp],
        "pw_expand_wide": [_vp] * 13 + [_i] * 5 + [_vp],
        "pw_expand_max_objects": [],
    },
    "frontier": {
        "pw_frontier_select": [_vp] * 5 + [_i] + [_vp] * 5 + [_i] * 3 + [_vp],
        "pw_frontier_select_scratch_words": [_i, _i],
        "pw_frontier_compact": [_vp] * 7 + [_u] + [_vp] * 5 + [_i] * 4 + [_vp],
        "pw_frontier_append": [_vp] * 25 + [_i] * 10 + [_vp, _ull, _i, _vp],
    },
    "novelty": {
        "pw_novelty_score_records": [_vp] * 7 + [_i] * 5 + [_vp],
        "pw_novelty_absorb_records": [_vp] * 4 + [_i] * 5 + [_vp],
        "pw_novelty_score_records_wide": [_vp] * 7 + [_i] * 5 + [_vp],
        "pw_novelty_absorb_records_wide": [_vp] * 4 + [_i] * 5 + [_vp],
        "pw_novelty_max_objects": [],
    },
    "env": {
        "pw_env_step": [_vp] * 22,
        "pw_env_step_max_objects": [],
    },
    "render": {
        "pw_render_onehot": [_vp] * 6 + [_ll] + [_i] * 4 + [_vp],
    },
    "chunk_loop": {
        "pw_chunk_loop_new": [_vp, _vp],
        "pw_chunk_loop_build": [_vp] * 3 + [_i],
        "pw_chunk_loop_launch": [_vp, _i, _vp],
        "pw_chunk_loop_free": [_vp],
    },
}

# Return types other than int.
RESTYPES = {"pw_rgd_wide_scratch_floats": _ll}

_LOADED: Dict[str, ctypes.CDLL] = {}
# Several threads launch kernels; a library is built and loaded once.
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256((KERNEL_DIR / f"{name}.cu").read_bytes())
    for header in sorted(KERNEL_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SIGNATURES), verbose: bool = False) -> Dict[str, Path]:
    """Compiles every missing library of ``names`` (in parallel) and returns
    their paths.  Raises with nvcc's output if a build fails."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_DIR / f"{name}.cu")]
        procs[name] = (tmp, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        if verbose:
            print(f"[build] {name}.cu:\n{log}", file=sys.stderr, flush=True)
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build([name])[name]))
                for fn, argtypes in SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
                _LOADED[name] = lib
    return lib
