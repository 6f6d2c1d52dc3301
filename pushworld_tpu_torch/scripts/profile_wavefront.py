"""Where the wavefront kernel spends its time on the card.

``python -m pushworld_tpu_torch.scripts.profile_wavefront PUZZLE.pwp``

Takes the largest all-pairs block of the puzzle's table build (one field per
vertex of one object's movement graph, one shared mask stack), checks the
kernel against its plain version on it, and prints one JSON line:

- ``ms_by_cap``: CUDA-event mean per wrapper call at ``max_iters`` 1, 10, 50
  and 0 (uncapped), which separates the fixed cost (masks, seeds, store,
  launches) from the cost per level;
- ``copy_ms``: a device copy of the seeds, the same bytes read and written;
- ``phase_us``: from a second build of ``kernels/wavefront.cu`` with
  ``-DPW_PHASE_TIMERS``, the mean and the largest time a CTA spends copying
  the masks, loading the seeds, in the level loop and storing its fields,
  and when the last CTA ends after the first one starts.

Needs a CUDA device.
"""

import argparse
import ctypes
import json
import subprocess


def _event_ms(fn, reps: int = 50) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _largest_block(puzzle, dev):
    """(E_o (1, 4, H, W) bool, d0 (R, H, W) float32) of the object with the
    most graph vertices, as ``build_rgd_tables`` hands them to the kernel."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.ops.graphs import INF, host_vertex_mask
    from pushworld_tpu_torch.ops.rgd import _movement_graphs_host

    cp = compile_puzzle(puzzle)
    H, W = cp.height, cp.width
    E_np = _movement_graphs_host(puzzle, cp)
    starts = [puzzle.initial_state[o] for o in range(puzzle.num_movables)]
    verts = [np.nonzero(host_vertex_mask(E_np[:, o], s[1] * W + s[0]))[0] for o, s in enumerate(starts)]
    o = max(range(len(verts)), key=lambda i: len(verts[i]))
    R = len(verts[o])
    d0 = torch.full((R, H * W), INF, dtype=torch.float32, device=dev)
    d0[torch.arange(R, device=dev), torch.as_tensor(verts[o], device=dev)] = 0.0
    return torch.as_tensor(E_np, device=dev)[None, :, o], d0.reshape(R, H, W)


def _phase_times(E_o, d0):
    """Builds the kernel with its phase timers and reads them after a launch."""
    import numpy as np
    import torch

    from pushworld_tpu_torch.kernels import _build

    src = _build.KERNEL_DIR / "wavefront.cu"
    lib_path = _build.BUILD_DIR / "libwavefront-phase-timers.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DPW_PHASE_TIMERS", "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.pw_wavefront.argtypes = _build.SIGNATURES["wavefront"]["pw_wavefront"]
    lib.pw_phase_times.argtypes = [ctypes.c_void_p, ctypes.c_int]

    R, H, W = d0.shape
    out = torch.empty_like(d0)
    packed = torch.empty((4 * H * ((W + 63) // 64),), dtype=torch.int64, device=d0.device)

    def launch():
        rc = lib.pw_wavefront(E_o.data_ptr(), 0, E_o.stride(1), packed.data_ptr(), d0.data_ptr(),
                              out.data_ptr(), R, H, W, H * W + 8, None)
        if rc != 0:
            raise RuntimeError(f"wavefront launch failed: CUDA error {rc}")

    ms = _event_ms(launch)
    n_ctas = 8192
    stamps = np.zeros((n_ctas, 5), np.int64)
    if lib.pw_phase_times(stamps.ctypes.data, n_ctas) != 0:
        raise RuntimeError("reading the phase timers failed")
    t = stamps[stamps[:, 0] > 0].astype(np.float64) / 1e3  # the CTAs that ran, in us
    spans = np.diff(t, axis=1)
    names = ("masks", "seeds", "levels", "store")
    return {
        "launch_ms": ms, "ctas": len(t),
        "mean": dict(zip(names, spans.mean(0).tolist())),
        "max": dict(zip(names, spans.max(0).tolist())),
        "last_end_after_first_start": float(t[:, 4].max() - t[:, 0].min()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("puzzle", help="path of a .pwp puzzle file")
    args = ap.parse_args(argv)

    import torch

    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.ops.graphs import INF, distance_fields_reference
    from pushworld_tpu_torch.ops.graphs_cuda import distance_fields

    dev = torch.device("cuda", 0)
    E_o, d0 = _largest_block(Puzzle.from_file(args.puzzle), dev)
    got = distance_fields(E_o, d0)
    if not torch.equal(got, distance_fields_reference(E_o, d0)):
        raise AssertionError("wavefront != plain version")
    print(json.dumps({
        "puzzle": args.puzzle, "device": torch.cuda.get_device_name(0),
        "fields": d0.shape[0], "grid": list(d0.shape[1:]),
        "deepest_level": float(got[got < INF].max()),
        "ms_by_cap": {str(cap): _event_ms(lambda: distance_fields(E_o, d0, max_iters=cap))
                      for cap in (1, 10, 50, 0)},
        "copy_ms": _event_ms(lambda: d0.clone()),
        "phase_us": _phase_times(E_o, d0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
