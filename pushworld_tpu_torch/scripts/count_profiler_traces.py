"""How often torch.profiler returns a trace without device time.

``python -m pushworld_tpu_torch.scripts.count_profiler_traces --out COUNTS.json -- SCRIPT [ARGS...]``

Runs ``SCRIPT`` (``chip_smoke.py``, say) as ``__main__`` with every
``torch.profiler.profile`` session counted: the sessions it closed, and
those whose ``key_averages()`` hold no CUDA row with device time (the
traces that ``chip_smoke.profile_device`` takes again).  At exit, whatever
the script's exit code, writes one JSON object to ``--out``:
``{"script", "traces", "empty", "empty_at"}``, ``empty_at`` the session
numbers (from 1) of the empty traces.  The script's own exit code is kept.
The count reads each trace once more, so it adds host time after every
session, not device time.  Needs a CUDA device where the script does.
"""

import argparse
import atexit
import json
import runpy
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="file for the counts (JSON)")
    ap.add_argument("script", help="the Python script to run")
    ap.add_argument("args", nargs=argparse.REMAINDER, help="the script's arguments")
    args = ap.parse_args(argv)

    from torch.autograd import DeviceType
    from torch.profiler import profile

    counts = {"script": args.script, "traces": 0, "empty": 0, "empty_at": []}
    close = profile.__exit__

    def counted_exit(self, *exc):
        out = close(self, *exc)
        counts["traces"] += 1
        rows = [e for e in self.key_averages() if e.device_type == DeviceType.CUDA
                and (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)) > 0]
        if not rows:
            counts["empty"] += 1
            counts["empty_at"].append(counts["traces"])
        return out

    def write():
        with open(args.out, "w") as f:
            json.dump(counts, f)
            f.write("\n")

    profile.__exit__ = counted_exit
    atexit.register(write)
    sys.argv = [args.script] + [a for a in args.args if a != "--"]
    runpy.run_path(args.script, run_name="__main__")


if __name__ == "__main__":
    main()
