"""Jobs of the port's parallel layer over D gloo ranks, one process each.

``launch(tmp_path, world, jobs)`` starts ``world`` processes running this
file; they meet on a FileStore in ``tmp_path`` (no port to race for) and
each runs the jobs in order on CPU meshes over all ranks, appending one JSON
line per job as it finishes.  ``Ranks.result(i)`` waits for job ``i`` under
a timeout of its own, so a hung collective fails one test, and returns every
rank's result.  The rank processes import torch and the port only: each
result carries ``"jax"``, whether JAX was in ``sys.modules``.

Jobs (dicts):
  {"kind": "frontier", "puzzle": name, "kwargs": {...}}
      ``solve_frontier_sharded`` on a ("shard",) mesh -> {"plan", "stats",
      "trace", "ties"} or {"raises": exception type name}.  ``trace`` holds
      each chunk's shared status [solved, min key, max cursor, evictions ==
      0]; ``ties`` the chunks in which this rank selected its frontier
      among equal keys (where the order of the pick is a free choice).
  {"kind": "group", "names": [...], "kwargs": {...}}
      ``solve_group`` on a ("puzzle",) mesh -> {name: [plan, failure_reason]}.
  {"kind": "blocks", "rows": n}
      this rank's ``shard_leading`` block of ``arange(n * 3).reshape(n, 3)``
      on the 1-D mesh and on ``make_mesh_2d(*mesh_2d_shape(world))``, with
      the rank's coordinates there.
"""

import datetime
import json
import os
import subprocess
import sys
import time
from typing import List

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUZZLES = os.path.join(REPO, "tests", "puzzles")
TIMEOUT_S = 240.0


def mesh_2d_shape(world: int):
    return (2, world // 2) if world % 2 == 0 else (1, world)


class Ranks:
    def __init__(self, procs, outs, errs):
        self.procs, self.outs, self.errs = procs, outs, errs

    def result(self, i: int, timeout: float = TIMEOUT_S) -> List[dict]:
        deadline = time.monotonic() + timeout
        while True:
            lines = []
            for o in self.outs:
                with open(o) as f:
                    lines.append(f.read().splitlines())
            if all(len(rows) > i for rows in lines):
                return [json.loads(rows[i]) for rows in lines]
            for p, e in zip(self.procs, self.errs):
                if p.poll() not in (None, 0):
                    with open(e) as f:
                        raise AssertionError(f"a rank failed (exit {p.returncode}):\n{f.read()[-3000:]}")
            if time.monotonic() > deadline:
                self.kill()
                raise TimeoutError(f"no result for job {i} within {timeout:.0f} s")
            time.sleep(0.2)

    def kill(self) -> None:
        for p in self.procs:
            p.kill()
            p.wait()


def launch(tmp_path, world: int, jobs: list) -> Ranks:
    d = tmp_path / f"ranks_{world}"
    d.mkdir()
    spec = d / "jobs.json"
    spec.write_text(json.dumps(jobs))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs, outs, errs = [], [], []
    for r in range(world):
        outs.append(str(d / f"out_{r}.jsonl"))
        errs.append(str(d / f"err_{r}.txt"))
        open(outs[-1], "w").close()
        with open(errs[-1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(spec), str(r), str(world),
                 str(d / "store"), outs[-1]],
                env=env, stdout=subprocess.DEVNULL, stderr=err,
            ))
    return Ranks(procs, outs, errs)


def _run(job, world):
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.parallel import frontier_sharded as fs
    from pushworld_tpu_torch.parallel import mesh as M
    from pushworld_tpu_torch.parallel.sharded import solve_group

    import torch

    if job["kind"] == "frontier":
        p = Puzzle.from_file(os.path.join(PUZZLES, job["puzzle"] + ".pwp"))
        stats, trace, ties = {}, [], []
        run_chunk, select = fs._run_chunk, fs._select_frontier

        def traced_chunk(sh, s, chunk, vote):
            stat = run_chunk(sh, s, chunk, vote)
            trace.append(stat[:3] + [int(stat[3] == 0)])
            return stat

        def traced_select(s, B):
            first = torch.sort(s.frontier_h[s.frontier_h < fs.EMPTY]).values[: B + 1]
            if (first[1:] == first[:-1]).any():
                ties.append(len(trace))
            return select(s, B)

        fs._run_chunk, fs._select_frontier = traced_chunk, traced_select
        try:
            plan = fs.solve_frontier_sharded(p, mesh=M.make_mesh(device="cpu", axis_name="shard"),
                                             stats_out=stats, **job["kwargs"])
        except (ValueError, TimeoutError) as e:
            return {"raises": type(e).__name__}
        finally:
            fs._run_chunk, fs._select_frontier = run_chunk, select
        stats.pop("in_budget_wall_s", None)
        return {"plan": plan, "stats": stats, "trace": trace, "ties": sorted(set(ties))}
    if job["kind"] == "group":
        named = [(n, Puzzle.from_file(os.path.join(PUZZLES, n + ".pwp"))) for n in job["names"]]
        res = solve_group(named, mesh=M.make_mesh(device="cpu"), **job["kwargs"])
        return {n: [r.plan, r.failure_reason] for n, r in res.items()}
    if job["kind"] == "blocks":
        x = torch.arange(job["rows"] * 3).reshape(job["rows"], 3)
        m2 = M.make_mesh_2d(*mesh_2d_shape(world), device="cpu")
        return {"1d": M.shard_leading(M.make_mesh(device="cpu"), x).tolist(),
                "2d": M.shard_leading(m2, {"x": x})["x"].tolist(),
                "coord": list(m2.get_coordinate())}
    raise ValueError(f"unknown job {job['kind']!r}")


def main(spec, rank, world, store, out) -> None:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=int(rank),
                            world_size=int(world), timeout=datetime.timedelta(seconds=TIMEOUT_S))
    with open(spec) as f:
        jobs = json.load(f)
    for job in jobs:
        line = json.dumps(dict(_run(job, int(world)), jax="jax" in sys.modules))
        with open(out, "a") as f:
            f.write(line + "\n")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
