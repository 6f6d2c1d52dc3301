"""The port's multi-process planning and entry points against the JAX
package's, on the CPU.

- ``shard_puzzles`` deals the same shards as the JAX function;
- two processes meet over gloo (``initialize_from_env`` with the ``PW_*``
  variables), plan their shards on the CPU and each gets the COMPLETE merged
  result set, as in tests/test_distributed.py; then each solves a puzzle of
  its own on a one-rank mesh (``make_local_mesh``) that the other process
  never enters;
- ``scripts/benchmark_distributed.py`` in two processes;
- ``entry.dryrun_multichip(1)`` on the CPU, and over 2 and 4 gloo ranks
  (``torch_ranks``: the 2-D mesh is (1, 2) and (2, 2)); ``entry()``'s step
  against ``__graft_entry__.entry()``'s forward on the same inputs.

Every subprocess runs under a timeout of its own.
"""

import glob
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu.parallel.distributed import shard_puzzles as j_shard_puzzles
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.parallel.distributed import shard_puzzles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUZZLES = os.path.join(REPO, "tests", "puzzles")
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(argv_for, env_for):
    """Runs two processes (``argv_for(pid)``, ``env_for(pid)``) to their end
    under one timeout; returns their stdout."""
    procs = [subprocess.Popen(argv_for(pid), env=env_for(pid), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, stderr[-3000:]
        outs.append(stdout)
    return outs


def _env(port, pid, **extra):
    env = dict(os.environ, PW_COORDINATOR=f"127.0.0.1:{port}", PW_NUM_PROCESSES="2",
               PW_PROCESS_ID=str(pid), **extra)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_shard_puzzles_matches_jax(n):
    files = sorted(glob.glob(os.path.join(PUZZLES, "*.pwp")) + glob.glob(os.path.join(PUZZLES, "heur", "*.pwp")))
    names = [os.path.relpath(f, PUZZLES)[:-4] for f in files]
    named = list(zip(names, map(Puzzle.from_file, files)))
    j_named = list(zip(names, map(JPuzzle.from_file, files)))
    shards = [[name for name, _ in shard_puzzles(named, pid, n)] for pid in range(n)]
    assert shards == [[name for name, _ in j_shard_puzzles(j_named, pid, n)] for pid in range(n)]
    assert sorted(sum(shards, [])) == sorted(names)


_WORKER = r"""
import json, os, sys
from pushworld_tpu_torch.core.puzzle import Puzzle
from pushworld_tpu_torch.parallel.distributed import (
    initialize_from_env, plan_puzzles_distributed, shard_puzzles,
)
from pushworld_tpu_torch.parallel.frontier_sharded import solve_frontier_sharded
from pushworld_tpu_torch.parallel.mesh import make_local_mesh

pid, nproc = initialize_from_env()
names = json.loads(os.environ["PW_TEST_PUZZLES"])
named = [(n, Puzzle.from_file(os.path.join("tests", "puzzles", n + ".pwp"))) for n in names]
local = shard_puzzles(named, pid, nproc)
assert 0 < len(local) < len(named)  # both processes get real work
results = plan_puzzles_distributed(named, time_limit=30.0, use_fleet=False, portfolio=False,
                                   device="cpu")
# A search of this process alone: the other one solves another puzzle, with
# another number of collectives, on its own one-rank mesh.
own = ["chain", "multi_goal"][pid]
p = Puzzle.from_file(os.path.join("tests", "puzzles", own + ".pwp"))
plan = solve_frontier_sharded(p, mesh=make_local_mesh("cpu"), expand=16, frontier_capacity=1 << 10,
                              visited_bits=14, history_capacity=1 << 14, chunk=8)
print(json.dumps({
    "pid": pid, "nproc": nproc, "names": sorted(results),
    "solved": sorted(n for n, r in results.items() if r.failure_reason is None),
    "local": [n for n, _ in local], "own_plan_valid": p.is_valid_plan(plan),
    "jax": "jax" in sys.modules,
}))
import torch.distributed as dist
dist.destroy_process_group()
"""


def test_two_process_distributed_planning():
    names = ["simple", "push_left", "chain", "multi_goal"]
    port = _free_port()
    outs = _run_two(lambda pid: [sys.executable, "-c", _WORKER],
                    lambda pid: _env(port, pid, PW_TEST_PUZZLES=json.dumps(names)))
    docs = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [(d["pid"], d["nproc"]) for d in docs] == [(0, 2), (1, 2)]
    locals_ = [set(d["local"]) for d in docs]
    # The shards split the set disjointly across processes...
    assert locals_[0].isdisjoint(locals_[1])
    assert locals_[0] | locals_[1] == set(names)
    # ...and each process merges back the COMPLETE result set, all solved.
    for d in docs:
        assert d["names"] == sorted(names) and d["solved"] == sorted(names)
        assert d["own_plan_valid"] and d["jax"] is False


def test_benchmark_script_in_two_processes(tmp_path):
    names = ["simple", "chain", "multi_goal", "lshape", "no_solution"]
    set_dir = tmp_path / "set"
    set_dir.mkdir()
    for n in names:
        shutil.copy(os.path.join(PUZZLES, n + ".pwp"), set_dir / (n + ".pwp"))
    port = _free_port()
    out = [str(tmp_path / f"out{pid}.json") for pid in range(2)]
    stdout = _run_two(
        lambda pid: [sys.executable, "-m", "pushworld_tpu_torch.scripts.benchmark_distributed",
                     str(set_dir), "--device", "cpu", "--time-limit", "20", "--out", out[pid]],
        lambda pid: _env(port, pid),
    )
    for pid in range(2):
        line = json.loads(stdout[pid].strip().splitlines()[-1])
        assert line == dict(line, process_id=pid, n_processes=2, solved=4, count=5)
        assert set(line) == {"process_id", "n_processes", "solved", "count", "wall_s"}
    docs = [json.load(open(o)) for o in out]
    assert set(docs[0]["local"]).isdisjoint(docs[1]["local"])
    assert set(docs[0]["local"]) | set(docs[1]["local"]) == set(names)
    for d in docs:
        assert sorted(d["results"]) == sorted(names)
        assert d["results"]["no_solution"]["failure_reason"] == "no solution"


def test_dryrun_multichip_on_the_cpu(capsys):
    from pushworld_tpu_torch import entry

    entry.dryrun_multichip(1, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun sharded planner OK: 4/4 puzzles solved" in out
    assert "dryrun frontier-sharded OK: plan_len=2 valid=True over 1 shards" in out
    assert "dryrun_multichip OK: mesh=(1, 1) puzzles=2 rollouts=4" in out
    with pytest.raises(RuntimeError, match="needs a process group of 2 ranks, have 1"):
        entry.dryrun_multichip(2, device="cpu")


@pytest.mark.parametrize("world,mesh", [(2, (1, 2)), (4, (2, 2))])
def test_dryrun_multichip_over_gloo_ranks(tmp_path, world, mesh):
    """Every rank runs the dry run to its end and prints the same lines: all
    four fixtures solved by ``solve_group``, a valid frontier-sharded plan
    over ``world`` shards, and the env step over the 2-D mesh."""
    ranks = torch_ranks.launch(tmp_path, world, [{"kind": "dryrun"}])
    try:
        results = ranks.result(0)
    finally:
        ranks.kill()
    lines = results[0]["lines"]
    assert all(r["lines"] == lines and not r["jax"] for r in results)
    assert lines[0] == "dryrun sharded planner OK: 4/4 puzzles solved"
    assert lines[1] == f"dryrun frontier-sharded OK: plan_len=2 valid=True over {world} shards"
    assert lines[2].startswith(f"dryrun_multichip OK: mesh={mesh} puzzles={2 * mesh[0]} "
                               f"rollouts={4 * mesh[1]} solved=")
    assert len(lines) == 3


def test_entry_step_matches_graft_entry():
    from pushworld_tpu_torch import entry

    spec = importlib.util.spec_from_file_location("graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    j_fn, (j_cp, j_states, j_actions) = graft.entry()
    fn, (cp, states, actions) = entry.entry(device="cpu")
    assert np.array_equal(states.numpy(), np.asarray(j_states))
    assert np.array_equal(actions.numpy(), np.asarray(j_actions))
    rng = np.random.default_rng(0)
    for _ in range(3):
        a = rng.integers(0, 4, size=actions.shape).astype(np.int32)
        want = np.asarray(jax.jit(j_fn)(j_cp, j_states, jnp.asarray(a)))
        got = fn(cp, states, torch.as_tensor(a))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        j_states, states = jnp.asarray(want), got
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            entry.entry()
