"""The Gym deployment's RL traffic: lockstep rollouts, each one replay of the
program's trajectory rollout graph, back to back.

The environment is ``VectorEnv(puzzles, max_steps)`` of
``pushworld_tpu_torch.envs`` over the configuration's pool stacked
(``compile_batch``), each rollout's puzzle drawn from the seed; the
observations are the program's framed one-hot renders
(``ops.render.compile_framed_render_tables`` over the pool, in the mix's
frame); the rollout is ``envs.throughput.RolloutGraph`` with a trajectory
(on the card one CUDA graph a rollout: ``horizon`` steps of a one-step env
kernel launch, which writes the step's reward and flags into row t of the
(horizon, B) buffers, and a framed render launch into row t of the (horizon,
B, H_f, W_f, 6) observations).  The trajectory is the program's output, read
from the graph's attributes as a learner would read it.  The policy is the
benchmark's: before each replay a fresh (horizon, batch) block of uniform
actions is drawn on the device from the seed and the replay's index, into
the tensor the graph reads.

Each rollout's total and last positions are read where the program hands
them over, as in ``rollout.py``: the environment's ``step`` is wrapped (on
this environment object only, before the capture); the wrapper launches
nothing.

The window replays until ``seconds`` have passed, then replays once more and
waits for the card.  ``checks`` of its replays are kept: one at or after
each seed-drawn time, and that last one.  Before a kept replay, and only then, the whole
trajectory is filled with NaN (its flags with True), so that a cell the
program does not write shows as a difference.  A kept replay keeps its
actions, the trajectory's rows at two seed-drawn steps and at the last step,
its (horizon, B) rewards and flags, the graph's reward total, each
rollout's total and its last positions.  The check runs the reference on
each kept replay's actions and compares them all.
"""

import time

import numpy as np
import torch

from pwbench.drivers.rollout import replay_seed
from pwbench.reference import dynamics, puzzle as ref_puzzle, trajectory as ref_traj


class LastStep:
    """Wraps an environment's ``step``: keeps the reward accumulator it was
    given and the positions it returned (before the reset) of its last
    call."""

    def __init__(self, env):
        self.step = env.step
        self.reward_acc = self.positions = None

    def __call__(self, state, actions, reward_acc=None, out=None):
        res = self.step(state, actions, reward_acc=reward_acc, out=out)
        self.reward_acc, self.positions = reward_acc, res[1]
        return res


TRAJECTORY = ("obs", "reward", "terminated", "truncated")


class Driver:
    def __init__(self, run):
        self.run = run
        self.p = run.cell.traffic["params"]
        self.kept = []

    def setup(self):
        from pushworld_tpu_torch.core.compiled import compile_batch
        from pushworld_tpu_torch.core.puzzle import Puzzle
        from pushworld_tpu_torch.envs.throughput import RolloutGraph, Trajectory, rollout
        from pushworld_tpu_torch.envs.vector_env import VectorEnv
        from pushworld_tpu_torch.ops.render import compile_framed_render_tables

        dev, B, T = self.run.device, self.p["batch"], self.p["horizon"]
        self.frame = tuple(self.p["frame"])
        texts = [t for _, t in self.run.cell.pool()]
        puzzles = [Puzzle.from_text(t) for t in texts]
        cp = compile_batch(puzzles)
        self.pidx = np.random.default_rng(self.run.seed).integers(0, len(texts), B)
        self.ref = [ref_puzzle.parse(t) for t in texts]
        tables = compile_framed_render_tables(puzzles, self.frame, n=cp.n, device=dev)
        self.env = VectorEnv(cp, max_steps=self.p["max_steps"], device=dev)
        self.last = LastStep(self.env)
        self.env.step = self.last
        pidx = torch.as_tensor(self.pidx, dtype=torch.int32, device=dev)
        self.actions = torch.empty((T, B), dtype=torch.int32, device=dev)
        self.gen = torch.Generator(device=dev)
        self._draw(-1)
        if dev.type == "cuda":
            self.graph = RolloutGraph(self.env, tables, pidx, T, True, None, actions=self.actions, trajectory=True)
        else:  # the tests' CPU path: the same rollout, run eagerly
            self.graph = _Eager(rollout, Trajectory.empty(T, B, self.frame, dev), self.env, tables, pidx, T,
                                self.actions)
        # The kept rows: two seed-drawn steps and the last.
        rows = np.random.default_rng([self.run.seed, 2]).choice(T - 1, 2, replace=False) if T > 2 else []
        self.rows = sorted(int(r) for r in rows) + [T - 1]
        self._fill()
        self.graph.replay()  # warm-up: every kernel of the window has run
        self._outputs(self.graph.replay())
        self.shapes = {"batch": B, "objects": int(cp.init_state.shape[-2]),
                       "action_bytes": self.actions.element_size(), "stacked": True, "frame": list(self.frame),
                       "table_bytes": sum(v.numel() * v.element_size() for v in tables.values())}
        self.n = 0

    def _draw(self, k: int) -> None:
        self.gen.manual_seed(replay_seed(self.run.seed, k))
        self.actions.random_(0, 4, generator=self.gen)

    def _fill(self) -> None:
        """The whole trajectory set to values the program never writes."""
        for name in TRAJECTORY:
            getattr(self.graph, name).fill_(True if name in ("terminated", "truncated") else float("nan"))

    def _replay(self, keep: bool = False):
        from torch.profiler import record_function

        with record_function("pwbench.draw"):
            self._draw(self.n)
        if keep:
            with record_function("pwbench.fill"):
                self._fill()
        with record_function("pwbench.replay"):
            total = self.graph.replay()
        self.n += 1
        return total

    def _outputs(self, total) -> dict:
        """Device copies of the last replay's actions and outputs."""
        g = self.graph
        return {"actions": self.actions.clone(), "total": total.clone(), "totals": self.last.reward_acc.clone(),
                "positions": self.last.positions.clone(), "obs": g.obs[self.rows],
                **{k: getattr(g, k).clone() for k in TRAJECTORY[1:]}}

    def window(self, seconds):
        rng = np.random.default_rng([self.run.seed, 1])
        due = sorted(rng.random(self.p["checks"] - 1) * seconds)
        t0 = time.perf_counter()
        first = self.n
        while True:
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            # One kept replay a due time: the host runs ahead of the card
            # and may pass two due times in one replay's launch.
            keep = bool(due) and now >= due[0]
            if keep:
                due.pop(0)
            total = self._replay(keep)
            if keep:
                self.kept.append(self._outputs(total))
        for _ in range(len(due) + 1):  # due times the window passed, and the last replay
            self.kept.append(self._outputs(self._replay(True)))
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        replays = self.n - first
        return {"attempted": replays, "failed": 0, "window_s": window_s, "replays": replays,
                "steps": replays * self.p["batch"] * self.p["horizon"], "horizon": self.p["horizon"],
                "shapes": self.shapes}

    def traced(self):
        """A slice of the same traffic: the mix's ``trace_replays`` replays."""
        first = self.n
        for _ in range(self.p["trace_replays"]):
            self._replay()
        n = self.n - first
        self.run.traced = {"replays": n, "lockstep_steps": n * self.p["horizon"]}

    def release(self):
        for k in self.kept:
            for name, v in list(k.items()):
                k[name] = float(v) if name == "total" else v.cpu().numpy()
            k["actions"] = k["actions"].astype(np.int64)
            k["positions"] = k["positions"].astype(np.int64)
        self.graph = self.env = self.last = self.actions = None

    def reference(self, k, rounding=None, step=None) -> dict:
        """The reference's outputs on kept replay ``k``'s actions, its
        observations at the kept rows (``rounding``, ``step``: the
        stand-ins of ``trajectory.rollout``)."""
        extra = {} if rounding is None else {"rounding": rounding}
        r = ref_traj.rollout(self.tables(), self.pidx, k["actions"], self.p["max_steps"], at=self.rows, step=step,
                             **extra)
        r["obs"] = [ref_traj.framed(self.ref, self.pidx, r["positions"][s], self.frame) for s in self.rows]
        return r

    def readings(self, k, r, movable) -> dict:
        """The compared numbers of kept replay ``k`` against the reference's
        (or a stand-in's) outputs ``r``; ``movable`` (B, N) marks each
        rollout's puzzle's movables."""
        last = r["last"]
        n = last.shape[1]
        differ = (k["positions"][:, :n] != last).any(-1) & movable
        steps = ((k["reward"] != r["reward"]) | (k["terminated"] != r["terminated"])
                 | (k["truncated"] != r["truncated"]))
        cells = sum(int((k["obs"][j] != r["obs"][j]).any(-1).sum()) for j in range(len(self.rows)))
        return {"obs_cells_differing": cells, "step_outputs_differing": int(steps.sum()),
                "reward_gap_per_rollout": float(np.abs(k["totals"].astype(np.float64) - r["totals"]).max()),
                "positions_differing": int(differ.sum()),
                "reward_total_gap": abs(k["total"] - float(np.asarray(r["totals"], np.float64).sum()))}

    def tables(self) -> dynamics.Tables:
        if getattr(self, "_tables", None) is None:
            self._tables = dynamics.Tables(self.ref)
        return self._tables

    def check(self):
        movable = self.tables().cmask[self.pidx].any(-1)
        worst = {}
        for k in self.kept:
            for name, v in self.readings(k, self.reference(k), movable).items():
                worst[name] = max(worst.get(name, 0), v)
        return [{"name": name, "value": v, "limit": self.run.cell.limits[name]} for name, v in worst.items()]


class _Eager:
    """The trajectory rollout run eagerly with the graph's interface (CPU
    tensors have no CUDA graph): ``replay()`` returns the reward total, the
    trajectory's buffers are attributes."""

    def __init__(self, rollout, trajectory, env, tables, pidx, horizon, actions):
        self.args = (env, tables, pidx, horizon, True, None)
        self.actions, self.rollout, self.trajectory = actions, rollout, trajectory
        for name in TRAJECTORY:
            setattr(self, name, getattr(trajectory, name))

    def replay(self):
        return self.rollout(*self.args, actions=self.actions, trajectory=self.trajectory)
