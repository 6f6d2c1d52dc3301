"""The RL traffic: lockstep rollouts, each one replay of the program's
rollout graph, back to back.

The environment is ``VectorEnv(puzzles, max_steps)`` of
``pushworld_tpu_torch.envs`` over the configuration's pool stacked
(``compile_batch``), each rollout's puzzle drawn from the seed; the rollout
is ``envs.throughput.RolloutGraph`` (on the card one CUDA graph a rollout:
``horizon`` steps of the env kernel).  The policy is the benchmark's:
before each replay a fresh (horizon, batch) block of uniform actions is
drawn on the device from the seed and the replay's index, into the tensor
the graph reads.

What the graph produces is read where the program hands it over: the
environment's ``step`` is wrapped (on this environment object only, before
the capture) so that the benchmark keeps the tensors of the graph's last
step: each rollout's running reward total (``reward_acc``) and its
positions before the step's reset.  The wrapper launches nothing; the
captured graph is the program's.

The window replays until ``seconds`` have passed, then waits for the card.
A sample of the window's replays, drawn from the seed (at seed-drawn times,
and the last), keeps its actions, the graph's reward total, each rollout's
total and its last positions.  The check runs the reference on each kept
replay's actions and compares all three.
"""

import time

import numpy as np
import torch

from pwbench.reference import dynamics, env as ref_env, puzzle as ref_puzzle

MASK63 = (1 << 63) - 1


def replay_seed(seed: int, k: int) -> int:
    """The action seed of replay ``k`` (-1: the warm-up) of run ``seed``."""
    return (seed * 1_000_003 + k + 1) & MASK63


class LastStep:
    """Wraps an environment's ``step``: keeps the reward accumulator it was
    given and the positions it returned (before the reset) of its last
    call."""

    def __init__(self, env):
        self.step = env.step
        self.reward_acc = self.positions = None

    def __call__(self, state, actions, reward_acc=None):
        out = self.step(state, actions, reward_acc=reward_acc)
        self.reward_acc, self.positions = reward_acc, out[1]
        return out


class Driver:
    def __init__(self, run):
        self.run = run
        self.p = run.cell.traffic["params"]
        self.kept = []

    def setup(self):
        from pushworld_tpu_torch.core.compiled import compile_batch
        from pushworld_tpu_torch.core.puzzle import Puzzle
        from pushworld_tpu_torch.envs.throughput import RolloutGraph, rollout
        from pushworld_tpu_torch.envs.vector_env import VectorEnv

        dev, B, T = self.run.device, self.p["batch"], self.p["horizon"]
        texts = [t for _, t in self.run.cell.pool()]
        cp = compile_batch([Puzzle.from_text(t) for t in texts])
        self.pidx = np.random.default_rng(self.run.seed).integers(0, len(texts), B)
        self.ref = [ref_puzzle.parse(t) for t in texts]
        self.env = VectorEnv(cp, max_steps=self.p["max_steps"], device=dev)
        self.last = LastStep(self.env)
        self.env.step = self.last
        pidx = torch.as_tensor(self.pidx, dtype=torch.int32, device=dev)
        self.actions = torch.empty((T, B), dtype=torch.int32, device=dev)
        self.gen = torch.Generator(device=dev)
        self._draw(-1)
        if dev.type == "cuda":
            self.graph = RolloutGraph(self.env, None, pidx, T, False, generator=None, actions=self.actions)
        else:  # the tests' CPU path: the same rollout, run eagerly
            self.graph = _Eager(rollout, self.env, pidx, T, self.actions)
        self.graph.replay()  # warm-up: every kernel of the window has run
        self.shapes = {"batch": B, "objects": int(cp.init_state.shape[-2]),
                       "action_bytes": self.actions.element_size(), "stacked": True}
        self.n = 0

    def _draw(self, k: int) -> None:
        self.gen.manual_seed(replay_seed(self.run.seed, k))
        self.actions.random_(0, 4, generator=self.gen)

    def _replay(self):
        from torch.profiler import record_function

        with record_function("pwbench.draw"):
            self._draw(self.n)
        with record_function("pwbench.replay"):
            total = self.graph.replay()
        self.n += 1
        return total

    def _keep(self, total) -> None:
        """Keeps the last replay's actions and outputs (device copies, read
        after the window)."""
        self.kept.append({"actions": self.actions.clone(), "total": total.clone(),
                          "totals": self.last.reward_acc.clone(), "positions": self.last.positions.clone()})

    def window(self, seconds):
        rng = np.random.default_rng([self.run.seed, 1])
        due = sorted(rng.random(self.p["checks"] - 1) * seconds)
        t0 = time.perf_counter()
        first = self.n
        total = None
        while True:
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            total = self._replay()
            if due and now >= due[0]:
                due = [d for d in due if d > now]
                self._keep(total)
        self._keep(total)
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
            k["actions"] = k["actions"].cpu().numpy().astype(np.int64)
            k["total"] = float(k["total"])
            k["totals"] = k["totals"].cpu().numpy()
            k["positions"] = k["positions"].cpu().numpy().astype(np.int64)
        self.graph = self.env = self.last = self.actions = None

    def readings(self, k, totals, last, movable) -> dict:
        """The compared numbers of kept replay ``k`` against a reference's
        (or a stand-in's) per-rollout ``totals`` and ``last`` positions;
        ``movable`` (B, N) marks each rollout's puzzle's movables."""
        n = last.shape[1]
        differ = (k["positions"][:, :n] != last).any(-1) & movable
        return {"reward_total_gap": abs(k["total"] - float(np.asarray(totals, np.float64).sum())),
                "reward_gap_per_rollout": float(np.abs(k["totals"].astype(np.float64) - totals).max()),
                "positions_differing": int(differ.sum())}

    def check(self):
        t = dynamics.Tables(self.ref)
        movable = t.cmask[self.pidx].any(-1)
        worst = {}
        for k in self.kept:
            totals, last = ref_env.rollout(t, self.pidx, k["actions"], self.p["max_steps"])
            for name, v in self.readings(k, totals, last, movable).items():
                worst[name] = max(worst.get(name, 0), v)
        return [{"name": name, "value": v, "limit": self.run.cell.limits[name]} for name, v in worst.items()]


class _Eager:
    """The rollout run eagerly with the graph's interface (CPU tensors have
    no CUDA graph): ``replay()`` returns the reward total."""

    def __init__(self, rollout, env, pidx, horizon, actions):
        self.args = (env, None, pidx, horizon, False, None)
        self.actions = actions
        self.rollout = rollout

    def replay(self):
        return self.rollout(*self.args, actions=self.actions)
