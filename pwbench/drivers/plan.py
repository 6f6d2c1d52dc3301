"""The planning traffic: one client, a closed loop of single solves.

Each request is ``solve_puzzle(puzzle, mode, time_limit, device, **capacities)``
of ``pushworld_tpu_torch.search.planner``, with the production capacities
(``PRODUCTION_CAPACITIES``) unless the mix names others; the next request
is sent when the last returns.  The puzzles are the configuration's pool,
in the seed's permutation of it, cycling: every seed sends the same pool
in another order.  A request is timed on the host clock from the call to
its return and a device synchronisation.

Set-up solves one puzzle of each distinct movable count in the pool (in
pool order, the same for every seed), so every shape the window sends has
run once.  The window sends requests until ``seconds`` have passed and
ends when the last one returns.

The check replays every plan the window returned with the reference;
a plan that does not reach the goal, and a "no solution" on a pooled puzzle
(each is solvable: its plan is in the pool), say the wrong thing.  A
request that ends without a plan otherwise (time limit, history full)
counts in ``failed``.
"""

import time

import numpy as np
import torch

from pwbench.reference import dynamics, puzzle as ref_puzzle


class Driver:
    def __init__(self, run):
        self.run = run
        self.params = run.cell.traffic["params"]
        self.results = []
        self.traced_results = []

    def _solve(self, i: int):
        from torch.profiler import record_function

        name, puzzle = self.pool[i]
        with record_function("pwbench.solve"):
            t0 = time.perf_counter()
            r = self.solve_puzzle(puzzle, mode=self.params["mode"], time_limit=self.params["time_limit"],
                                  device=self.run.device, **self.capacities)
            if self.run.device.type == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        return {"puzzle": name, "seconds": dt, "plan": r.plan, "failure": r.failure_reason,
                "iterations": int(r.iterations), "expansions": int(r.expansions)}

    def setup(self):
        from pushworld_tpu_torch.core.puzzle import Puzzle
        from pushworld_tpu_torch.search.planner import PRODUCTION_CAPACITIES, solve_puzzle

        self.solve_puzzle = solve_puzzle
        self.capacities = dict(PRODUCTION_CAPACITIES, **self.params.get("capacities", {}))
        texts = self.run.cell.pool()
        self.texts = dict(texts)
        self.pool = [(name, Puzzle.from_text(text)) for name, text in texts]
        self.order = np.random.default_rng(self.run.seed).permutation(len(self.pool))
        self.next = 0
        seen = set()
        for i, (_, p) in enumerate(self.pool):
            if p.num_movables not in seen:
                seen.add(p.num_movables)
                self._solve(i)

    def _request(self):
        r = self._solve(int(self.order[self.next % len(self.order)]))
        self.next += 1
        return r

    def window(self, seconds):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.results.append(self._request())
        window_s = time.perf_counter() - t0
        solved = [r for r in self.results if r["plan"] is not None]
        return {"attempted": len(self.results), "failed": len(self.results) - len(solved), "window_s": window_s,
                "solved": len(solved), "latencies_s": [r["seconds"] for r in solved],
                "iterations": [r["iterations"] for r in solved],
                "failures": sorted({r["failure"] for r in self.results if r["failure"]})}

    def traced(self):
        """A slice of the same traffic, from where the window stopped: the
        mix's ``trace_requests`` requests."""
        for _ in range(self.params["trace_requests"]):
            self.traced_results.append(self._request())
        self.run.traced = {"requests": len(self.traced_results)}

    def release(self):
        self.pool = None
        self.solve_puzzle = None

    def check(self):
        refs = {}
        wrong_plans = wrong_no_solution = 0
        for r in self.results + self.traced_results:
            if r["puzzle"] not in refs:
                refs[r["puzzle"]] = ref_puzzle.parse(self.texts[r["puzzle"]])
            if r["plan"] is not None:
                wrong_plans += not dynamics.plan_reaches_goal(refs[r["puzzle"]], r["plan"])
            elif r["failure"] == "no solution":
                wrong_no_solution += 1
        limits = self.run.cell.limits
        return [{"name": "plans_not_reaching_goal", "value": wrong_plans, "limit": limits["plans_not_reaching_goal"]},
                {"name": "no_solution_on_solvable", "value": wrong_no_solution,
                 "limit": limits["no_solution_on_solvable"]}]
