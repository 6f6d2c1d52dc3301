"""Where the environment's step spends its time on the card.

``python -m pushworld_tpu_torch.scripts.profile_env PUZZLE.pwp [MORE.pwp ...]``

On ``PUZZLE`` (``chip_smoke.py``'s 47 x 54 puzzle, say), at batch
``--batch`` and horizon ``--horizon``:

- ``alone``: the env kernel (``ops.step.env_step``, as ``VectorEnv.step``
  calls it: with each rollout's running reward total where the package
  takes one, and without) on one state, its device ms per traced launch
  (torch.profiler, ``--calls`` launches);
- ``eager_window``: eager steps of the throughput rollout (the draw, the
  step, the render), ``--window`` of them traced: kernels a step, device ms
  a step, and the env kernel's device ms per launch beside the renderer;
- ``graphed``: one profiled replay of ``envs.throughput.RolloutGraph`` with
  and without observations: kernels a step and device ms a step;
- ``throughput``: ``measure_env_throughput`` with and without observations
  (``steps_per_s``, ``hbm_roofline_pct``; no host baseline);
- ``greedy_broadcast``: the transition alone (``ops.step.step``) on the
  greedy policy's batch, the four actions over a stride-0 (4, B) broadcast
  of the states: one launch, its device ms;
- ``enqueue``: the host's time for ``--enqueue`` eager calls of
  ``env_step`` without a synchronisation, ms a call;
- each ``MORE`` puzzle (``chip_smoke.many_objects_text(n)``, say: above
  32 movables the kernel's wide path): the env kernel on ``--more-batch``
  rollouts after a few random steps, device ms per traced launch.

Prints one JSON line with the card's name and power limit.  Needs a CUDA
device.  The script uses only the package's public calls (and
``env_step``), so it also times another tree's package: run it with that
tree's root on ``PYTHONPATH``; a package whose ``env_step`` takes no
``reward_acc`` is timed without it (``"reward_acc": false``).
"""

import argparse
import inspect
import json
import time


def _profile(fn, reps):
    """(wall s, {kernel name: [count, device us]}) of ``fn`` called ``reps``
    times under torch.profiler; a trace that holds no device time (CUPTI
    now and then delivers none) is taken again, up to 6 traces."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    for attempt in range(6):
        if attempt:
            time.sleep(0.5 * attempt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        rows = {e.key: [e.count, dev_us(e)] for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and dev_us(e) > 0}
        if rows:
            return wall, rows
    raise RuntimeError("torch.profiler recorded no device time in 6 traces")


def _per_launch_ms(rows, name):
    """Device ms per traced launch of the kernels whose names hold ``name``,
    and the launches traced."""
    hit = [v for k, v in rows.items() if name in k]
    count = sum(c for c, _ in hit)
    if not count:
        raise RuntimeError(f"the trace holds no kernel named {name}: {sorted(rows)}")
    return sum(us for _, us in hit) / 1e3 / count, count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("puzzle", help="the .pwp puzzle of the throughput rollout")
    ap.add_argument("more", nargs="*", help="more .pwp puzzles, timed alone (above 32 movables: the wide path)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=128)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--enqueue", type=int, default=1000)
    ap.add_argument("--more-batch", type=int, default=1024)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.core.puzzle import Puzzle
    from pushworld_tpu_torch.device import card_info
    from pushworld_tpu_torch.envs import throughput
    from pushworld_tpu_torch.envs.vector_env import VectorEnv
    from pushworld_tpu_torch.ops import render
    from pushworld_tpu_torch.ops.step import env_step, step

    dev = torch.device("cuda", 0)
    B, horizon = args.batch, args.horizon
    takes_acc = "reward_acc" in inspect.signature(env_step).parameters
    out = {"card": card_info(), "torch": torch.__version__, "batch": B, "horizon": horizon, "reward_acc": takes_acc}

    puzzle = Puzzle.from_file(args.puzzle)
    cp = compile_puzzle(puzzle)
    tables = render.compile_render_tables(puzzle, cp, device=dev)
    env = VectorEnv(cp, max_steps=None, device=dev)
    pidx = torch.zeros(B, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = [env.reset(None, B, pidx)]
    acc = torch.zeros(B, dtype=torch.float32, device=dev)
    kw = {"reward_acc": acc} if takes_acc else {}

    def one_step(with_obs):  # a step of the rollout, eagerly, as envs/throughput.py takes it
        actions = torch.randint(0, 4, (B,), generator=gen, device=dev)
        state[0], pos, reward, _, _ = env.step(state[0], actions, **kw)
        if with_obs:
            render.render_cells_onehot_batched(tables, pos)
        if not takes_acc:
            acc.add_(reward.sum())

    for _ in range(8):
        one_step(True)
    st = state[0]
    a = torch.randint(0, 4, (B,), generator=gen, device=dev)
    step_args = (env.puzzles, st.positions, a, st.steps, st.achieved, None, env._init_pos, env._init_achieved, None)

    # alone
    alone = {}
    for key, call_kw in (("with_acc", kw), ("without_acc", {})):
        if key == "with_acc" and not takes_acc:
            continue
        fn = lambda: env_step(*step_args, **call_kw)  # noqa: E731
        fn()
        alone[key] = dict(zip(("device_ms", "traced"), _per_launch_ms(_profile(fn, args.calls)[1], "env_step")))
    out["alone"] = alone

    # eager_window
    window = {}
    for key, with_obs in (("obs", True), ("no_obs", False)):
        for _ in range(4):
            one_step(with_obs)
        wall, rows = _profile(lambda: one_step(with_obs), args.window)
        ms, traced = _per_launch_ms(rows, "env_step")
        window[key] = {"kernels_per_step": sum(c for c, _ in rows.values()) / args.window,
                       "device_ms_per_step": sum(us for _, us in rows.values()) / 1e3 / args.window,
                       "env_step_device_ms": ms, "env_step_traced": traced,
                       "wall_ms_per_step": wall / args.window * 1e3}
    out["eager_window"] = window

    # graphed
    graphed = {}
    for key, with_obs in (("obs", True), ("no_obs", False)):
        g = throughput.RolloutGraph(env, tables, pidx, horizon, with_obs, torch.Generator(device=dev))
        g.replay()
        wall, rows = _profile(g.replay, 1)
        graphed[key] = {"kernels_per_step": sum(c for c, _ in rows.values()) / horizon,
                        "device_ms_per_step": sum(us for _, us in rows.values()) / 1e3 / horizon,
                        "wall_ms_per_step_traced": wall / horizon * 1e3}
        del g
    out["graphed"] = graphed

    # throughput
    out["throughput"] = {}
    for key, with_obs in (("obs", True), ("no_obs", False)):
        r = throughput.measure_env_throughput(puzzle, batch_size=B, horizon=horizon, reps=3, observations=with_obs,
                                              host_baseline_steps=0, device=dev)
        out["throughput"][key] = {k: r[k] for k in ("steps_per_s", "hbm_roofline_pct")}

    # greedy_broadcast
    greedy = (env.puzzles, st.positions[None].expand(4, *st.positions.shape), torch.arange(4, device=dev)[:, None])
    step(*greedy)
    out["greedy_broadcast"] = dict(zip(("device_ms", "traced"),
                                       _per_launch_ms(_profile(lambda: step(*greedy), args.calls)[1], "env_step")))

    # enqueue
    for _ in range(20):
        env_step(*step_args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.enqueue):
        env_step(*step_args, **kw)
    enqueue_ms = (time.perf_counter() - t0) / args.enqueue * 1e3
    torch.cuda.synchronize()
    out["enqueue"] = {"calls": args.enqueue, "ms_per_call": enqueue_ms}

    # more puzzles
    more = {}
    rng = np.random.default_rng(1)
    for path in args.more:
        p = Puzzle.from_file(path)
        cpw = compile_puzzle(p)
        envw = VectorEnv(cpw, max_steps=6, device=dev)
        Bw = args.more_batch
        stw = envw.reset(None, Bw, torch.zeros(Bw, dtype=torch.int32))
        accw = torch.zeros(Bw, dtype=torch.float32, device=dev)
        kww = {"reward_acc": accw} if takes_acc else {}
        for _ in range(4):
            stw = envw.step(stw, torch.as_tensor(rng.integers(0, 4, Bw), device=dev), **kww)[0]
        aw = torch.as_tensor(rng.integers(0, 4, Bw), device=dev)
        argsw = (envw.puzzles, stw.positions, aw, stw.steps, stw.achieved, None, envw._init_pos,
                 envw._init_achieved, 6)
        fn = lambda: env_step(*argsw, **kww)  # noqa: E731
        fn()
        ms, traced = _per_launch_ms(_profile(fn, 20)[1], "env_step")
        more[cpw.n] = {"rollouts": Bw, "device_ms": ms, "traced": traced}
    out["more"] = more
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
