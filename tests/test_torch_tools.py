"""The port's toolkit against the JAX package's, on the CPU.

The same inputs (the fixtures under tests/puzzles, seeds) go through the JAX
function and its port: transforms, the generator, the benchmark harness,
PDDL / SAS export, the plot's curves, previews and the video helpers,
``run_process``, ``moved_mask`` and ``host_graph_distances``.  Everything is
exact except ``planning_time`` (a clock) and the PNG bytes of the plot (its
curve data is compared).  Anything of JAX's that plans uses the host
planner; the port plans on ``device="cpu"`` (the kernels' plain versions).
"""

import filecmp
import os
import shutil
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pushworld_tpu.core.puzzle import Puzzle as JPuzzle
from pushworld_tpu.search.planner import PlanResult as JPlanResult
from pushworld_tpu.tools import benchmark as jbench
from pushworld_tpu.tools import generate as jgen
from pushworld_tpu.tools import pddl as jpddl
from pushworld_tpu.tools import plot as jplot
from pushworld_tpu.tools import sas as jsas
from pushworld_tpu.tools import transform as jtrans
from pushworld_tpu.tools import visualization as jvis
from pushworld_tpu.utils import images2mp4 as jmp4
from pushworld_tpu.utils import process as jproc
from pushworld_tpu_torch.core.puzzle import Puzzle, plan_from_string
from pushworld_tpu_torch.search.planner import PlanResult
from pushworld_tpu_torch.tools import benchmark as tbench
from pushworld_tpu_torch.tools import generate as tgen
from pushworld_tpu_torch.tools import pddl as tpddl
from pushworld_tpu_torch.tools import plot as tplot
from pushworld_tpu_torch.tools import resolve_planner
from pushworld_tpu_torch.tools import sas as tsas
from pushworld_tpu_torch.tools import transform as ttrans
from pushworld_tpu_torch.tools import visualization as tvis
from pushworld_tpu_torch.utils import images2mp4 as tmp4
from pushworld_tpu_torch.utils import process as tproc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUZZLES = os.path.join(REPO, "tests", "puzzles")
FIXTURES = sorted(
    os.path.relpath(os.path.join(root, f), PUZZLES)[: -len(".pwp")]
    for root, _, files in os.walk(PUZZLES)
    for f in files
    if f.endswith(".pwp")
)


def _fixture(name):
    return os.path.join(PUZZLES, name + ".pwp")


def _assert_trees_equal(a, b):
    """Same relative file names under ``a`` and ``b``, same bytes."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)

    assert files(a) == files(b) and files(a)
    for f in files(a):
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


def _copy_fixtures(dst, names):
    os.makedirs(dst)
    for n in names:
        shutil.copy(_fixture(n), dst)
    return str(dst)


# ---------------------------------------------------------------- transforms


def test_action_maps_match_jax():
    assert ttrans.ACTION_MAPS == jtrans.ACTION_MAPS and len(ttrans.ACTION_MAPS) == 8


def test_puzzle_transforms_match_jax_on_every_fixture():
    assert len(FIXTURES) == 32
    for name in FIXTURES:
        with open(_fixture(name)) as f:
            text = f.read()
        assert ttrans.get_puzzle_transforms(text) == jtrans.get_puzzle_transforms(text), name


def test_create_transformed_puzzles_trees_equal(tmp_path):
    ttrans.create_transformed_puzzles(PUZZLES, str(tmp_path / "port"))
    jtrans.create_transformed_puzzles(PUZZLES, str(tmp_path / "jax"))
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    assert len(list((tmp_path / "port").rglob("*.pwp"))) == 8 * len(FIXTURES)


def test_transforms_produce_8_solvable_variants():
    """A known plan, mapped through each transform's action permutation,
    solves the transformed puzzle on the port's oracle."""
    with open(_fixture("simple")) as f:
        src = f.read()
    plan = plan_from_string("RR")
    transforms = ttrans.get_puzzle_transforms(src)
    assert set(transforms) == {"r0", "r90", "r180", "r270",
                               "r0_flipped", "r90_flipped", "r180_flipped", "r270_flipped"}
    assert transforms["r0"].split() == src.split()
    for name, text in transforms.items():
        assert Puzzle.from_text(text).is_valid_plan(ttrans.transform_plan(plan, name)), name


# ---------------------------------------------------------------- generation


@pytest.mark.parametrize("shapes", ["SIMPLE_SHAPES", "COMPLEX_SHAPES"])
def test_generate_puzzle_matches_jax(shapes):
    import random

    assert getattr(tgen, shapes) == getattr(jgen, shapes)
    for seed in range(6):
        for goals in (1, 2) if shapes == "COMPLEX_SHAPES" else (1,):
            args = (9 + seed, 8 + seed % 3, 3, 2, goals, getattr(tgen, shapes))
            t_rng, j_rng = random.Random(seed), random.Random(seed)
            for _ in range(3):  # a stream: each call draws from the same rng
                try:
                    want = jgen.generate_puzzle(*args, rng=j_rng)
                except jgen.FailedToGenerateError:
                    with pytest.raises(tgen.FailedToGenerateError):
                        tgen.generate_puzzle(*args, rng=t_rng)
                    continue
                assert tgen.generate_puzzle(*args, rng=t_rng) == want, (seed, goals)


def _generate_both(tmp_path, **kw):
    tgen.generate_level0_puzzles(str(tmp_path / "port"), **kw)
    kw = {k: v for k, v in kw.items() if k != "device"}
    jgen.generate_level0_puzzles(str(tmp_path / "jax"), **dict(kw, planner="host"))
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")


GENERATE_KW = dict(num_puzzles=6, random_seed=3, time_limit=5.0, min_puzzle_size=6, max_puzzle_size=8)


def test_generate_level0_host_matches_jax(tmp_path):
    _generate_both(tmp_path, planner="host", device="cpu", **GENERATE_KW)
    kept = sorted(os.listdir(tmp_path / "port"))
    assert kept == [f"puzzle_{i}.pwp" for i in range(len(kept))] and kept


@pytest.mark.parametrize("shapes,goals", [("simple", 1), ("complex", 2)])
def test_generate_unfiltered_matches_jax(tmp_path, shapes, goals):
    kw = dict(GENERATE_KW, num_puzzles=12, filter_puzzles=False, object_shapes=shapes,
              min_num_goal_objects=1, max_num_goal_objects=goals)
    _generate_both(tmp_path, **kw)


def test_generate_auto_on_the_cpu_is_the_host_planner(tmp_path, monkeypatch):
    """``planner="auto"`` on ``device="cpu"`` runs the host planner, as JAX's
    "auto" does on its CPU backend: the same kept set, every filter call
    made with ``planner="host"``."""
    import pushworld_tpu_torch.search.planner as planner_mod

    planners = []
    solve = planner_mod.solve_puzzle

    def recording(puzzle, **kw):
        planners.append(kw["planner"])
        return solve(puzzle, **kw)

    monkeypatch.setattr(planner_mod, "solve_puzzle", recording)
    _generate_both(tmp_path, planner="auto", device="cpu", **GENERATE_KW)
    assert planners == ["host"] * GENERATE_KW["num_puzzles"]


def test_generate_batched_on_the_cpu_keeps_the_host_set(tmp_path):
    """The batched search as the filter (one candidate it proves unsolvable,
    one it solves) keeps what the host planner keeps."""
    kw = dict(GENERATE_KW, num_puzzles=2, time_limit=120.0)
    tgen.generate_level0_puzzles(str(tmp_path / "batched"), planner="batched", device="cpu", **kw)
    tgen.generate_level0_puzzles(str(tmp_path / "host"), planner="host", device="cpu", **kw)
    _assert_trees_equal(tmp_path / "batched", tmp_path / "host")
    assert os.listdir(tmp_path / "host") == ["puzzle_0.pwp"]


def test_generate_validation_errors(tmp_path):
    with pytest.raises(ValueError):
        tgen.generate_level0_puzzles(str(tmp_path / "x"), num_puzzles=0, device="cpu")
    with pytest.raises(ValueError):
        tgen.generate_level0_puzzles(str(tmp_path / "y"), min_puzzle_size=9, max_puzzle_size=8, device="cpu")
    with pytest.raises(ValueError):
        tgen.generate_level0_puzzles(str(tmp_path / "z"), object_shapes="weird", device="cpu")


def test_planner_rule_and_no_fallback_without_a_card(tmp_path):
    cpu = torch.device("cpu")
    assert resolve_planner("auto", "cpu") == ("host", cpu)
    assert resolve_planner("batched", "cpu") == ("batched", cpu)
    assert resolve_planner("host", "cpu") == ("host", cpu)
    with pytest.raises(ValueError, match="unknown planner"):
        resolve_planner("fast", "cpu")
    if torch.cuda.is_available():
        assert resolve_planner("auto", "cuda")[0] == "batched"
        return
    for planner in ("auto", "batched", "host"):
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_planner(planner)
    with pytest.raises(RuntimeError, match="cuda"):
        tgen.generate_level0_puzzles(str(tmp_path / "gen"), num_puzzles=1, planner="auto")
    with pytest.raises(RuntimeError, match="cuda"):
        tbench.benchmark_planner(_fixture("simple"), str(tmp_path / "res"), planner="auto", progress=False)


# ---------------------------------------------------------------- benchmark


def _docs(path):
    out = {}
    for root, _, files in os.walk(path):
        for f in files:
            with open(os.path.join(root, f)) as fh:
                out[os.path.relpath(os.path.join(root, f), path)] = yaml.safe_load(fh)
    return out


def test_benchmark_host_documents_match_jax(tmp_path):
    """The YAML documents of ``planner="host"`` equal JAX's, ``planning_time``
    excepted: solved, no solution, and a nested tree."""
    src = tmp_path / "puzzles"
    _copy_fixtures(src, ["simple", "chain", "no_solution"])
    _copy_fixtures(src / "heur", ["heur/trivial", "heur/two_tools"])
    t_res = tbench.benchmark_planner(str(src), str(tmp_path / "port"), time_limit=30.0, planner="host",
                                     progress=False, device="cpu")
    j_res = jbench.benchmark_planner(str(src), str(tmp_path / "jax"), time_limit=30.0, planner="host",
                                     progress=False)
    assert sorted(t_res) == sorted(j_res)
    t_docs, j_docs = _docs(tmp_path / "port"), _docs(tmp_path / "jax")
    assert sorted(t_docs) == sorted(j_docs) and len(t_docs) == 5
    for name, t in t_docs.items():
        j = j_docs[name]
        assert list(t) == list(j), name
        assert {k: v for k, v in t.items() if k != "planning_time"} == \
               {k: v for k, v in j.items() if k != "planning_time"}, name
        assert t["planner"] == "pushworld-tpu host N+RGD" and t["planning_time"] >= 0
    assert t_docs["no_solution.yaml"]["failure_reason"] == "no solution"
    assert "failure_reason" not in t_docs["simple.yaml"]


def test_benchmark_time_limit_zero_matches_jax(tmp_path):
    path = _fixture("heur/shortest_path_tool")
    tbench.benchmark_planner(path, str(tmp_path / "port"), time_limit=0.0, planner="host", progress=False,
                             device="cpu")
    jbench.benchmark_planner(path, str(tmp_path / "jax"), time_limit=0.0, planner="host", progress=False)
    t, j = _docs(tmp_path / "port"), _docs(tmp_path / "jax")
    assert t == j
    doc = t["shortest_path_tool.yaml"]
    assert doc["failure_reason"] == "time limit" and doc["plan"] is None and doc["planning_time"] == 0.0


def test_benchmark_batched_on_the_cpu(tmp_path):
    src = _copy_fixtures(tmp_path / "puzzles", ["simple", "chain", "push_left"])
    res = tbench.benchmark_planner(src, str(tmp_path / "results"), time_limit=60.0, planner="batched",
                                   progress=False, device="cpu")
    assert sorted(res) == ["chain", "push_left", "simple"]
    for name, doc in _docs(tmp_path / "results").items():
        assert list(doc) == ["planner", "puzzle", "plan", "planning_time"], name
        assert doc["planner"] == "pushworld-tpu batched N+RGD" and doc["puzzle"] + ".yaml" == name
        assert Puzzle.from_file(_fixture(doc["puzzle"])).is_valid_plan(plan_from_string(doc["plan"]))
    # Existing results are skipped.
    again = tbench.benchmark_planner(src, str(tmp_path / "results"), time_limit=60.0, planner="batched",
                                     progress=False, device="cpu")
    assert again == {}


@pytest.mark.parametrize("reason,plan", [
    ("frontier exhausted after evictions", None), ("time limit", None), ("no solution", None),
    ("memory error", None), (None, [1, 1]), ("invalid plan", [0]),
])
def test_write_result_matches_jax(tmp_path, reason, plan):
    """Internal reasons map onto the reference's taxonomy as in JAX: the
    eviction outcome becomes "time limit" with ``planning_time`` the limit."""
    tbench._write_result(str(tmp_path / "port" / "p.yaml"), "x", "p", PlanResult(plan, 3.5, reason), 9.0)
    jbench._write_result(str(tmp_path / "jax" / "p.yaml"), "x", "p", JPlanResult(plan, 3.5, reason), 9.0)
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    if reason == "frontier exhausted after evictions":
        doc = _docs(tmp_path / "port")["p.yaml"]
        assert doc["failure_reason"] == "time limit" and doc["planning_time"] == 9.0


# --------------------------------------------------------------------- PDDL


@pytest.mark.parametrize("for_bfws", [False, True])
def test_puzzle_to_pddl_matches_jax_on_every_fixture(for_bfws):
    for name in FIXTURES:
        path = _fixture(name)
        want = jpddl.puzzle_to_pddl(os.path.basename(name) + " x", JPuzzle.from_file(path), for_bfws)
        got = tpddl.puzzle_to_pddl(os.path.basename(name) + " x", Puzzle.from_file(path), for_bfws)
        assert got == want, name


@pytest.mark.parametrize("for_bfws", [False, True])
def test_convert_all_puzzles_to_pddl_trees_equal(tmp_path, for_bfws):
    src = tmp_path / "puzzles"
    _copy_fixtures(src, ["simple", "multi_goal"])
    _copy_fixtures(src / "heur", ["heur/trivial_tool"])
    tpddl.convert_all_puzzles_to_pddl(str(tmp_path / "port"), str(src), for_bfws)
    jpddl.convert_all_puzzles_to_pddl(str(tmp_path / "jax"), str(src), for_bfws)
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    assert (tmp_path / "port" / "heur" / "trivial_tool_domain.pddl").exists()
    assert (tmp_path / "port" / "simple_problem.pddl").exists()


# ---------------------------------------------------------------------- SAS


def test_sas_refuses_without_fast_downward(tmp_path):
    with pytest.raises(RuntimeError, match="PUSHWORLD_FAST_DOWNWARD"):
        tsas.pddl_to_sas("d.pddl", "p.pddl", "o.sas", fast_downward_executable="")
    tpddl.convert_all_puzzles_to_pddl(str(tmp_path), _fixture("simple"))
    with pytest.raises(RuntimeError, match="PUSHWORLD_FAST_DOWNWARD"):
        tsas.convert_all_pddls_to_sas(str(tmp_path), fast_downward_executable="")


def _stub(tmp_path, exit_line):
    """A stand-in for fast-downward.py: writes its arguments into the
    ``--sas-file`` and prints ``exit_line``."""
    stub = tmp_path / "fd_stub.py"
    stub.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        args = sys.argv[1:]
        assert args[0] == "--translate" and args[1] == "--sas-file"
        with open(args[2], "w") as f:
            f.write("\\n".join(a.rsplit("/", 1)[-1] for a in args[3:]) + "\\n")
        print({exit_line!r})
        """))
    stub.chmod(0o755)
    return str(stub)


def test_convert_all_pddls_to_sas_pairs_and_names_as_jax(tmp_path):
    stub = _stub(tmp_path, "translate exit code: 0")
    for pkg, conv in (("port", tpddl), ("jax", jpddl)):
        src = tmp_path / f"puzzles_{pkg}"
        _copy_fixtures(src, ["simple", "chain"])
        _copy_fixtures(src / "heur", ["heur/trivial"])
        conv.convert_all_puzzles_to_pddl(str(tmp_path / pkg), str(src))
    tsas.convert_all_pddls_to_sas(str(tmp_path / "port"), fast_downward_executable=stub)
    jsas.convert_all_pddls_to_sas(str(tmp_path / "jax"), fast_downward_executable=stub)
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    with open(tmp_path / "port" / "heur" / "trivial.sas") as f:
        assert f.read().split() == ["trivial_domain.pddl", "trivial_problem.pddl"]
    bad = _stub(tmp_path / "puzzles_port", "translate exit code: 30")
    with pytest.raises(RuntimeError, match="Failed to convert"):
        tsas.convert_all_pddls_to_sas(str(tmp_path / "port"), fast_downward_executable=bad)


# --------------------------------------------------------------------- plot


def _results_tree(path):
    os.makedirs(path)
    for planner in ["alpha", "beta"]:
        for i, t in enumerate([0.0, 0.5, 2.0, 10.0]):
            doc = {"planner": planner, "puzzle": f"p{i}",
                   "plan": "RR" if (planner == "alpha" or i < 2) else None, "planning_time": t}
            with open(os.path.join(path, f"{planner}_p{i}.yaml"), "w") as f:
                yaml.safe_dump(doc, f)


def _curves(monkeypatch, fn, *args, **kwargs):
    """The (label, x, y) of every line ``fn`` plots."""
    import matplotlib
    from matplotlib.axes import Axes

    matplotlib.use("Agg")
    lines = []
    plot = Axes.plot

    def recording(self, x, y, *a, **kw):
        lines.append((kw.get("label"), list(x), list(y)))
        return plot(self, x, y, *a, **kw)

    monkeypatch.setattr(Axes, "plot", recording)
    fn(*args, **kwargs)
    monkeypatch.setattr(Axes, "plot", plot)
    return lines


def test_plot_curves_match_jax(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    rdir = str(tmp_path / "results")
    _results_tree(rdir)
    got = _curves(monkeypatch, tplot.plot_puzzles_solved_vs_time, rdir, str(tmp_path / "port.png"), 60)
    want = _curves(monkeypatch, jplot.plot_puzzles_solved_vs_time, rdir, str(tmp_path / "jax.png"), 60)
    assert got == want and [c[0] for c in got] == ["alpha", "beta"]
    assert got[0][1][0] == 0.5 and got[0][1][-1] == 60  # a zero time is clamped for the log axis
    assert (tmp_path / "port.png").stat().st_size > 0


def test_plot_rejects_duplicate_and_mismatched_results(tmp_path):
    pytest.importorskip("matplotlib")
    rdir = tmp_path / "results"
    _results_tree(str(rdir))
    with open(rdir / "alpha_again.yaml", "w") as f:
        yaml.safe_dump({"planner": "alpha", "puzzle": "p0", "plan": None, "planning_time": 1.0}, f)
    with pytest.raises(ValueError, match="multiple results"):
        tplot.plot_puzzles_solved_vs_time(str(rdir), str(tmp_path / "o.png"))
    os.remove(rdir / "alpha_again.yaml")
    with open(rdir / "gamma_only.yaml", "w") as f:
        yaml.safe_dump({"planner": "gamma", "puzzle": "px", "plan": None, "planning_time": 1.0}, f)
    with pytest.raises(ValueError, match="did not attempt"):
        tplot.plot_puzzles_solved_vs_time(str(rdir), str(tmp_path / "o.png"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="No result files"):
        tplot.plot_puzzles_solved_vs_time(str(tmp_path / "empty"), str(tmp_path / "o.png"))


# ----------------------------------------------------- visualization, videos


def test_render_previews_match_jax(tmp_path):
    from PIL import Image

    src = tmp_path / "puzzles"
    _copy_fixtures(src, ["simple", "lshape", "agent_wall"])
    _copy_fixtures(src / "heur", ["heur/two_tools", "heur/multiple_goals"])
    tvis.render_puzzle_previews(str(tmp_path / "port"), str(src))
    jvis.render_puzzle_previews(str(tmp_path / "jax"), str(src))
    names = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    assert names == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.png"))
    assert len(names) == 5
    for n in names:
        got = np.asarray(Image.open(tmp_path / "port" / n))
        assert np.array_equal(got, np.asarray(Image.open(tmp_path / "jax" / n))), n
        p = Puzzle.from_file(str(src / n.with_suffix(".pwp")))
        assert np.array_equal(got, p.render(p.initial_state)), n


def test_render_plans_hands_jax_frames_to_the_encoder(tmp_path, monkeypatch):
    """``render_plans`` gives the encoder the same frames and names as JAX's
    (the encoder itself needs ffmpeg); unsolved results are skipped and an
    unknown puzzle name raises."""
    src = _copy_fixtures(tmp_path / "puzzles", ["simple", "chain", "no_solution"])
    jbench.benchmark_planner(src, str(tmp_path / "results"), time_limit=30.0, planner="host", progress=False)
    calls = {"port": [], "jax": []}
    for pkg, mod in (("port", tvis), ("jax", jvis)):
        monkeypatch.setattr(mod, "images2mp4", lambda path, images, fps, _c=calls[pkg]: _c.append(
            (os.path.relpath(path, tmp_path / pkg), fps, np.stack(images))))
        mod.render_plans(str(tmp_path / "results"), str(tmp_path / pkg), src, fps=4.0)
    assert [c[:2] for c in calls["port"]] == [c[:2] for c in calls["jax"]] == [("chain.mp4", 4.0),
                                                                               ("simple.mp4", 4.0)]
    for (_, _, got), (_, _, want) in zip(calls["port"], calls["jax"]):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with open(tmp_path / "results" / "simple.yaml", "a") as f:
        f.write("puzzle: nowhere\n")
    with pytest.raises(ValueError, match="nowhere"):
        tvis.render_plans(str(tmp_path / "results"), str(tmp_path / "port2"), src)


def test_output_dims_match_jax():
    for h in range(1, 70, 3):
        for w in range(1, 70, 4):
            for m in (1, 50, 100, 101):
                assert tmp4._output_dims(h, w, m) == jmp4._output_dims(h, w, m), (h, w, m)


def test_images2mp4_refuses_without_ffmpeg(tmp_path, monkeypatch):
    frames = [np.zeros((4, 6, 3), np.uint8)] * 2
    monkeypatch.setattr(tmp4.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        tmp4.images2mp4(str(tmp_path / "v"), frames)
    with pytest.raises(ValueError, match="only 1 frames"):
        tmp4.images2mp4(str(tmp_path / "v"), frames[:1])
    with pytest.raises(ValueError, match="color_axis"):
        tmp4.images2mp4(str(tmp_path / "v"), frames, color_axis=1)


# ------------------------------------------------------------------ process


def test_run_process_matches_jax():
    cmd = [sys.executable, "-c", "print('hello'); print(sum(range(10)))"]
    t_out, t_cpu = tproc.run_process(cmd, time_limit=30, memory_limit=1 << 32)
    j_out, _ = jproc.run_process(cmd, time_limit=30, memory_limit=1 << 32)
    assert t_out == j_out == "hello\n45\n" and 0 <= t_cpu <= 30


def test_run_process_caps_cpu_time():
    """A child that spins is killed by RLIMIT_CPU and its CPU time is
    reported as the limit at most."""
    out, cpu = tproc.run_process([sys.executable, "-c", "print('go', flush=True)\nwhile True: pass"],
                                 time_limit=0.5)
    assert out == "go\n" and cpu == 0.5
    assert tproc.get_children_cpu_time() >= 0.5


# --------------------------------------------- moved_mask, host_graph_distances


@pytest.mark.parametrize("name", ["chain", "multi_goal", "heur/two_tools"])
def test_moved_mask_matches_jax(name):
    from pushworld_tpu.ops.step import moved_mask as j_moved_mask
    from pushworld_tpu_torch.ops.step import moved_mask

    p = Puzzle.from_file(_fixture(name))
    rng = np.random.default_rng(len(name))
    state, prev, nxt = p.initial_state, [], []
    for _ in range(40):
        s2 = p.get_next_state(state, int(rng.integers(0, 4)))
        prev.append(state)
        nxt.append(s2)
        state = s2
    prev, nxt = np.asarray(prev, np.int32), np.asarray(nxt, np.int32)
    got = moved_mask(torch.as_tensor(prev), torch.as_tensor(nxt))
    want = np.asarray(j_moved_mask(jnp.asarray(prev), jnp.asarray(nxt)))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want) and want.any() and not want.all()
    assert np.array_equal(moved_mask(torch.as_tensor(prev[0]), torch.as_tensor(nxt[0])).numpy(), want[0])


@pytest.mark.parametrize("name", ["trivial", "shortest_path_tool", "two_tools"])
def test_host_graph_distances_match_jax(name):
    from pushworld_tpu.ops.graphs import host_graph_distances as j_host_graph_distances
    from pushworld_tpu_torch.core.compiled import compile_puzzle
    from pushworld_tpu_torch.ops import graphs as tg

    p = Puzzle.from_file(_fixture("heur/" + name))
    E, _ = tg.build_reachability(compile_puzzle(p), device="cpu")
    E = E.numpy()
    rng = np.random.default_rng(0)
    for o in range(p.num_movables):
        got = tg.host_graph_distances(E[:, o])
        assert got.dtype == np.float32 and np.array_equal(got, j_host_graph_distances(E[:, o]))
        assert np.array_equal(got, tg.all_pairs_distances(torch.as_tensor(E[:, o])).numpy())
        sources = rng.random(got.shape[0]) < 0.5
        assert np.array_equal(tg.host_graph_distances(E[:, o], sources),
                              j_host_graph_distances(E[:, o], sources))
    empty = np.zeros_like(E[:, 0])
    assert np.array_equal(tg.host_graph_distances(empty), j_host_graph_distances(empty))


# --------------------------------------------------------- imports, exports


def test_search_reexports_are_the_ports_own():
    import pushworld_tpu_torch.search as search
    from pushworld_tpu_torch.search import heuristics_host, host_planner

    for name in ("MovementGraphs", "NoveltyHeuristic", "PathDistances", "RecursiveGraphDistance",
                 "WeightedSumHeuristic"):
        assert getattr(search, name) is getattr(heuristics_host, name)
    assert search.best_first_search is host_planner.best_first_search
    assert search.solve_host is host_planner.solve_host
    p = Puzzle.from_file(_fixture("simple"))
    assert p.is_valid_plan(search.solve_host(p))


def test_config_constants_match_jax():
    from pushworld_tpu import config as jconfig
    from pushworld_tpu_torch import config

    for name in ("PUZZLE_EXTENSION", "RESULT_EXTENSION", "DOMAIN_SUFFIX", "PROBLEM_SUFFIX",
                 "RGD_PLANNER_PATH", "FAST_DOWNWARD_PATH"):
        assert getattr(config, name) == getattr(jconfig, name), name


def test_map_files_with_extension_matches_jax(tmp_path):
    from pushworld_tpu.utils.filesystem import map_files_with_extension as j_map
    from pushworld_tpu_torch.utils.filesystem import map_files_with_extension

    for src in (PUZZLES, _fixture("heur/trivial")):
        got = map_files_with_extension(src, ".pwp", str(tmp_path / "port"), ".yaml")
        want = j_map(src, ".pwp", str(tmp_path / "jax"), ".yaml")
        assert [(a, os.path.relpath(b, tmp_path / "port")) for a, b in got] == \
               [(a, os.path.relpath(b, tmp_path / "jax")) for a, b in want]
    assert (tmp_path / "port" / "heur").is_dir()


def test_toolkit_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Every module this toolkit added imports with ``jax`` and
    ``pushworld_tpu`` blocked, in a process of its own."""
    code = """
import importlib, sys
for blocked in ("jax", "pushworld_tpu"):
    sys.modules[blocked] = None  # import raises ImportError
for mod in ("config", "utils.filesystem", "utils.process", "utils.images2mp4", "tools",
            "tools.transform", "tools.generate", "tools.benchmark", "tools.pddl", "tools.sas",
            "tools.plot", "tools.visualization", "scripts.tools_cli", "scripts.demo_gym_env",
            "scripts.demo_dm_env", "search", "ops.step", "ops.graphs"):
    importlib.import_module("pushworld_tpu_torch." + mod)
from pushworld_tpu_torch.scripts import tools_cli
tools_cli.main(["transform", sys.argv[1], sys.argv[2]])
print("imports ok")
"""
    src, out = _copy_fixtures(tmp_path / "puzzles", ["simple"]), tmp_path / "transformed"
    run = subprocess.run([sys.executable, "-c", code, src, str(out)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and run.stdout.strip() == "imports ok", run.stderr
    assert len(os.listdir(out)) == 8


def test_solve_puzzle_auto_stays_the_batched_search():
    """The port's ``solve_puzzle`` reads "auto" as the batched search on
    ``device``, also on the CPU, where JAX's runs the host planner; only the
    tools read "auto" by the device (``resolve_planner``)."""
    from pushworld_tpu.search.planner import solve_puzzle as j_solve_puzzle
    from pushworld_tpu_torch.search.planner import solve_puzzle

    got = solve_puzzle(Puzzle.from_file(_fixture("chain")), planner="auto", device="cpu")
    want = j_solve_puzzle(JPuzzle.from_file(_fixture("chain")), planner="auto")
    assert got.plan == want.plan == [1, 1]
    assert (got.expansions, want.expansions) == (2, 0)
