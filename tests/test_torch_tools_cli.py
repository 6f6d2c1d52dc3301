"""The port's tools CLI and demo scripts against the JAX package's, on the CPU.

- every subcommand parses the same arguments as JAX's (the port adds
  ``--device`` to ``benchmark`` and ``generate-level0``);
- ``transform``, ``convert-to-pddl``, ``generate-level0`` (unfiltered, and
  filtered on ``--device cpu``, where ``planner="auto"`` is the host planner
  as on JAX's CPU backend) and ``benchmark --device cpu`` run end to end in
  this process and write what JAX's CLI writes;
- the Gym and dm_env demos run under the ``Agg`` backend with key presses
  sent to their figure, and show the same images as JAX's demos.
"""

import argparse
import filecmp
import importlib
import os
import shutil

import numpy as np
import pytest
import yaml

from pushworld_tpu.scripts import tools_cli as jcli
from pushworld_tpu_torch.core.puzzle import Puzzle, plan_from_string
from pushworld_tpu_torch.scripts import tools_cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUZZLES = os.path.join(REPO, "tests", "puzzles")


def _fixture(name):
    return os.path.join(PUZZLES, name + ".pwp")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


def _assert_trees_equal(a, b):
    assert _tree(a) == _tree(b) and _tree(a)
    for f in _tree(a):
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


class _Parsed(Exception):
    pass


def _parsed(main, argv, monkeypatch):
    """The namespace ``main(argv)`` parses; nothing runs."""
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    try:
        with pytest.raises(_Parsed) as e:
            main(argv)
    finally:
        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    return vars(e.value.args[0])


ARGVS = [
    ["benchmark"],
    ["benchmark", "--puzzles-path", "p", "--results-path", "r", "--heuristic", "RGD", "--time-limit", "7",
     "--planner", "host"],
    ["convert-to-pddl", "out"],
    ["convert-to-pddl", "out", "--puzzle-path", "p", "--for-bfws"],
    ["convert-to-sas", "pddl"],
    ["convert-to-sas", "pddl", "--fast-downward", "/x/fd.py"],
    ["transform", "in", "out"],
    ["generate-level0", "save"],
    ["generate-level0", "save", "--num-puzzles", "3", "--random-seed", "9", "--no-filter", "--time-limit", "4",
     "--object-shapes", "simple"],
    ["plot", "results"],
    ["plot", "results", "--output", "o.png", "--timeout", "60"],
    ["render-previews", "images"],
    ["render-previews", "images", "--puzzle-path", "p"],
    ["render-plans", "results", "videos"],
    ["render-plans", "results", "videos", "--puzzle-path", "p", "--fps", "3"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "_".join(a))
def test_arguments_parse_as_jax(argv, monkeypatch):
    got = _parsed(tcli.main, argv, monkeypatch)
    want = _parsed(jcli.main, argv, monkeypatch)
    plans = argv[0] in ("benchmark", "generate-level0")
    assert got.pop("device", None) == ("cuda" if plans else None)
    assert got == want
    if plans:
        assert _parsed(tcli.main, argv + ["--device", "cpu"], monkeypatch)["device"] == "cpu"
    else:
        with pytest.raises(SystemExit):
            tcli.main(argv + ["--device", "cpu"])


def test_bad_arguments_exit_as_jax(capsys):
    for argv in (["benchmark", "--planner", "fast"], ["generate-level0"], ["nothing"], []):
        for main in (tcli.main, jcli.main):
            with pytest.raises(SystemExit) as e:
                main(argv)
            assert e.value.code == 2, argv
    capsys.readouterr()


def _run_both(tmp_path, argv_for):
    """Runs ``argv_for(out)`` through both CLIs, each into its own ``out``."""
    for pkg, main in (("port", tcli.main), ("jax", jcli.main)):
        assert main(argv_for(str(tmp_path / pkg))) == 0
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")


def test_transform_end_to_end(tmp_path):
    _run_both(tmp_path, lambda out: ["transform", os.path.join(PUZZLES, "heur"), out])
    assert len(_tree(tmp_path / "port")) == 8 * 15


@pytest.mark.parametrize("bfws", [[], ["--for-bfws"]])
def test_convert_to_pddl_end_to_end(tmp_path, bfws):
    src = tmp_path / "puzzles"
    os.makedirs(src / "heur")
    for n in ("simple", "chain"):
        shutil.copy(_fixture(n), src)
    shutil.copy(_fixture("heur/trivial"), src / "heur")
    _run_both(tmp_path, lambda out: ["convert-to-pddl", out, "--puzzle-path", str(src)] + bfws)
    assert len(_tree(tmp_path / "port")) == 6


def test_generate_level0_unfiltered_end_to_end(tmp_path):
    _run_both(tmp_path, lambda out: ["generate-level0", out, "--num-puzzles", "7", "--random-seed", "5",
                                     "--no-filter", "--object-shapes", "simple"])
    assert _tree(tmp_path / "port") == [f"puzzle_{i}.pwp" for i in range(7)]


def test_generate_level0_filtered_on_the_cpu_end_to_end(tmp_path, capsys):
    """The filter's planner is "auto", which on ``--device cpu`` is the host
    planner, as in JAX's CLI on its CPU backend."""
    argv = ["generate-level0", None, "--num-puzzles", "2", "--random-seed", "0", "--time-limit", "30"]
    assert tcli.main([argv[0], str(tmp_path / "port")] + argv[2:] + ["--device", "cpu"]) == 0
    assert jcli.main([argv[0], str(tmp_path / "jax")] + argv[2:]) == 0
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    out = capsys.readouterr().out.splitlines()
    assert out == ["1/2 were solvable"] * 2


def test_benchmark_end_to_end_on_the_cpu(tmp_path, capsys):
    src = tmp_path / "puzzles"
    os.makedirs(src)
    for n in ("simple", "no_solution"):
        shutil.copy(_fixture(n), src)
    for pkg, main, extra in (("port", tcli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        assert main(["benchmark", "--puzzles-path", str(src), "--results-path", str(tmp_path / pkg),
                     "--time-limit", "30", "--planner", "host"] + extra) == 0
    capsys.readouterr()
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") == ["no_solution.yaml", "simple.yaml"]
    for f in _tree(tmp_path / "port"):
        with open(tmp_path / "port" / f) as a, open(tmp_path / "jax" / f) as b:
            got, want = yaml.safe_load(a), yaml.safe_load(b)
        got.pop("planning_time"), want.pop("planning_time")
        assert got == want, f
    with open(tmp_path / "port" / "simple.yaml") as f:
        plan = plan_from_string(yaml.safe_load(f)["plan"])
    assert Puzzle.from_file(_fixture("simple")).is_valid_plan(plan)


# ---------------------------------------------------------------------- demos


KEYS = ("right", "x", "r", "down", "right", "right", "left")


def _shown_images(main, monkeypatch):
    """Runs a demo's ``main`` on ``simple`` (2-step plan "RR", 5 steps at
    most) with ``plt.show`` sending ``KEYS`` and then "q" to the figure;
    returns the image after each key."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backend_bases import KeyEvent

    shown = []

    def show():
        fig = plt.gcf()
        image = fig.axes[0].images[0]
        shown.append(np.array(image.get_array()))
        for key in KEYS + ("q",):
            fig.canvas.callbacks.process("key_press_event", KeyEvent("key_press_event", fig.canvas, key))
            shown.append(np.array(image.get_array()))

    monkeypatch.setattr(plt, "show", show)
    assert main([_fixture("simple"), "--max-steps", "5"]) == 0
    plt.close("all")
    return shown


@pytest.mark.parametrize("demo,package", [("demo_gym_env", "gymnasium"), ("demo_dm_env", "dm_env")])
def test_demo_shows_the_jax_demos_images(demo, package, monkeypatch):
    pytest.importorskip(package, reason=f"{package} not installed")
    monkeypatch.setenv("MPLBACKEND", "Agg")
    port = importlib.import_module(f"pushworld_tpu_torch.scripts.{demo}")
    jax_demo = importlib.import_module(f"pushworld_tpu.scripts.{demo}")
    got = _shown_images(port.main, monkeypatch)
    want = _shown_images(jax_demo.main, monkeypatch)
    assert len(got) == len(want) == len(KEYS) + 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and np.array_equal(g, w), i
    assert not np.array_equal(got[0], got[1])  # "right" moved the agent
    assert np.array_equal(got[0], got[3])  # "r" reset
