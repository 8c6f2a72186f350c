"""The port's training CLI end to end on the CPU, mirroring the
reference's end-to-end training test in ``tests/test_system.py``:
``python -m repro_torch.launch.train --arch minitron-4b --smoke --device
cpu`` checkpoints, and ``--resume`` continues from ``LATEST``; resumed
training ends in the straight run's state bit for bit; the example twin
passes the reference example's arguments; ``--device cuda`` without a
card fails instead of falling back."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.examples import train_lm
from repro_torch.launch import train as T
from repro_torch.train import optimizer as OPT

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", *args], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)


def test_train_cli_end_to_end(tmp_path):
    common = ["repro_torch.launch.train", "--arch", "minitron-4b", "--smoke",
              "--device", "cpu", "--batch", "2", "--seq", "32",
              "--ckpt-dir", str(tmp_path), "--log-every", "5"]
    r = _run(*common, "--steps", "12", "--ckpt-every", "6")
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[0].startswith("arch=minitron-4b-smoke params=0.9M "
                               "devices=1 (cpu)")
    assert sum(" loss " in line and " gnorm " in line and "tok/s" in line
               for line in lines) == 4                   # steps 0, 5, 10, 11
    assert lines[-1].startswith("done: 12 steps in")
    assert (tmp_path / "LATEST").read_text() == "step_000000012"
    assert (tmp_path / "step_000000006").is_dir()
    r2 = _run(*common, "--steps", "14", "--resume")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from step 12" in r2.stdout
    assert r2.stdout.splitlines()[-1].startswith("done: 2 steps in")


def test_resume_equals_the_straight_run(tmp_path):
    """8 steps with checkpoints at 4 and 8; a run that died after the
    save at step 4 (its directory holds only that checkpoint) resumed to
    8: the same losses for steps 4-7 and the same final state, bit for
    bit."""
    common = ["--arch", "minitron-4b", "--smoke", "--device", "cpu",
              "--batch", "2", "--seq", "16", "--steps", "8",
              "--ckpt-every", "4"]
    straight = T.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_000000004",
                    tmp_path / "b" / "step_000000004")
    (tmp_path / "b" / "LATEST").write_text("step_000000004")
    resumed = T.main(common + ["--ckpt-dir", str(tmp_path / "b"),
                               "--resume"])
    assert [s["step"] for s in resumed["steps"]] == [4, 5, 6, 7]
    assert ([s["loss"] for s in resumed["steps"]]
            == [s["loss"] for s in straight["steps"][4:]])
    a = OPT.sorted_leaves((straight["params"], straight["opt_state"]))
    b = OPT.sorted_leaves((resumed["params"], resumed["opt_state"]))
    assert len(a) == len(b) and all(torch.equal(x, y)
                                    for x, y in zip(a, b))
    assert int(resumed["opt_state"].step) == 8


def test_example_twin_passes_the_reference_arguments(tmp_path):
    """``examples/train_lm.py``'s argv (its checkpoint directory aside),
    then a short run of the twin on the CPU."""
    ref = ["--arch", "minitron-4b", "--smoke", "--steps", "200",
           "--batch", "8", "--seq", "64", "--ckpt-dir", "D",
           "--ckpt-every", "25"]
    assert train_lm.train_argv(200, "D") == ref
    assert train_lm.train_argv(200, "D", resume=True) == ref + ["--resume"]
    out = train_lm.main(["--steps", "2", "--device", "cpu", "--ckpt-dir",
                         str(tmp_path)])
    assert len(out["steps"]) == 2
    assert all(s["loss"] > 0 for s in out["steps"])


def test_cuda_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _run("repro_torch.launch.train", "--arch", "minitron-4b", "--smoke",
             "--steps", "1")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
