"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU, at the REDUCED smoke configs.

The crash drill is exact (tolerance 0): ``--fail-at`` exits with 17 after
the last periodic checkpoint is written, and ``--resume`` replays the
steps since that checkpoint with the losses of an uninterrupted run and
ends with its params and moments bit for bit (f32 and int8 moments).
``--mesh 2x1`` trains on two spawned gloo ranks with the losses of
``--mesh 1x1`` within ``MESH_LOSS_RTOL`` (2e-4, ``test_torch_train``'s
loss tolerance against the reference; measured 1.6e-5 at step 1: each
rank's bf16 gradient of half the batch, averaged in f32, against one
bf16 gradient of the whole, moves Adam's first update), while sharded
serving still refuses a data axis, naming ROADMAP A13c; without a card and
without ``--device cpu`` the CLI raises.
"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train as cli
from repro_torch.train import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = ["--device", "cpu", "--steps", "6", "--global-batch", "4",
        "--seq-len", "32", "--log-every", "1"]


def _bits_equal(a, b):
    flat_a, flat_b = ckpt._flatten(a), ckpt._flatten(b)
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (key, x), (_, y) in zip(flat_a, flat_b):
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8)), key


def test_trains_on_the_cpu(capsys):
    rec = cli.run(BASE)
    assert rec["exit"] == 0 and sorted(rec["losses"]) == list(range(6))
    out = capsys.readouterr().out
    assert out.count("loss") == 6 and "tok/s" in out
    assert all(torch.isfinite(torch.tensor(list(rec["losses"].values()))))


@pytest.mark.parametrize("moments", [[], ["--quantized-moments"]],
                         ids=["f32", "int8"])
def test_crash_drill_resumes_bit_for_bit(tmp_path, moments):
    argv = BASE + moments + ["--ckpt-every", "2"]
    whole = cli.run(argv)
    ckpt_dir = ["--ckpt-dir", str(tmp_path)]
    crashed = cli.run(argv + ckpt_dir + ["--fail-at", "3"])
    assert crashed["exit"] == cli.CRASH_EXIT == 17
    assert sorted(crashed["losses"]) == [0, 1, 2]
    assert ckpt.CheckpointManager(str(tmp_path)).all_steps() == [2]
    resumed = cli.run(argv + ckpt_dir + ["--resume"])
    assert resumed["exit"] == 0 and resumed["start_step"] == 2
    assert resumed["losses"] == {s: whole["losses"][s] for s in range(2, 6)}
    assert crashed["losses"] == {s: whole["losses"][s] for s in range(3)}
    _bits_equal({"p": resumed["params"], "o": resumed["opt"]},
                {"p": whole["params"], "o": whole["opt"]})
    assert ckpt.CheckpointManager(str(tmp_path)).all_steps() == [2, 4, 6]


def test_fail_at_exits_17_from_the_command_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *BASE,
         "--steps", "3", "--fail-at", "1", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "1"], env=env, cwd=str(ROOT), timeout=300,
        capture_output=True, text=True)
    assert proc.returncode == 17, proc.stderr
    assert "[drill] injected crash at step 1" in proc.stdout


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-2b",
                                  "qwen3-moe-30b-a3b", "falcon-mamba-7b"])
def test_other_families_train(arch):
    rec = cli.run(["--arch", arch, "--device", "cpu", "--steps", "2",
                   "--global-batch", "2", "--seq-len", "16",
                   "--microbatches", "2"])
    assert rec["exit"] == 0 and len(rec["losses"]) == 2


MESH_LOSS_RTOL = 2e-4


def test_mesh_above_one_device_names_a13():
    """Sharded training is ported: ``--mesh 2x1`` spawns its two ranks
    and returns rank 0's losses, those of ``--mesh 1x1``. Sharded serving
    runs the model axis alone: the serving CLI's ``--mesh 2x1`` (a data
    axis) still names its ROADMAP item (A13c)."""
    argv = BASE[:2] + ["--steps", "3", "--global-batch", "4",
                       "--seq-len", "32"]
    one = cli.run(argv)
    two = cli.run(argv + ["--mesh", "2x1"])
    assert two["exit"] == 0 and sorted(two["losses"]) == [0, 1, 2]
    for s in range(3):
        assert abs(two["losses"][s] - one["losses"][s]) <= (
            MESH_LOSS_RTOL * abs(one["losses"][s]))
    from repro_torch.launch import serve as serve_cli
    with pytest.raises(NotImplementedError, match="A13c"):
        serve_cli.run(["--device", "cpu", "--mesh", "2x1"])


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--steps", "1"])
