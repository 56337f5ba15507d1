"""The port's checkpoints: atomic, async, keep-k, device-agnostic, with
the standard library alone.

The port's format is its own (a JSON manifest and zlib-compressed raw
leaf bytes; the reference writes msgpack and zstandard, neither of which
the card's machine has), so nothing here reads the reference's files.
Every check is exact (tolerance 0): leaves restore bit for bit with their
dtype and shape, int8 ``QTensor`` moments included, and a run that
crashes, restores its latest checkpoint and goes on ends with the same
params and moments bit for bit as a run that never stopped (the
counterpart of ``tests/test_system.py::
test_checkpoint_restart_is_bit_exact``).
"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import FailureInjector
from repro_torch.train.loop import TrainConfig, make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ModelConfig(name="tiny-lm", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                   vocab_size=256)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(3, 300, generator=g),
              "nested": {"b16": torch.randn(5, 7, generator=g).bfloat16(),
                         "norm": torch.randn(7, generator=g)}}
    opt = topt.init_opt_state(params, topt.OptConfig(quantized_moments=True))
    opt = topt.adamw_update(params, {"w": torch.randn(3, 300, generator=g),
                                     "nested": {
                                         "b16": torch.randn(5, 7, generator=g),
                                         "norm": torch.randn(7, generator=g)}},
                            opt, topt.OptConfig(quantized_moments=True))[1]
    return {"params": params, "opt": opt}


def _bits_equal(a, b):
    flat_a, flat_b = ckpt._flatten(a), ckpt._flatten(b)
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (key, x), (_, y) in zip(flat_a, flat_b):
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8)), key


def test_round_trip_is_bit_for_bit_with_int8_moments(tmp_path):
    state = _state()
    assert isinstance(state["opt"]["m"]["w"], topt.QTensor)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state, extra={"loss": 1.5}, blocking=True)
    assert mgr.all_steps() == [4] and mgr.manifest(4)["loss"] == 1.5
    step, back = mgr.restore(_state(seed=1))
    assert step == 4
    assert isinstance(back["opt"]["m"]["w"], topt.QTensor)
    _bits_equal(back, state)
    saved, restored = mgr.records
    assert (saved["op"], saved["step"], restored["op"]) == ("save", 4,
                                                            "restore")
    raw = sum(t.numel() * t.element_size() for _, t in ckpt._flatten(state))
    assert saved["raw_bytes"] == restored["raw_bytes"] == raw
    assert saved["disk_bytes"] == os.path.getsize(
        tmp_path / f"step_{4:010d}" / "state.bin")


def test_restore_needs_only_the_template_s_shapes(tmp_path):
    """Leaves are stored logically: a template on the meta device (shapes
    and dtypes, no data) restores onto the device it is given."""
    state = _state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=True)
    template = ckpt._unflatten(state, {k: torch.empty_like(t, device="meta")
                                       for k, t in ckpt._flatten(state)})
    _, back = mgr.restore(template, device="cpu")
    _bits_equal(back, state)
    bad = {"params": {**state["params"], "w": torch.zeros(3, 301)},
           "opt": state["opt"]}
    with pytest.raises(ValueError, match="params/w"):
        mgr.restore(bad)


def test_a_save_that_dies_leaves_the_latest_checkpoint(tmp_path,
                                                       monkeypatch):
    """A step directory appears only by the rename of a finished tmp dir:
    a save that fails before it leaves no step behind, the previous
    checkpoint stays the latest, and the error reaches the caller."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(), blocking=True)
    real_rename = os.rename

    def dies(src, dst):
        raise OSError("disk gone")

    monkeypatch.setattr(os, "rename", dies)
    mgr.save(2, _state(seed=2))
    with pytest.raises(OSError, match="disk gone"):
        mgr.wait()
    monkeypatch.setattr(os, "rename", real_rename)
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    assert (tmp_path / ".tmp-2").exists()       # never listed as a step
    _, back = mgr.restore(_state(seed=3))
    _bits_equal(back, _state())


def test_keep_k_prunes_old_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(1, 6):
        mgr.save(step, {"x": torch.full((4,), float(step))})
    mgr.wait()
    assert mgr.all_steps() == [4, 5]
    assert mgr.restore({"x": torch.zeros(4)})[1]["x"][0] == 5.0


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore({"x": torch.zeros(1)})


def test_checkpoint_restart_is_bit_exact(tmp_path):
    """Crash at step 6, restore from the step-6 checkpoint, and the restarted
    run ends with the same params and moments as the uninterrupted run."""
    model = build_model(TINY, device="cpu")
    tcfg = TrainConfig(opt=topt.OptConfig(
        peak_lr=3e-3, warmup_steps=10, decay_steps=200, weight_decay=0.0))
    step_fn = make_train_step(model, tcfg)
    data = SyntheticPipeline(DataConfig(vocab_size=TINY.vocab_size,
                                        seq_len=64, global_batch=8, seed=7,
                                        branching=2))

    def fresh():
        p = model.init(torch.Generator().manual_seed(0))
        return p, topt.init_opt_state(p, tcfg.opt)

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}

    p, s = fresh()
    for i in range(10):
        p, s, _ = step_fn(p, s, batch(i))
    want = {"params": p, "opt": s}

    mgr = CheckpointManager(str(tmp_path), keep=2)
    inj = FailureInjector(fail_at_steps=(6,), kind="crash")
    p, s = fresh()
    crashed_at = None
    for i in range(10):
        if inj.check(i):
            crashed_at = i
            break
        p, s, _ = step_fn(p, s, batch(i))
        if (i + 1) % 3 == 0:
            mgr.save(i + 1, {"params": p, "opt": s})
    mgr.wait()
    assert crashed_at == 6 and mgr.latest_step() == 6
    del p, s
    template_p, template_s = fresh()
    start, restored = mgr.restore({"params": template_p,
                                   "opt": template_s})
    p, s = restored["params"], restored["opt"]
    for i in range(start, 10):
        p, s, _ = step_fn(p, s, batch(i))
    _bits_equal({"params": p, "opt": s}, want)


def test_checkpoints_need_no_msgpack_or_zstandard(tmp_path):
    """A save and a restore where ``msgpack``, ``zstandard``, ``ml_dtypes``
    and ``jax`` cannot be imported."""
    code = (
        "import sys\n"
        "for name in ('msgpack', 'zstandard', 'ml_dtypes', 'jax'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from repro_torch.train import optimizer as topt\n"
        "from repro_torch.train.checkpoint import CheckpointManager\n"
        "p = {'w': torch.randn(4, 300), 'b': torch.randn(3).bfloat16()}\n"
        "s = topt.init_opt_state(p, topt.OptConfig(quantized_moments=True))\n"
        f"mgr = CheckpointManager({str(tmp_path)!r})\n"
        "mgr.save(3, {'p': p, 's': s}, blocking=True)\n"
        "step, back = mgr.restore({'p': p, 's': s})\n"
        "assert step == 3 and torch.equal(back['p']['w'], p['w'])\n"
        "assert torch.equal(back['p']['b'], p['b'])\n"
        "assert torch.equal(back['s']['m']['w'].q, s['m']['w'].q)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)
