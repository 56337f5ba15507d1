"""The port's training examples on the CPU.

* ``repro_torch.examples.quickstart`` for 3 steps from the reference's
  initial weights (through the numpy bridge), against the reference's
  example run for the same 3 steps (its config, optimizer settings and
  pipeline, built here as ``examples/quickstart.py`` builds them): each
  step's loss within ``LOSS_RTOL`` = 2e-4 (the port's loss tolerance
  against the reference, ``test_torch_train.py``; measured 2.2e-5 at
  worst) and the params after the steps within that file's rule (largest
  difference at most 2.2 x the summed learning rates, mean at most
  ``PARAM_MEAN_TOL`` = 2e-4).
* ``repro_torch.examples.elastic_restart`` at world 1 (both meshes 1x1,
  the reference's stand-ins on one host): its continuity check holds and
  its losses are those of one uninterrupted run (the restore is exact).
  World 2 (1x2 then 2x1) is ``test_torch_distributed.py``'s.
* Both refuse to run without a card unless given ``--device cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig, SyntheticPipeline
from repro.models import build_model as j_build_model
from repro.models.config import ModelConfig as JModelConfig
from repro.train import optimizer as jopt
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch.examples import elastic_restart, quickstart
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.train import optimizer as topt

LOSS_RTOL = 2e-4
PARAM_MEAN_TOL = 2e-4
STEPS = 3


def test_quickstart_holds_to_the_reference(tmp_path, capsys):
    cfg = JModelConfig(name="quickstart-10m", family="dense", n_layers=4,
                       d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
                       d_ff=1024, vocab_size=2048)
    assert quickstart.CFG == quickstart.CFG.__class__(**{
        f: getattr(cfg, f) for f in quickstart.CFG.__dataclass_fields__})
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    opt = jopt.OptConfig(peak_lr=1e-3, warmup_steps=20, decay_steps=STEPS)
    state = jopt.init_opt_state(params, opt)
    step_fn = jax.jit(j_make_train_step(model, JTrainConfig(opt=opt)))
    data = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=256, global_batch=8, seed=0))
    start = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    want = []
    for step in range(STEPS):
        batch = jax.tree.map(jnp.asarray, data.batch_at(step))
        params, state, metrics = step_fn(params, state, batch)
        want.append(float(metrics["total_loss"]))

    rec = quickstart.run(["--steps", str(STEPS), "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)], params=start)
    np.testing.assert_allclose(rec["losses"], want, rtol=LOSS_RTOL)
    lr_sum = sum(float(topt.lr_schedule(topt.OptConfig(
        peak_lr=1e-3, warmup_steps=20, decay_steps=STEPS), torch.tensor(s)))
        for s in range(1, STEPS + 1))
    diff = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in zip(
        jax.tree.leaves(params_to_numpy(rec["params"])),
        jax.tree.leaves(params))])
    assert diff.max() <= 2.2 * lr_sum and diff.mean() <= PARAM_MEAN_TOL
    # 3 steps cannot pass the loss rule (a 300-step run does, on the card)
    assert rec["exit"] == 1 and rec["checkpoints"] == []
    assert rec["uniform"] == pytest.approx(np.log(2048))
    out = capsys.readouterr().out
    assert "model: quickstart-10m" in out and "final loss" in out


def test_elastic_restart_at_world_one(capsys):
    rec = elastic_restart.run(["--device", "cpu"])
    assert rec["ok"] and rec["restored_step"] == elastic_restart.SEGMENT
    assert rec["mesh_a"] == rec["mesh_b"] == {"data": 1, "model": 1}
    assert len(rec["phase1"]) == len(rec["phase2"]) == 30
    assert "continuity check: OK" in capsys.readouterr().out
    assert elastic_restart.main(["--device", "cpu"]) == 0


@pytest.mark.parametrize("example", [quickstart, elastic_restart])
def test_examples_need_a_card_or_cpu(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
