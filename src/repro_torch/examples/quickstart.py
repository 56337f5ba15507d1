"""Quickstart: train a ~10M-param decoder LM for 300 steps on the synthetic
Markov pipeline, with checkpoints: the end-to-end driver in one file.

The counterpart of ``examples/quickstart.py``, with its config, optimizer
settings, pipeline and pass rule (the final loss under 0.8 x the uniform
loss, ln 2048). On the card by default (flash at D = Dv = 32 in every
attention layer, under the ``h100`` target)::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--steps 300] [--device cpu]

Checkpoints go through the port's ``CheckpointManager`` every 100 steps,
into ``--ckpt-dir`` or a temporary directory removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.core.target import use_target
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.launch.serve import serving_target
from repro_torch.models import build_model
from repro_torch.models.api import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import TrainConfig, make_train_step
from repro_torch.train.optimizer import tree_leaves

CFG = ModelConfig(                          # ~10M params
    name="quickstart-10m", family="dense",
    n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
    d_ff=1024, vocab_size=2048)
SEQ_LEN, GLOBAL_BATCH = 256, 8


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None,
                    help="keep the checkpoints here (default: a temporary "
                         "directory, removed at the end)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    return ap.parse_args(argv)


def run(argv=None, *, params: Optional[Any] = None) -> Dict[str, Any]:
    """Train; returns ``{exit, losses [per step], final, uniform, tok_per_s,
    checkpoints [steps]}``: ``exit`` 0 when the final loss is under 0.8 x
    uniform. ``params`` (a tree like ``Model.init``'s, f32) replaces the
    seeded init (the tests pass the reference's through the bridge)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    target = serving_target(dev)
    with use_target(target) if target else contextlib.nullcontext():
        return _run(args, dev, params)


def _run(args, dev: torch.device, params) -> Dict[str, Any]:
    model = build_model(CFG, device=dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {CFG.name}, {n_params / 1e6:.1f}M params")

    tcfg = TrainConfig(opt=opt_mod.OptConfig(
        peak_lr=1e-3, warmup_steps=20, decay_steps=args.steps))
    state = opt_mod.init_opt_state(params, tcfg.opt)
    step_fn = make_train_step(model, tcfg)

    data = SyntheticPipeline(DataConfig(
        vocab_size=CFG.vocab_size, seq_len=SEQ_LEN,
        global_batch=GLOBAL_BATCH, seed=0))
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="quickstart_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=2)

    it = data.iterator(depth=2)
    losses, tput = [], 0.0
    t0 = time.time()
    try:
        for step in range(args.steps):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in next(it).items()}
            params, state, metrics = step_fn(params, state, batch)
            losses.append(float(metrics["total_loss"]))      # sync point
            tput = GLOBAL_BATCH * SEQ_LEN * (step + 1) / (time.time() - t0)
            if step % 25 == 0 or step == args.steps - 1:
                print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                      f"({tput:.0f} tok/s)", flush=True)
            if (step + 1) % 100 == 0:
                mgr.save(step + 1, {"params": params, "opt": state})
        mgr.wait()
        steps = mgr.all_steps()
    finally:
        it.close()
        mgr.wait()
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"checkpoints: {steps} in "
          + (ckpt_dir if args.ckpt_dir else "a temporary directory"))
    final = losses[-1]
    uniform = math.log(CFG.vocab_size)
    print(f"final loss {final:.3f} (uniform would be {uniform:.2f}; "
          f"markov optimum ~{math.log(4.0):.2f})")
    return {"exit": 0 if final < 0.8 * uniform else 1, "losses": losses,
            "final": final, "uniform": uniform, "tok_per_s": tput,
            "checkpoints": steps, "params": params}


def main(argv=None) -> int:
    return run(argv)["exit"]


if __name__ == "__main__":
    sys.exit(main())
