"""Fault-tolerance drill: train, crash (simulated), restart from the atomic
checkpoint on a DIFFERENT mesh shape, and check that the loss trajectory
continues: the elastic-restart contract at example scale.

The counterpart of ``examples/elastic_restart.py``. Phase 1 trains 30
steps on mesh A and saves at step 30 (full arrays, gathered from the
shards); ``RestartPolicy`` and ``elastic_mesh_shape`` decide the recovery
of a lost host; phase 2 restores the checkpoint onto mesh B (each rank
cuts its own shards) and trains 30 more steps. The continuity check: phase
2's first loss is below phase 1's first, and its last no more than 0.05
above its first.

With ``--world N`` the drill runs on N ranks of this host (gloo on the
CPU, NCCL on the card, one GPU a rank), mesh A ``1xN`` (data x model) and
mesh B ``Nx1``; with one rank (the default) both meshes are ``1x1``, as the
reference's stand-ins are on one host::

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart [--device cpu] [--world 2]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.core.target import use_target
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import serving_target
from repro_torch.launch.train import log
from repro_torch.models import build_model
from repro_torch.models.api import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import RestartPolicy, elastic_mesh_shape
from repro_torch.train.loop import (TrainConfig, make_train_step, place,
                                    state_placements)

CFG = ModelConfig(name="elastic-demo", family="dense", n_layers=2,
                  d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                  d_ff=128, vocab_size=256)
SEGMENT = 30


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--world", type=int, default=1,
                    help="ranks of this host: mesh A is 1xN, mesh B Nx1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    return ap.parse_args(argv)


def run_segment(params, state, data, start, stop, step_fn, dev):
    losses = []
    for i in range(start, stop):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch_at(i).items()}
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["total_loss"]))
    return params, state, losses


def drill(world: int, device: torch.device, ckpt: str) -> Dict[str, Any]:
    """Both phases on the ranks of the current process group (every rank
    calls it)."""
    mesh_a = mesh_lib.make_host_mesh(1, world, device)
    model = build_model(CFG, device=mesh_a.device)
    tcfg = TrainConfig(opt=opt_mod.OptConfig(peak_lr=3e-3, warmup_steps=5,
                                             decay_steps=100,
                                             weight_decay=0.0))
    data = SyntheticPipeline(DataConfig(vocab_size=CFG.vocab_size, seq_len=64,
                                        global_batch=8, seed=7, branching=2))
    mgr = CheckpointManager(ckpt, keep=2)

    def start(mesh):
        gen = torch.Generator(device=mesh.device).manual_seed(0)
        params, specs = place(model.init(gen), mesh)
        state = opt_mod.init_opt_state(params, tcfg.opt, mesh=mesh,
                                       specs=specs)
        return params, specs, state

    # ---- phase 1: "16 hosts" (here: mesh A stands in) ----------------------
    params, specs, state = start(mesh_a)
    step_fn = make_train_step(model, tcfg, mesh=mesh_a, specs=specs)
    params, state, l1 = run_segment(params, state, data, 0, SEGMENT, step_fn,
                                    mesh_a.device)
    mgr.save(SEGMENT, {"params": params, "opt": state}, blocking=True,
             placements=state_placements(params, specs, mesh_a, tcfg.opt))
    log(f"phase 1 (mesh {mesh_a.shape}): loss {l1[0]:.3f} -> {l1[-1]:.3f}; "
        f"checkpoint @{SEGMENT} saved")
    log("=== simulated hard failure: 1 of 16 hosts lost ===")

    # ---- recovery decision -------------------------------------------------
    action, backoff = RestartPolicy().next_action(0, dead_hosts=[5],
                                                  n_hosts=16)
    new_shape = elastic_mesh_shape(n_devices=240, model_parallel=16)
    log(f"RestartPolicy -> {action} (backoff {backoff:.0f}s); elastic mesh "
        f"for 240 surviving chips: {new_shape}")

    # ---- phase 2: restart on the new mesh ----------------------------------
    mesh_b = mesh_lib.make_host_mesh(world, 1, device)
    params, specs, state = start(mesh_b)          # the template's shards
    step0, restored = mgr.restore(
        {"params": params, "opt": state},
        placements=state_placements(params, specs, mesh_b, tcfg.opt))
    params, state = restored["params"], restored["opt"]
    step_fn = make_train_step(model, tcfg, mesh=mesh_b, specs=specs)
    params, state, l2 = run_segment(params, state, data, step0,
                                    step0 + SEGMENT, step_fn, mesh_b.device)
    log(f"phase 2 (restored @ step {step0}, mesh {mesh_b.shape}): loss "
        f"{l2[0]:.3f} -> {l2[-1]:.3f}")
    ok = l2[0] < l1[0] and l2[-1] <= l2[0] + 0.05
    log("continuity check: " + ("OK - trajectory resumed, no loss spike"
                                if ok else "FAILED"))
    return {"ok": ok, "phase1": l1, "phase2": l2, "restored_step": step0,
            "mesh_a": mesh_a.shape, "mesh_b": mesh_b.shape}


def _drill_on_target(world: int, device: torch.device, ckpt: str):
    """:func:`drill` under the launcher's target (``h100`` on the card)."""
    target = serving_target(device)
    with use_target(target) if target else contextlib.nullcontext():
        return drill(world, device, ckpt)


def _rank_drill(world: int, device: torch.device, ckpt: str,
                result: str) -> None:
    rec = _drill_on_target(world, device, ckpt)
    if dist.get_rank() == 0:
        with open(result, "w") as f:
            json.dump(rec, f)


def run(argv=None) -> Dict[str, Any]:
    """The drill; returns rank 0's ``{ok, phase1, phase2, restored_step,
    mesh_a, mesh_b}``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="elastic_ckpt_")
    ckpt = os.path.join(tmp, "ckpt")
    try:
        if args.world == 1:
            with mesh_lib.ranks(1, dev):
                return _drill_on_target(1, dev, ckpt)
        result = os.path.join(tmp, "rank0.json")
        mesh_lib.spawn(_rank_drill, args.world, dev,
                       args=(args.world, dev, ckpt, result))
        with open(result) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
