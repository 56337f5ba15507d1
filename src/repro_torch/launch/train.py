"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

The counterpart of ``src/repro/launch/train.py``, on the card by default
(``--device cpu`` runs on the CPU). One loop wires the training substrate
together: the synthetic data pipeline (prefetched) -> the train step
(mixed precision, remat, microbatches, AdamW) -> step-time telemetry (the
straggler detector) -> atomic async checkpoints -> crash and restart
(``--fail-at`` exits with 17 before that step; ``--resume`` restores the
latest checkpoint and continues bit for bit). Without ``--full`` it trains
the REDUCED smoke config. Weights are random, made on the model's device
from seed 0; on the card the kernels' plans come from the ``h100`` target.

``--mesh DxM`` trains on a data x model mesh of D x M ranks, one a
device (``launch/mesh.py``): each rank keeps its shard of the params and
moments and takes its slice of the batch (``train/loop.py``), and the
checkpoints hold full arrays, so ``--resume`` restores onto any mesh.
Without a process group set up, more than one rank are started here
(``torch.multiprocessing``, a ``file://`` store: gloo on the CPU, NCCL on
the card, where the mesh may not ask for more GPUs than there are); one
rank (``1x1``, the default) runs in this process, through the same mesh
path. A rank that fails fails the run. Unlike the reference, the closing
save is skipped when the last periodic save already wrote the final step.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.target import use_target
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import serving_target
from repro_torch.models.api import build_model, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import FailureInjector, StragglerDetector
from repro_torch.train.loop import (TrainConfig, make_train_step, place,
                                    state_placements)

#: the exit code of an injected crash: restart with --resume
CRASH_EXIT = 17


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: the "
                         "REDUCED smoke config)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--quantized-moments", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="data x model ranks, e.g. 1x2 (one rank a device; "
                         "on the card at most the GPUs present)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="failure-injection drill: crash at this step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    return ap.parse_args(argv)


def run(argv=None, *, cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Parse ``argv`` and train. A given ``cfg`` is trained in place of the
    one ``--arch`` / ``--full`` name (a caller's depth cut of a published
    config). Returns ``{exit, params, opt, specs, losses {step: loss},
    step_s [seconds a step], start_step, checkpoints}``: ``exit`` is 0, or
    ``CRASH_EXIT`` after an injected crash; ``params`` and ``opt`` are this
    rank's shards of ``specs``; ``checkpoints`` holds the checkpoint
    manager's records of its saves and restores. When this call starts the
    ranks itself, it returns rank 0's ``exit``, ``losses``, ``step_s`` and
    ``start_step`` alone."""
    args = parse_args(argv)
    try:
        sizes, names = mesh_lib.parse_mesh(args.mesh)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh!r}: expected 'DxM' sizes ({e})")
    world = mesh_lib.mesh_ranks(sizes)
    dev = resolve_device(args.device)
    if world > 1 and not dist.is_initialized():
        return _spawn(argv, cfg, world, dev)
    if cfg is None:
        cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    with mesh_lib.ranks(world, dev):
        mesh = mesh_lib.make_mesh(sizes, names, dev,
                                  what=f"--mesh {args.mesh}")
        target = serving_target(dev)
        with use_target(target) if target else contextlib.nullcontext():
            return _train(args, cfg, mesh)


def _rank_run(argv, cfg, result: str) -> None:
    """One spawned rank: train, rank 0 writes its record to ``result``; a
    crash drill exits with its code."""
    rec = run(argv, cfg=cfg)
    if dist.get_rank() == 0:
        with open(result, "w") as f:
            json.dump({k: rec[k] for k in ("exit", "losses", "step_s",
                                           "start_step")}, f)
    if rec["exit"]:
        sys.exit(rec["exit"])


def _spawn(argv, cfg, world: int, dev: torch.device) -> Dict[str, Any]:
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
    result = os.path.join(tmp, "rank0.json")
    try:
        try:
            mesh_lib.spawn(_rank_run, world, dev, args=(argv, cfg, result))
        except mp.ProcessExitedException as e:
            if e.exit_code != CRASH_EXIT:
                raise
        with open(result) as f:
            rec = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["losses"] = {int(k): v for k, v in rec["losses"].items()}
    return rec


def _train(args, cfg: ModelConfig, mesh: shd.Mesh) -> Dict[str, Any]:
    dev = mesh.device
    rank = dist.get_rank()
    model = build_model(cfg, device=dev)
    tcfg = TrainConfig(
        opt=opt_mod.OptConfig(peak_lr=args.lr, warmup_steps=10,
                              decay_steps=max(args.steps, 100),
                              quantized_moments=args.quantized_moments),
        n_microbatches=args.microbatches)
    data = SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=0,
        frontend_len=cfg.frontend_len, d_model=cfg.d_model,
        encdec=cfg.family == "encdec"))
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    injector = FailureInjector(fail_at_steps=(args.fail_at,)
                               if args.fail_at is not None else ())
    detector = StragglerDetector()

    params, specs = place(
        model.init(torch.Generator(device=dev).manual_seed(0)), mesh)
    state = opt_mod.init_opt_state(params, tcfg.opt, mesh=mesh, specs=specs)
    where = state_placements(params, specs, mesh, tcfg.opt)
    start_step, saved = 0, None
    if mgr and args.resume and mgr.latest_step() is not None:
        start_step, restored = mgr.restore({"params": params, "opt": state},
                                           placements=where)
        params, state = restored["params"], restored["opt"]
        saved = start_step
        log(f"resumed from step {start_step}")

    step_fn = make_train_step(model, tcfg, mesh=mesh, specs=specs)
    rec: Dict[str, Any] = {"exit": 0, "losses": {}, "step_s": [],
                           "start_step": start_step}
    it = data.iterator(start_step=start_step, depth=2)
    t_tokens = args.global_batch * args.seq_len
    try:
        for step in range(start_step, args.steps):
            if injector.check(step):
                log(f"[drill] injected crash at step {step}")
                if mgr:
                    mgr.wait()
                rec["exit"] = CRASH_EXIT
                break
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in next(it).items()}
            t0 = time.monotonic()
            params, state, metrics = step_fn(params, state, batch)
            loss = float(metrics["total_loss"])          # sync point
            dt = time.monotonic() - t0
            rec["losses"][step] = loss
            rec["step_s"].append(dt)
            detector.record(rank, dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                log(f"step {step:5d}  loss {loss:.4f}  "
                    f"lr {float(metrics['lr']):.2e}  "
                    f"gnorm {float(metrics['grad_norm']):.2f}  "
                    f"{dt * 1e3:.1f} ms  {t_tokens / dt:.0f} tok/s")
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, {"params": params, "opt": state},
                         extra={"loss": loss}, placements=where)
                saved = step + 1
        else:
            if mgr and saved != args.steps:
                mgr.save(args.steps, {"params": params, "opt": state},
                         placements=where)
    finally:
        it.close()
        if mgr:
            mgr.wait()
    stragglers = detector.stragglers()
    if stragglers:
        log(f"[telemetry] straggler hosts: {stragglers}")
    rec.update(params=params, opt=state, specs=specs,
               checkpoints=mgr.records if mgr else [])
    return rec


def log(msg: str) -> None:
    """Print on rank 0 only."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(msg, flush=True)


def main(argv=None) -> int:
    return run(argv)["exit"]


if __name__ == "__main__":
    sys.exit(main())
