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

``--mesh`` above ``1x1`` raises: sharded training needs the port of
``distributed/`` (ROADMAP A13). Unlike the reference, the closing save is
skipped when the last periodic save already wrote the final step.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.target import use_target
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.launch.serve import mesh_size, serving_target
from repro_torch.models.api import build_model, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import FailureInjector, StragglerDetector
from repro_torch.train.loop import TrainConfig, make_train_step

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
                    help="data x model; only 1x1 (one device) is ported "
                         "(sharded training: ROADMAP A13)")
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
    config). Returns ``{exit, params, opt, losses {step: loss}, step_s
    [seconds a step], start_step, checkpoints}``: ``exit`` is 0, or
    ``CRASH_EXIT`` after an injected crash; ``checkpoints`` holds the
    checkpoint manager's records of its saves and restores."""
    args = parse_args(argv)
    try:
        devices = mesh_size(args.mesh)
    except ValueError:
        raise SystemExit(f"--mesh {args.mesh!r}: expected 'DxM' sizes")
    if devices != 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training needs the port of "
            f"distributed/ and launch/mesh.py, which is not done yet "
            f"(ROADMAP A13); --mesh 1x1 is the single-device path")
    if cfg is None:
        cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    dev = resolve_device(args.device)
    target = serving_target(dev)
    with use_target(target) if target else contextlib.nullcontext():
        return _train(args, cfg, dev)


def _train(args, cfg: ModelConfig, dev: torch.device) -> Dict[str, Any]:
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

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = opt_mod.init_opt_state(params, tcfg.opt)
    start_step, saved = 0, None
    if mgr and args.resume and mgr.latest_step() is not None:
        start_step, restored = mgr.restore({"params": params, "opt": state})
        params, state = restored["params"], restored["opt"]
        saved = start_step
        print(f"resumed from step {start_step}", flush=True)

    step_fn = make_train_step(model, tcfg)
    rec: Dict[str, Any] = {"exit": 0, "losses": {}, "step_s": [],
                           "start_step": start_step}
    it = data.iterator(start_step=start_step, depth=2)
    t_tokens = args.global_batch * args.seq_len
    try:
        for step in range(start_step, args.steps):
            if injector.check(step):
                print(f"[drill] injected crash at step {step}", flush=True)
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
            detector.record(0, dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"gnorm {float(metrics['grad_norm']):.2f}  "
                      f"{dt * 1e3:.1f} ms  {t_tokens / dt:.0f} tok/s",
                      flush=True)
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, {"params": params, "opt": state},
                         extra={"loss": loss})
                saved = step + 1
        else:
            if mgr and saved != args.steps:
                mgr.save(args.steps, {"params": params, "opt": state})
    finally:
        it.close()
        if mgr:
            mgr.wait()
    stragglers = detector.stragglers()
    if stragglers:
        print(f"[telemetry] straggler hosts: {stragglers}", flush=True)
    rec.update(params=params, opt=state,
               checkpoints=mgr.records if mgr else [])
    return rec


def main(argv=None) -> int:
    return run(argv)["exit"]


if __name__ == "__main__":
    sys.exit(main())
