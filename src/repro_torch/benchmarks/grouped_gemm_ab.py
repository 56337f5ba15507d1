"""The ``grouped_gemm`` kernel on the card at the MoE's serving shapes: each
of its tile shapes against the others, beside ``F.grouped_mm``.

Cases: ``qwen3-moe-30b-a3b`` and ``deepseek-v2-236b`` at their published
widths, one MoE layer of random weights (seed 1) routed by its own router
on random activations, at a 1024-token admission, a 16-token batch and a
4-token decode step, through the gate projection (K = d_model, N =
moe_d_ff) and the down projection (K = moe_d_ff, N = d_model). For each
case, every tile shape of :data:`repro_torch.kernels.grouped_gemm.TILES`
forced (the one :func:`~repro_torch.kernels.grouped_gemm.launch_config`
picks marked) and ``F.grouped_mm``: the device time alone
(``common.graph_ms``: 25 calls in one CUDA graph, replayed between two
events), 25 calls back to back between two events, the median of 25
calls each between two events, and the host's time per call
(``common.host_ms``); beside the bound of the hit experts' weights, the
rows and the f32 output at the target's rates. Graph timings run in
turns (each tile shape, the library, then the same in reverse), so all
are compared on one card in one process. Also: each tile shape against
the plain version (max |d| over the largest value), its bits over two
calls, and the whole call at each tile shape against the picked one (bit
for bit, else max |d|). Card only; writes the records as JSON to
``--out``.

    PYTHONPATH=src python -m repro_torch.benchmarks.grouped_gemm_ab \\
        [--out PATH]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
from typing import Callable, Dict, Optional

from repro_torch.benchmarks import common

N_TIMED = 25
#: calls a host time is taken over (no synchronisation)
N_HOST = 100
ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-236b")
TOKENS = (1024, 16, 4)


def layer_weights(cfg, seed: int = 1):
    """One MoE layer's router (f32) and routed experts (bf16, as the card
    serves them) at ``cfg``'s widths, and the generator that made them."""
    import torch
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = moe.init_moe(cfg, gen)
    out = {"router": p["router"][0]}
    out.update({k: p[k][0].to(torch.bfloat16)
                for k in ("we_gate", "we_up", "we_down")})
    return out, gen


def routed_inputs(cfg, p, x, gen=None) -> Dict[str, tuple]:
    """``{proj: (xs, w, offs)}`` for the gate and down projections of one
    MoE layer: ``x``'s hits routed by ``p["router"]`` and sorted by expert,
    the offsets made on the device as the MoE makes them; the down
    projection's rows are random (``moe_d_ff`` wide)."""
    import torch
    from repro_torch.models import moe
    xt = x.reshape(-1, cfg.d_model)
    _, idx, _ = moe._route(p["router"], xt, cfg.top_k)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    offs = moe._offsets(flat_e[order], cfg.n_experts)
    cap = flat_e.numel()
    down = torch.randn((cap, cfg.moe_d_ff), device=x.device,
                       generator=gen).to(torch.bfloat16)
    return {"gate": (xt[order // cfg.top_k].contiguous(), p["we_gate"], offs),
            "down": (down, p["we_down"], offs)}


def experts_hit(offs) -> int:
    import torch
    return int((torch.diff(offs, prepend=offs.new_zeros(1)) > 0).sum())


def case_work(xs, w, offs) -> tuple:
    """(bytes, operations) of one call: the hit experts' weights, the rows
    and the offsets read once and the f32 output written once, against
    2 m K N multiply-adds' operations."""
    m, k, n = xs.shape[0], w.shape[1], w.shape[2]
    n_bytes = (2 * experts_hit(offs) * k * n + 2 * xs.numel() + 4 * m * n
               + 4 * offs.numel())
    return n_bytes, 2.0 * m * k * n


def case_bound(xs, w, offs, target) -> tuple:
    """(bound ms, what binds): :func:`case_work` at ``target``'s bf16 and
    HBM rates."""
    n_bytes, n_ops = case_work(xs, w, offs)
    t_bytes = n_bytes / target.profile.hbm_bw * 1e3
    t_ops = n_ops / target.profile.peak_flops_bf16 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_case(impls: Dict[str, Callable]) -> Dict[str, dict]:
    """Every timing of every implementation; graph replays in turns."""
    names = list(impls)
    graph = {name: [] for name in names}
    for name in names + names[::-1]:
        graph[name].append(common.graph_ms(impls[name], N_TIMED))
    return {name: dict(graph_ms=sum(graph[name]) / len(graph[name]),
                       graph_turns=graph[name],
                       back_to_back_ms=common.back_to_back_ms(fn, N_TIMED),
                       events_ms=common.median_ms(fn, N_TIMED),
                       host_ms=common.host_ms(fn, N_HOST))
            for name, fn in impls.items()}


def max_rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def run(target_name: Optional[str] = None,
        out_path: Optional[str] = None) -> dict:
    import dataclasses
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.target import get_target
    from repro_torch.kernels import build
    from repro_torch.kernels.grouped_gemm import (TILES, grouped_gemm,
                                                  grouped_gemm_plain,
                                                  launch_config)
    if not torch.cuda.is_available():
        raise SystemExit("grouped_gemm_ab runs on the card")
    target = get_target(target_name or "h100")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    build.library("grouped_gemm")
    sass = build.sass("grouped_gemm")
    record = {"card": smi, "target": target.name,
              "sass": {op: sass.count(op)
                       for op in ("HGMMA", "UTMALDG", "HMMA")},
              "build": [line.strip() for line in
                        build.build_log("grouped_gemm").splitlines()
                        if "registers" in line or "spill" in line
                        or "Function properties" in line],
              "cases": {}}
    print(f"SASS: {record['sass']}; " + " | ".join(record["build"]))
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=1)
        p, gen = layer_weights(cfg)
        for t in TOKENS:
            x = torch.randn((1, t, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            for proj, (xs, w, offs) in routed_inputs(cfg, p, x, gen).items():
                m, k, n, e = xs.shape[0], w.shape[1], w.shape[2], w.shape[0]
                picked = launch_config(m, k, n, e).config
                want = grouped_gemm_plain(xs, w, offs)
                base = grouped_gemm(xs, w, offs)
                impls, tiles = {}, {}
                for config, (bm, bn) in TILES.items():
                    label = f"{bm}x{bn}" + ("*" if config == picked else "")
                    call = functools.partial(grouped_gemm, xs, w, offs,
                                             config=config)
                    got = call()
                    impls[label] = call
                    tiles[label] = dict(
                        config=config, rel_err=max_rel(got, want),
                        repeat_bitwise=bool(torch.equal(got, call())),
                        bitwise_to_picked=bool(torch.equal(got, base)),
                        max_abs_to_picked=(got - base).abs().max().item())
                impls["F.grouped_mm"] = functools.partial(
                    F.grouped_mm, xs, w, offs=offs)
                bound, by = case_bound(xs, w, offs, target)
                name = f"{arch} T {t} {proj}"
                rec = dict(m=m, k=k, n=n, experts=e,
                           experts_hit=experts_hit(offs), picked=picked,
                           bound_ms=bound, bound_by=by, tiles=tiles,
                           timings=time_case(impls))
                record["cases"][name] = rec
                print(f"{name}: m {m} K {k} N {n} hit {rec['experts_hit']}; "
                      f"bound {bound:.4f} ms ({by})")
                for label, tm in rec["timings"].items():
                    turns = ", ".join(f"{v:.4f}" for v in tm["graph_turns"])
                    check = tiles.get(label)
                    note = "" if check is None else (
                        f"; rel err {check['rel_err']:.2e}, repeat bitwise "
                        f"{check['repeat_bitwise']}, bitwise to picked "
                        f"{check['bitwise_to_picked']} (max |d| "
                        f"{check['max_abs_to_picked']:.2e})")
                    print(f"    {label:13s} graph {tm['graph_ms']:.4f} ms "
                          f"(turns {turns}), back to back "
                          f"{tm['back_to_back_ms']:.4f}, events "
                          f"{tm['events_ms']:.4f}, host {tm['host_ms']:.4f} "
                          f"ms a call{note}")
        del p
        torch.cuda.empty_cache()
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_target_arg(ap, default="h100")
    ap.add_argument("--out", metavar="PATH",
                    default=os.path.join(common.ARTIFACT_ROOT,
                                         "grouped_gemm_ab.json"),
                    help="where the JSON records go (default: the port's "
                         "benchmark artifacts)")
    args = ap.parse_args(argv)
    run(args.target, args.out)


if __name__ == "__main__":
    main()
