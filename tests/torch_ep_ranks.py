"""The rank side of ``tests/test_torch_ep_serving.py``: expert-parallel
serving of qwen3-moe-30b-a3b's smoke config (8 experts, top-2) on each
rank of a gloo world of 2 and of 4, spawned by the test. Imports only
``repro_torch`` (never JAX or the reference): each rank writes what it
computed to ``<out>/w<world>_rank<r>.pt`` and the test process holds it
against the reference and the port's single-device runs.
"""

import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model, moe
from repro_torch.models.bridge import sharded_from_numpy
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.train import loop
from repro_torch.train import optimizer as opt_mod

import torch_tp_ranks as tpr

ARCH = "qwen3-moe-30b-a3b"
CPU = torch.device("cpu")
MAX_LEN = tpr.MAX_LEN

#: (name, world, tokens a row of the 4-row batch, capacity_factor): each
#: world's layer calls, one body of the reference's byte rule each
#: (``moe.ep_body``); the ``drop`` cases cut hits (cap 16 of ~64 local
#: hits at world 2, 16 of ~32 at world 4)
LAYER_CASES = (("wg2", 2, 16, 2.0), ("pk2", 2, 1, 2.0),
               ("drop2", 2, 16, 0.25), ("pk4", 4, 1, 2.0),
               ("drop4", 4, 16, 0.5))


def layer_cases(inputs, mesh):
    """This world's ``LAYER_CASES`` through ``moe_block(impl="ep")`` on the
    rank's experts: the output, aux, the body taken and the hits this rank
    dropped."""
    world = shd.model_axis_size(mesh)
    full = {k: torch.from_numpy(v) for k, v in
            inputs["layer/params"].items()}
    p = {k: shd.local_shard(v, shd.spec_for_param(k, tuple(v.shape), mesh),
                            mesh) for k, v in full.items()}
    out = {}
    for name, w, s, cf in LAYER_CASES:
        if w != world:
            continue
        cfg = dataclasses.replace(get_reduced(ARCH), capacity_factor=cf)
        x = torch.from_numpy(inputs[f"layer/x{s}"]).to(torch.bfloat16)
        with tp.use_mesh(mesh), moe.count_ep() as count:
            y, aux = moe.moe_block(p, x, cfg=cfg, impl="ep")
        out[name] = {"y": y.float().numpy(), "aux": float(aux),
                     "dtype": str(y.dtype),
                     "bodies": dict(count.bodies),
                     "dropped": int(sum(count.drops))}
    return out


def train_step(inputs, mesh):
    """One sharded train step on this mesh (``train.loop``: the experts
    split on ``model`` and gathered at use): its loss, and the
    expert-parallel calls it made (none: no serving mesh is active)."""
    cfg = get_reduced(ARCH)
    model = build_model(cfg, device=CPU)
    params, specs = sharded_from_numpy(inputs[f"{ARCH}/params"], mesh)
    tcfg = loop.TrainConfig(opt=opt_mod.OptConfig(warmup_steps=1))
    state = opt_mod.init_opt_state(params, tcfg.opt, mesh=mesh, specs=specs)
    step = loop.make_train_step(model, tcfg, mesh=mesh, specs=specs)
    batch = {k: torch.from_numpy(v) for k, v in inputs["train"].items()}
    with moe.count_ep() as count:
        _, _, metrics = step(params, state, batch)
    return {"loss": float(metrics["total_loss"]),
            "ep_calls": sum(count.bodies.values()),
            "expert_shard": params["groups"]["blocks"]["pos0"]["moe"][
                "we_gate"].shape[1]}


def world2(path, out):
    inputs = torch.load(path, weights_only=False)
    mesh = mesh_lib.make_host_mesh(1, 2, device=CPU)
    reqs = inputs["reqs"]
    res = {"layers": layer_cases(inputs, mesh)}
    eng = tpr.engine(ARCH, inputs, mesh)
    cfg = eng.model.cfg
    with moe.count_ep() as count:
        res["logits"] = tpr.logits(eng, inputs)
    res["logit_bodies"] = dict(count.bodies)
    res["one_shot"] = tpr.one_shot(eng, reqs)
    for name, pool, share, chunk, spec in tpr.CELLS:
        res[name] = tpr.serve(eng, reqs, tpr.pages(cfg, pool), share=share,
                              chunk=chunk, spec=spec, disagg=name == "disagg",
                              park=4 if name == "park" else 0)
    own, res["init_serving_bits"] = tpr.own_weights(eng.model, mesh)
    res["own_experts"] = own["groups"]["blocks"]["pos0"]["moe"][
        "we_gate"].shape[1]
    eng = Engine(eng.model, own, EngineConfig(max_len=MAX_LEN,
                                              sync_interval=4, mesh=mesh))
    for codec in ("fp16", "int8", "fp8"):
        res[f"own_{codec}"] = tpr.serve(eng, reqs, tpr.geometry(cfg, codec))
    res["train"] = train_step(inputs, mesh)
    torch.save(res, os.path.join(out, f"w2_rank{dist.get_rank()}.pt"))


def world4(path, out):
    inputs = torch.load(path, weights_only=False)
    mesh = mesh_lib.make_host_mesh(1, 4, device=CPU)
    reqs = inputs["reqs"]
    res = {"layers": layer_cases(inputs, mesh)}
    eng = tpr.engine(ARCH, inputs, mesh)
    res["logits"] = tpr.logits(eng, inputs)
    with moe.count_ep() as count:
        res["one_shot"] = tpr.one_shot(eng, reqs)
    res["one_shot_dropped"] = int(sum(count.drops))
    # the paged stream, with the hits this rank dropped counted (read
    # after the stream)
    with moe.count_ep() as count:
        res["paged"] = tpr.serve(eng, reqs, tpr.pages(eng.model.cfg,
                                                      "paged"))
    res["paged"]["dropped"] = int(sum(count.drops))
    torch.save(res, os.path.join(out, f"w4_rank{dist.get_rank()}.pt"))


def main(path, out):
    torch.set_num_threads(1)
    (world2 if dist.get_world_size() == 2 else world4)(path, out)
