"""The rank side of ``tests/test_torch_distributed.py``: checks run on each
rank of a gloo world of 2, spawned by the test. Imports only
``repro_torch`` (never JAX or the reference): each rank writes what it
computed to ``<out>/rank<r>.pt`` and the test process holds it against the
reference and the port's single-process runs.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.examples import elastic_restart
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.models.bridge import sharded_from_numpy, sharded_to_numpy
from repro_torch.train import loop
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import CheckpointManager

CPU = torch.device("cpu")


def psum(inputs, rank):
    """compressed_psum_mean over a 'pod' mesh of 2: one round, then
    ``rounds`` rounds of the same gradient with error feedback."""
    mesh = mesh_lib.make_mesh((2,), ("pod",), CPU)
    group = mesh.group("pod")
    g = torch.from_numpy(inputs["psum_g"][rank])
    err = torch.zeros_like(g)
    first, first_err = collectives.compressed_psum_mean(g, err, group, 2)
    outs, e = [], err
    for _ in range(inputs["rounds"]):
        out, e = collectives.compressed_psum_mean(g, e, group, 2)
        outs.append(out.numpy())
    return {"mean": first.numpy(), "err": first_err.numpy(),
            "rounds": np.stack(outs)}


def sharded_step(arch, inputs, shape, steps, quantized=False):
    """``steps`` sharded train steps of ``arch`` from the full numpy params
    on a (data, model) mesh of ``shape``: the losses, the full params after
    the steps, and wq's spec and shard shape."""
    cfg = get_reduced(arch)
    model = build_model(cfg, device=CPU)
    mesh = mesh_lib.make_host_mesh(*shape, device=CPU)
    params, specs = sharded_from_numpy(inputs[f"{arch}/params"], mesh)
    tcfg = loop.TrainConfig(opt=opt_mod.OptConfig(
        **inputs["opt"], quantized_moments=quantized))
    state = opt_mod.init_opt_state(params, tcfg.opt, mesh=mesh, specs=specs)
    step = loop.make_train_step(model, tcfg, mesh=mesh, specs=specs)
    batch = {k: torch.from_numpy(v)
             for k, v in inputs[f"{arch}/batch"].items()}
    losses = []
    for _ in range(steps):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["total_loss"]))
    wq = params["groups"]["blocks"]["pos0"]["attn"]["wq"]
    wq_spec = specs["groups"]["blocks"]["pos0"]["attn"]["wq"]
    return {"losses": losses, "aux": float(metrics["aux"]),
            "params": sharded_to_numpy(params, specs, mesh),
            "wq_spec": wq_spec, "wq_shape": tuple(wq.shape)}


def moe_aux(inputs, rank):
    """qwen3-moe's REDUCED aux loss on this rank's half of the batch at
    ``data`` 2 (the train step's bf16 compute copies), under the batch axes
    (f and P averaged before the product)."""
    arch = "qwen3-moe-30b-a3b"
    cfg = get_reduced(arch)
    model = build_model(cfg, device=CPU)
    mesh = mesh_lib.make_host_mesh(2, 1, device=CPU)
    params, specs = sharded_from_numpy(inputs[f"{arch}/params"], mesh)
    full = opt_mod.tree_map(lambda p, s: shd.gather_full(p, s, mesh), params,
                            specs)
    batch = loop.rank_slice({k: torch.from_numpy(v) for k, v in
                             inputs[f"{arch}/batch"].items()}, mesh,
                            ("data",))
    with torch.no_grad(), shd.use_batch_axes(mesh, ("data",)):
        _, metrics = model.loss(loop._cast_params_for_compute(full), batch)
    return float(metrics["aux"])


def compressed(inputs, rank):
    """The compressed step over ``pod`` 2: this pod's gradients (before the
    sync), the synced means and residuals, and one whole step's loss and
    params."""
    arch = "qwen2.5-3b"
    cfg = get_reduced(arch)
    model = build_model(cfg, device=CPU)
    mesh = mesh_lib.make_mesh((2, 1, 1), ("pod", "data", "model"), CPU)
    params, specs = sharded_from_numpy(inputs[f"{arch}/params"], mesh)
    tcfg = loop.TrainConfig(opt=opt_mod.OptConfig(**inputs["opt"]))
    batch = {k: torch.from_numpy(v)
             for k, v in inputs[f"{arch}/batch"].items()}
    local = loop.rank_slice(batch, mesh, loop.batch_axes(mesh))
    _, _, grads = loop._sharded_accumulate(model, tcfg, mesh, specs, params,
                                           local, ("data",), cast=False)
    err = collectives.init_error_feedback(params)
    synced, new_err = collectives.compressed_grad_sync(
        grads, err, mesh.group("pod"), 2)
    state = opt_mod.init_opt_state(params, tcfg.opt, mesh=mesh, specs=specs)
    step = loop.make_compressed_train_step(model, tcfg, mesh, specs)
    p2, _, err2, metrics = step(params, state, err, batch)
    numpy = opt_mod.tree_map(lambda t: t.detach().numpy(),
                             {"grads": grads, "synced": synced,
                              "err": new_err, "err_step": err2})
    return dict(numpy, loss=float(metrics["total_loss"]),
                params=sharded_to_numpy(p2, specs, mesh))


def reshard(inputs, rank, out):
    """Save at 1x2 (int8 moments, some kept whole), restore at 2x1: the
    full values before and after, and whether they are equal bit for
    bit."""
    arch = "qwen2.5-3b"
    cfg = loop.TrainConfig(opt=opt_mod.OptConfig(**inputs["opt"],
                                                 quantized_moments=True))
    model = build_model(get_reduced(arch), device=CPU)
    batch = {k: torch.from_numpy(v)
             for k, v in inputs[f"{arch}/batch"].items()}
    ckpt = os.path.join(out, "ckpt")
    mgr = CheckpointManager(ckpt, keep=1)

    def full(tree, where):
        flat = []
        for (_, leaf), (_, place) in zip(_flat(tree), _flat(where)):
            t = leaf.detach().contiguous()
            if place is not None:
                t = shd.gather_full(t, place.spec, place.mesh)
            flat.append(t.clone())
        return flat

    mesh_a = mesh_lib.make_host_mesh(1, 2, device=CPU)
    params, specs = sharded_from_numpy(inputs[f"{arch}/params"], mesh_a)
    state = opt_mod.init_opt_state(params, cfg.opt, mesh=mesh_a, specs=specs)
    params, state, _ = loop.make_train_step(
        model, cfg, mesh=mesh_a, specs=specs)(params, state, batch)
    where_a = loop.state_placements(params, specs, mesh_a, cfg.opt)
    tree_a = {"params": params, "opt": state}
    mgr.save(1, tree_a, blocking=True, placements=where_a)
    before = full(tree_a, where_a)

    mesh_b = mesh_lib.make_host_mesh(2, 1, device=CPU)
    tmpl, specs_b = sharded_from_numpy(inputs[f"{arch}/params"], mesh_b)
    tmpl_state = opt_mod.init_opt_state(tmpl, cfg.opt, mesh=mesh_b,
                                        specs=specs_b)
    where_b = loop.state_placements(tmpl, specs_b, mesh_b, cfg.opt)
    step, restored = mgr.restore({"params": tmpl, "opt": tmpl_state},
                                 placements=where_b)
    after = full(restored, where_b)
    wq_b = restored["params"]["groups"]["blocks"]["pos0"]["attn"]["wq"]
    return {"step": step, "n_leaves": len(before),
            "equal": [bool(torch.equal(a, b)) for a, b in zip(before, after)],
            "wq_shape": tuple(wq_b.shape),
            "whole_a": sum(p is None for _, p in _flat(where_a)),
            "whole_b": sum(p is None for _, p in _flat(where_b))}


def _flat(tree):
    from repro_torch.train.checkpoint import _flatten
    return _flatten(tree)


def main(inputs_path, out):
    """Every check, in one order on both ranks (they are collective)."""
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    rank = dist.get_rank()
    res = {"psum": psum(inputs, rank)}
    for shape in ((1, 2), (2, 1)):
        res[f"step{shape}"] = sharded_step("qwen2.5-3b", inputs, shape, 1)
    res["step_int8"] = sharded_step("qwen2.5-3b", inputs, (1, 2), 2,
                                    quantized=True)
    res["moe_step"] = sharded_step("qwen3-moe-30b-a3b", inputs, (2, 1), 1)
    res["moe_aux"] = moe_aux(inputs, rank)
    res["compressed"] = compressed(inputs, rank)
    res["reshard"] = reshard(inputs, rank, out)
    res["elastic"] = elastic_restart.drill(2, CPU, os.path.join(out,
                                                                "elastic"))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
