"""The rank side of ``tests/test_torch_mla_serving.py``: deepseek-v2-236b's
smoke config (MLA with q-LoRA, 4 heads; MoE of 8 experts top-2 and one
shared expert) served on each rank of a gloo world of 2 and of 4, spawned
by the test. Imports only ``repro_torch`` (never JAX or the reference):
each rank writes what it computed to ``<out>/w<world>_rank<r>.pt`` and the
test process holds it against the reference and the port's single-device
runs.
"""

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe, transformer
from repro_torch.serve.engine import Engine, EngineConfig

import torch_tp_ranks as tpr

ARCH = "deepseek-v2-236b"
CPU = torch.device("cpu")
MAX_LEN, PT = tpr.MAX_LEN, tpr.PT
#: the teacher-forced pool's block tables: two slots of 4 shuffled pages
#: (page 0 is the null page), 32 positions each
POOL_TABLES = np.asarray([[3, 7, 1, 5], [2, 8, 6, 4]], np.int32)
POOL_PAGES = 9


class Routes:
    """Every MoE call's routes, in call order: ``idx`` (T, k) of each
    ``moe._route`` call made while :meth:`record` is active."""

    def __init__(self):
        self.calls = []

    def record(self):
        route = moe._route

        def spy(w, xt, k):
            out = route(w, xt, k)
            self.calls.append(out[1].numpy().copy())
            return out

        moe._route = spy
        return self

    def __enter__(self):
        return self.record()

    def __exit__(self, *exc):
        moe._route = Routes._route
        return False


Routes._route = moe._route


class Replay(Routes):
    """The reference's routes, replayed: the n-th ``moe._route`` call takes
    the reference's n-th call's experts (``idx``, in its order of the k,
    which the capacity cut ranks hits by) with gates from this rank's own
    router probabilities at those experts, renormalised as ``_route``
    does (``test_torch_model.RouteReplay``'s rule, across processes)."""

    def __init__(self, calls):
        super().__init__()
        self.ref = list(calls)

    def record(self):
        route = Routes._route

        def replay(w, xt, k):
            _, own, probs = route(w, xt, k)
            self.calls.append(own.numpy().copy())
            idx = torch.from_numpy(np.asarray(
                self.ref[len(self.calls) - 1]).astype(np.int64))
            assert idx.shape == own.shape, (idx.shape, own.shape)
            gates = torch.gather(probs, -1, idx)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
            return gates, idx, probs

        moe._route = replay
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if exc[0] is None:
            assert len(self.calls) == len(self.ref), (len(self.calls),
                                                      len(self.ref))
        return False


def reference_routes(path, timeout=900.0):
    """The reference child's routes (written atomically once its logits
    are done), waited for."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no reference routes at {path}")
        time.sleep(0.5)
    with open(path, "rb") as f:
        return pickle.load(f)


def pool_logits(model, params, inputs, mesh, codec="fp16"):
    """Each prompt prefilled alone and cut into a shuffled latent pool at
    ``codec`` (``slot_update_paged``), then the forced tokens decoded over
    the pool (``decode_step`` with block tables, per-slot frontiers):
    the last position's logits of the prefills and of each step, whole,
    and the pool's leaves after the last step."""
    cfg = model.cfg
    prompt, forced = inputs["prompt"], inputs["forced"]
    dtype, scaled = {"fp16": (torch.bfloat16, False),
                     "int8": (torch.int8, True)}[codec]
    depth = PT * POOL_TABLES.shape[1]
    with tp.use_mesh(mesh):
        pool = {"caches": transformer.init_paged_caches(
            cfg, prompt.shape[0], POOL_PAGES, PT, CPU, dtype=dtype,
            quant_scales=scaled)}
        first = []
        for slot in range(prompt.shape[0]):
            row = torch.as_tensor(prompt[slot:slot + 1])
            last = torch.tensor([prompt.shape[1] - 1])
            lg, state = model.prefill(params, {"tokens": row}, depth,
                                      last_pos=last)
            first.append(lg[0, -1].numpy())
            pool = model.slot_update_paged(
                pool, state, slot, torch.from_numpy(POOL_TABLES[slot]), PT)
        out = [np.stack(first)]
        bt = torch.from_numpy(POOL_TABLES)
        for i in range(forced.shape[0]):
            cl = torch.full((prompt.shape[0],), prompt.shape[1] + i,
                            dtype=torch.int32)
            lg, pool = model.decode_step(
                params, torch.as_tensor(forced[i])[:, None], pool, cl,
                block_tables=bt)
            out.append(lg[:, -1].numpy())
    leaves = {f"{g}/{k}/{name}": t.clone()
              for g, group in pool["caches"].items()
              for k, leaf in group.items() for name, t in leaf.items()}
    return np.stack(out), leaves


def held_heads(params):
    """The query heads each MLA layer's leaves hold and the latent cache
    widths: (wq_b columns, wkv_b columns, wo rows) of each stacked group's
    attention."""
    out = {}
    for g, group in params["groups"].items():
        for k, leaf in group.items():
            attn = leaf.get("attn", {})
            if "wkv_b" in attn:
                out[f"{g}/{k}"] = (attn["wq_b"].shape[-1],
                                   attn["wkv_b"].shape[-1],
                                   attn["wo"].shape[-2])
    return out


def logits_and_routes(eng, inputs, ref=None, world=None):
    """The slab's and the pool's teacher-forced logits, each with the
    routes of every MoE call it made (its own), and the hits the
    expert-parallel cut dropped; with the reference's routes ``ref`` (of
    its ``1 x world`` run) the same on the reference's routes
    (:class:`Replay`), under ``replayed/``."""
    res = {}
    for key, routes, fn in (
            ("logits", "routes", lambda: tpr.logits(eng, inputs)),
            ("pool_logits", "pool_routes", lambda: pool_logits(
                eng.model, eng.params, inputs, eng.core.mesh))):
        spy = Routes() if ref is None else Replay(ref[f"{routes}/1x{world}"])
        with spy, moe.count_ep() as count:
            out = fn()
        if key == "pool_logits":
            out, res["pool"] = out
        res[key], res[routes] = out, spy.calls
        res[f"{key}_dropped"] = int(sum(count.drops))
    if ref is not None:
        return {f"replayed/{k}": v for k, v in res.items()}
    return res


def world2(path, routes, out):
    inputs = torch.load(path, weights_only=False)
    mesh = mesh_lib.make_host_mesh(1, 2, device=CPU)
    reqs = inputs["reqs"]
    eng = tpr.engine(ARCH, inputs, mesh)
    cfg = eng.model.cfg
    res = logits_and_routes(eng, inputs)
    res["heads"] = held_heads(eng.params)
    res["one_shot"] = tpr.one_shot(eng, reqs)
    for name, pool, share, chunk, spec in tpr.CELLS:
        res[name] = tpr.serve(eng, reqs, tpr.pages(cfg, pool), share=share,
                              chunk=chunk, spec=spec, disagg=name == "disagg",
                              park=4 if name == "park" else 0)
    res["paged_pool"] = tpr.pool_leaves(eng)
    own, res["init_serving_bits"] = tpr.own_weights(eng.model, mesh)
    eng = Engine(eng.model, own, EngineConfig(max_len=MAX_LEN,
                                              sync_interval=4, mesh=mesh))
    for codec in ("fp16", "int8", "fp8"):
        res[f"own_{codec}"] = tpr.serve(eng, reqs, tpr.geometry(cfg, codec))
        res[f"own_{codec}_pool"] = tpr.pool_leaves(eng)
    eng = tpr.engine(ARCH, inputs, mesh)
    res.update(logits_and_routes(eng, inputs, reference_routes(routes), 2))
    torch.save(res, os.path.join(out, f"w2_rank{dist.get_rank()}.pt"))


def world4(path, routes, out):
    inputs = torch.load(path, weights_only=False)
    mesh = mesh_lib.make_host_mesh(1, 4, device=CPU)
    reqs = inputs["reqs"]
    eng = tpr.engine(ARCH, inputs, mesh)
    res = logits_and_routes(eng, inputs)
    res["heads"] = held_heads(eng.params)
    res["one_shot"] = tpr.one_shot(eng, reqs)
    res["paged"] = tpr.serve(eng, reqs, tpr.pages(eng.model.cfg, "paged"))
    res["paged_pool"] = tpr.pool_leaves(eng)
    res.update(logits_and_routes(eng, inputs, reference_routes(routes), 4))
    torch.save(res, os.path.join(out, f"w4_rank{dist.get_rank()}.pt"))


def main(path, routes, out):
    """Serve this rank's share; ``routes``: the reference child's routes
    file, waited for before the logits on its routes."""
    torch.set_num_threads(1)
    (world2 if dist.get_world_size() == 2 else world4)(path, routes, out)
