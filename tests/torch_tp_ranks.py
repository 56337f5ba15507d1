"""The rank side of ``tests/test_torch_tp_serving.py``: sharded serving on
each rank of a gloo world of 2 (the head path: the KV heads divide the
``model`` axis) and of 4 (the pooled path: they do not), spawned by the
test. Imports only ``repro_torch`` (never JAX or the reference): each rank
writes what it computed to ``<out>/w<world>_rank<r>.pt`` and the test
process holds it against the reference and the port's single-device runs.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import run_stream
from repro_torch.models import build_model, layers, transformer
from repro_torch.models.bridge import sharded_from_numpy
from repro_torch.serve import scheduler as sm
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.train.optimizer import tree_map

CPU = torch.device("cpu")
MAX_LEN, PT = 64, 8

#: tests/mesh_matrix_check.py's cells, the dense slab, the disaggregated
#: roles, a pool squeezed until it preempts (tier copies out and back) and
#: a stream parked to the host tier and resumed:
#: (cell name, pool, prefix_share, chunk_prefill_tokens, speculate_tokens)
CELLS = (("paged", "paged", False, None, 0),
         ("paged-share", "paged", True, None, 0),
         ("chunked", "paged", False, 6, 0),
         ("speculate", "paged", False, None, 4),
         ("dense", "dense", False, None, 0),
         ("disagg", "paged", False, 6, 0),
         ("squeezed", "squeezed", False, None, 0),
         ("park", "paged", False, None, 0))
#: layer-0 pages of the squeezed pool (page 0 is the null page)
SQUEEZED_PAGES = 9
#: the cells the pooled world runs
WORLD4_CELLS = ("paged", "speculate", "dense")


def requests():
    """tests/mesh_matrix_check.py's requests: (prompt, max new tokens)."""
    rng = np.random.RandomState(11)
    system = np.tile(rng.randint(2, 128, size=4).astype(np.int32), 4)
    tails = [rng.randint(2, 128, size=n).astype(np.int32) for n in (7, 11)]
    motif = np.tile(rng.randint(2, 128, size=5).astype(np.int32), 5)[:22]
    rand = rng.randint(2, 128, size=13).astype(np.int32)
    return [(np.concatenate([system, tails[0]]), 14),
            (np.concatenate([system, tails[1]]), 12),
            (motif, 16),
            (rand, 10)]


def geometry(cfg, codec: str = "fp16", n_pages: int = 41,
             spill_codec=None):
    pb = sm.kv_bytes_per_token(cfg, 2 if codec == "fp16" else 1) * PT
    if codec == "int8":
        pb += sm.kv_scale_bytes_per_page(cfg)
    return sm.PageGeometry(page_tokens=PT, n_pages=n_pages, n_spill_pages=65,
                           max_pages_per_slot=-(-MAX_LEN // PT),
                           page_bytes=pb, layer0_codec=codec,
                           layer1_codec=spill_codec or codec)


def engine(arch, inputs, mesh):
    cfg = get_reduced(arch)
    model = build_model(cfg, device=CPU)
    params, _ = sharded_from_numpy(inputs[f"{arch}/params"], mesh)
    return Engine(model, params, EngineConfig(max_len=MAX_LEN,
                                              sync_interval=4, mesh=mesh))


def one_shot(eng, reqs):
    out = []
    for prompt, gen in reqs:
        toks, _ = eng.generate({"tokens": torch.as_tensor(prompt)[None]},
                               n_steps=gen)
        out.append(toks[0].tolist())
    return out


def serve(eng, reqs, pages, *, share=False, chunk=None, spec=0,
          disagg=False, park=0):
    """One stream of ``reqs``; with ``park`` its decoding residents are
    parked to the host tier after ``park`` decode steps and resumed
    (``launch.serve.run_stream``). Returns its tokens and counters."""
    eng.ecfg.speculate_tokens = spec
    try:
        sch = sm.Scheduler(3, pages=pages, prefix_share=share,
                           chunk_prefill_tokens=chunk, disaggregate=disagg)
        if park:
            rec = run_stream(eng, sch, [{"prompt": p, "max_new_tokens": g}
                                        for p, g in reqs], park_idle=park)
            return {"outputs": list(rec["outputs"].values()),
                    "host_syncs": rec["host_syncs"], "chunks": rec["chunks"],
                    "parks": rec["parks"]}
        rids = [sch.submit(p, g).rid for p, g in reqs]
        rep = eng.serve(scheduler=sch)
    finally:
        eng.ecfg.speculate_tokens = 0
    st = rep.stats
    return {"outputs": [rep.outputs[r] for r in rids],
            # the decode role reads once a boundary when disaggregated
            "host_syncs": st.get("host_syncs_by_role", {}).get(
                "decode", st["host_syncs"]),
            "chunks": st["chunks"],
            "spec_proposed": st.get("spec_proposed", 0),
            "prefix_hits": st.get("prefix_hits", 0),
            "handovers": st.get("handovers", 0),
            "preemptions": st.get("preemptions", 0)}


def logits(eng, inputs):
    """Prefill logits, then teacher-forced decode steps over the dense
    slab, every row whole (``full_logits``)."""
    model, params = eng.model, eng.params
    prompt, forced = inputs["prompt"], inputs["forced"]
    out = []
    with tp.use_mesh(eng.core.mesh):
        lg, state = model.prefill(params, {"tokens": torch.as_tensor(prompt)},
                                  MAX_LEN)
        out.append(lg[:, -1].numpy())
        s = prompt.shape[1]
        for i in range(forced.shape[0]):
            lg, state = model.decode_step(
                params, torch.as_tensor(forced[i])[:, None], state,
                torch.tensor(s + i, dtype=torch.int32))
            out.append(lg[:, -1].numpy())
    return np.stack(out)


def forward_logits(eng, inputs):
    """One full-sequence forward without caches over the prompts (the
    teacher-forced check's), every row's logits whole."""
    model, params = eng.model, eng.params
    with tp.use_mesh(eng.core.mesh):
        x, _, _ = transformer.forward(model.cfg, params,
                                      torch.as_tensor(inputs["prompt"]))
        return tp.gather_logits(layers.unembed_logits(params["tok"], x),
                                model.cfg.padded_vocab).numpy()


def pages(cfg, pool):
    """The cell's page geometry (None: the dense slab)."""
    if pool == "dense":
        return None
    return geometry(cfg, n_pages=SQUEEZED_PAGES if pool == "squeezed"
                    else 41)


def _leaves(caches):
    return {f"{g}/{k}/{name}": t.clone()
            for g, group in caches.items() for k, leaf in group.items()
            for name, t in leaf.items()}


def pool_leaves(eng):
    """The last paged serve's layer-0 pool, leaf by leaf."""
    return _leaves(eng._last_pool.state["caches"])


def spill_leaves(eng):
    """The last paged serve's layer-1 spill tier, leaf by leaf."""
    return _leaves(eng._last_spill)


def own_weights(model, mesh):
    """``Model.init_serving(gen, mesh=)`` from seed 0, and whether each of
    its leaves is this rank's ``local_shard`` of ``prepare(init(gen))``
    bit for bit and dtype for dtype."""
    own = model.init_serving(torch.Generator().manual_seed(0), mesh=mesh)
    full = model.prepare(model.init(torch.Generator().manual_seed(0)))
    cut = tree_map(lambda p, s: shd.local_shard(p, s, mesh), full,
                   shd.param_specs(full, mesh))
    same = tree_map(lambda a, b: a.dtype == b.dtype and torch.equal(a, b),
                    own, cut)
    return own, all(_flat(same))


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [tree]


def kv_heads(leaves) -> int:
    """The KV heads a pool's pages hold (n_repeat, n_pages, Hkv, pt, D)."""
    return next(t.shape[2] for name, t in leaves.items()
                if name.endswith("/k"))


def world2(path, out):
    """The head path on qwen2.5-3b's smoke config (4 query heads over 2 KV
    heads: one KV head a rank) and gemma3-27b's (window 16)."""
    inputs = torch.load(path, weights_only=False)
    mesh = mesh_lib.make_host_mesh(1, 2, device=CPU)
    reqs = inputs["reqs"]
    eng = engine("qwen2.5-3b", inputs, mesh)
    res = {"logits": logits(eng, inputs), "one_shot": one_shot(eng, reqs),
           "forward": forward_logits(eng, inputs), "local_kv_heads": None}
    cfg = eng.model.cfg
    for name, pool, share, chunk, spec in CELLS:
        res[name] = serve(eng, reqs, pages(cfg, pool), share=share,
                          chunk=chunk, spec=spec, disagg=name == "disagg",
                          park=4 if name == "park" else 0)
    own = own_weights(eng.model, mesh)
    res["init_serving_bits"] = own[1]
    eng8 = Engine(eng.model, own[0], EngineConfig(max_len=MAX_LEN,
                                                  sync_interval=4, mesh=mesh))
    res["int8"] = serve(eng8, reqs, geometry(cfg, "int8"))
    res["int8_pool"] = pool_leaves(eng8)
    res["local_kv_heads"] = kv_heads(res["int8_pool"])
    res["fp8_squeezed"] = serve(eng8, reqs, geometry(
        cfg, "fp8", SQUEEZED_PAGES, spill_codec="int8"))
    res["fp8_spill"] = spill_leaves(eng8)
    gemma = engine("gemma3-27b", inputs, mesh)
    greqs = inputs["gemma_reqs"]
    res["gemma_one_shot"] = one_shot(gemma, greqs)
    res["gemma_paged"] = serve(gemma, greqs, geometry(gemma.model.cfg))
    torch.save(res, os.path.join(out, f"w2_rank{dist.get_rank()}.pt"))


def world4(path, out):
    """The pooled path on qwen2.5-3b's smoke config: 2 KV heads over 4
    ranks, so the caches are whole on every rank and decode runs over
    position ranges."""
    inputs = torch.load(path, weights_only=False)
    mesh = mesh_lib.make_host_mesh(1, 4, device=CPU)
    reqs = inputs["reqs"]
    eng = engine("qwen2.5-3b", inputs, mesh)
    cfg = eng.model.cfg
    res = {"logits": logits(eng, inputs), "one_shot": one_shot(eng, reqs),
           "forward": forward_logits(eng, inputs)}
    for name, pool, share, chunk, spec in CELLS:
        if name in WORLD4_CELLS:
            res[name] = serve(eng, reqs, pages(cfg, pool), share=share,
                              chunk=chunk, spec=spec)
    res["local_kv_heads"] = kv_heads(pool_leaves(eng))
    torch.save(res, os.path.join(out, f"w4_rank{dist.get_rank()}.pt"))


def main(path, out):
    world = dist.get_world_size()
    torch.set_num_threads(1)
    (world2 if world == 2 else world4)(path, out)
