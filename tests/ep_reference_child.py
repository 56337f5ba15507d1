"""The reference side of ``tests/test_torch_ep_serving.py`` (NOT a pytest
file): run as a child python with four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set before JAX
imports; ``tests/conftest.py`` forbids the flag in the pytest process).

    python tests/ep_reference_child.py INPUTS.pkl OUT.pkl

Reads the numpy weights and inputs the test made, and writes, under
``make_mesh((1, M), ("data", "model"))``:

* ``layers``: ``moe_block(impl="ep")`` for each case of
  ``torch_ep_ranks.LAYER_CASES`` (jitted, as ``tests/dist_checks.py`` runs
  it): the output, the aux loss and the body ``_moe_ep`` took
  (weight-gather or partial-K, read from its ``_moe_ep_inner`` call);
* ``logits/1xM`` (M = 2, 4): the smoke model's prefill over the prompts,
  then 16 teacher-forced decode steps over the dense slab, the last
  position's logits of each, under the mesh's ``Engine`` placement;
* ``stream/1x4``: the engine's paged stream of the test's requests at 1x4,
  its tokens and counters, and for each request the logits of one forward
  over its prompt and its tokens (the near-tie rule's rows).
"""

import os
import sys

if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    sys.exit("run with XLA_FLAGS=--xla_force_host_platform_device_count=4")

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced
from repro.distributed import sharding as shd
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.models import moe as moe_mod
from repro.serve import scheduler as sm
from repro.serve.engine import Engine, EngineConfig

ARCH = "qwen3-moe-30b-a3b"
MAX_LEN, PT = 64, 8

#: the body each traced ``_moe_ep_inner`` took, in trace order
BODIES = []
_inner = moe_mod._moe_ep_inner


def _spy(*args, partial_k=False, fsdp_axis=None, **kw):
    BODIES.append("partial_k" if partial_k and fsdp_axis is not None
                  else "weight_gather")
    return _inner(*args, partial_k=partial_k, fsdp_axis=fsdp_axis, **kw)


moe_mod._moe_ep_inner = _spy


def layers(inp):
    p = {k: jnp.asarray(v) for k, v in inp["layer/params"].items()}
    out = {}
    for name, world, s, cf in inp["layer_cases"]:
        cfg = dataclasses.replace(get_reduced(ARCH), capacity_factor=cf)
        x = jnp.asarray(inp[f"layer/x{s}"]).astype(jnp.bfloat16)
        del BODIES[:]
        with shd.use_mesh(make_host_mesh(1, world)):
            y, aux = jax.jit(lambda p, x, cfg=cfg: moe_mod.moe_block(
                p, x, cfg=cfg, impl="ep"))(p, x)
        out[name] = {"y": np.asarray(y.astype(jnp.float32)),
                     "aux": float(aux), "bodies": list(BODIES)}
    return out


def engine(inp, world):
    model = build_model(get_reduced(ARCH))
    params = jax.tree.map(jnp.asarray, inp[f"{ARCH}/params"])
    return Engine(model, params, EngineConfig(
        max_len=MAX_LEN, sync_interval=4, mesh=make_host_mesh(1, world)))


def logits(eng, inp):
    model, params = eng.model, eng.params
    prompt, forced = inp["prompt"], inp["forced"]
    with eng._mesh_scope():
        lg, state = model.prefill(params, {"tokens": jnp.asarray(prompt)},
                                  MAX_LEN)
        out = [np.asarray(lg[:, -1])]
        decode = jax.jit(model.decode_step)
        for i in range(forced.shape[0]):
            lg, state = decode(params, jnp.asarray(forced[i])[:, None],
                               state,
                               jnp.asarray(prompt.shape[1] + i, jnp.int32))
            out.append(np.asarray(lg[:, -1]))
    return np.stack(out)


def stream(eng, inp):
    cfg = eng.model.cfg
    geom = sm.PageGeometry(page_tokens=PT, n_pages=41, n_spill_pages=65,
                           max_pages_per_slot=-(-MAX_LEN // PT),
                           page_bytes=sm.kv_bytes_per_token(cfg) * PT)
    sch = sm.Scheduler(3, pages=geom)
    reqs = inp["reqs"]
    rids = [sch.submit(p, g).rid for p, g in reqs]
    rep = eng.serve(scheduler=sch)
    outs = [list(map(int, rep.outputs[r])) for r in rids]
    rows = []
    with eng._mesh_scope():
        for (prompt, _), toks in zip(reqs, outs):
            seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
            lg, _ = eng.model.prefill(eng.params,
                                      {"tokens": jnp.asarray(seq)[None]},
                                      len(seq))
            rows.append(np.asarray(lg[0, len(prompt) - 1:, :cfg.vocab_size],
                                   np.float32))
    st = rep.stats
    return {"outputs": outs, "rows": rows, "host_syncs": st["host_syncs"],
            "chunks": st["chunks"], "decode_steps": st["decode_steps"]}


def main(inputs_path, out_path):
    assert jax.device_count() >= 4, jax.devices()
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    res = {"layers": layers(inp)}
    for world in (2, 4):
        eng = engine(inp, world)
        res[f"logits/1x{world}"] = logits(eng, inp)
        if world == 4:
            res["stream/1x4"] = stream(eng, inp)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    print("EP_REFERENCE_OK")


if __name__ == "__main__":
    main(*sys.argv[1:3])
