"""The reference side of ``tests/test_torch_mla_serving.py`` (NOT a pytest
file): run as a child python with four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set before JAX
imports; ``tests/conftest.py`` forbids the flag in the pytest process).

    python tests/mla_reference_child.py INPUTS.pkl ROUTES.pkl OUT.pkl

Reads the numpy weights and inputs the test made, and writes, for
deepseek-v2-236b's smoke config under ``make_mesh((1, M), ("data",
"model"))`` (M = 2, 4; the mesh engine's placement):

* ``logits/1xM``: the prefill over the prompts, then 16 teacher-forced
  decode steps over the dense slab, the last position's logits of each;
  ``pool_logits/1xM``: each prompt prefilled alone and cut into a
  shuffled latent pool (``slot_update_paged``), then the same decode steps
  over the pool; ``routes/1xM`` / ``pool_routes/1xM``: the routes of every
  MoE call of each, in call order, taken from the layer input as
  ``_moe_ep`` routes it (each shard routes every token with the
  replicated f32 router; a ``jax.debug.callback``, read after each
  forward, before the next; the smoke config has one MoE layer) and
  ``probs/1xM`` / ``pool_probs/1xM`` their router probabilities (the
  near-tie margins); the routes are written to ROUTES.pkl first (the
  port's ranks replay them), the rest to OUT.pkl;
* ``stream/1x4``: the engine's paged stream of the test's requests at
  1x4, its tokens and counters, and for each request the logits of one
  forward over its prompt and its tokens (the near-tie rule's rows;
  ``ep_reference_child.stream``).
"""

import os
import sys

if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    sys.exit("run with XLA_FLAGS=--xla_force_host_platform_device_count=4")

import pickle

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.models import moe as moe_mod
from repro.models import transformer as jt
from repro.serve.engine import Engine, EngineConfig

from ep_reference_child import stream  # the same stream and rows

ARCH = "deepseek-v2-236b"
MAX_LEN, PT = 64, 8
#: the same tables as tests/torch_mla_ranks.py's
POOL_TABLES = np.asarray([[3, 7, 1, 5], [2, 8, 6, 4]], np.int32)
POOL_PAGES = 9

#: (idx, probs) of every forward's MoE call while recording, by the
#: forward's place in the run (the smoke config has one MoE layer)
ROUTES = {}
STEP = [None]
_moe_ep = moe_mod._moe_ep


def _record(idx, probs):
    # an SPMD program calls back once per device: keep the first
    if STEP[0] is not None:
        ROUTES.setdefault(STEP[0], (np.asarray(idx), np.asarray(probs)))


def _spy(p, x3, cfg, mesh):
    _, idx, probs = moe_mod._route(p["router"], x3.reshape(-1, x3.shape[-1]),
                                   cfg.top_k)
    jax.debug.callback(_record, idx, probs)
    return _moe_ep(p, x3, cfg, mesh)


moe_mod._moe_ep = _spy


def _forward(i, fn, *args, **kw):
    """The ``i``-th forward of a recorded run: its logits read to the host
    (so its callbacks have run) before the next starts."""
    STEP[0] = i
    lg, state = fn(*args, **kw)
    lg = np.asarray(lg[:, -1])
    jax.effects_barrier()
    STEP[0] = None
    return lg, state


def engine(inp, world):
    model = build_model(get_reduced(ARCH))
    params = jax.tree.map(jnp.asarray, inp[f"{ARCH}/params"])
    return Engine(model, params, EngineConfig(
        max_len=MAX_LEN, sync_interval=4, mesh=make_host_mesh(1, world)))


def _recorded(fn, n_forwards):
    ROUTES.clear()
    out = fn()
    assert sorted(ROUTES) == list(range(n_forwards)), sorted(ROUTES)
    calls = [ROUTES[i] for i in range(n_forwards)]
    return out, [c[0] for c in calls], [c[1] for c in calls]


def logits(eng, inp):
    model, params = eng.model, eng.params
    prompt, forced = inp["prompt"], inp["forced"]
    decode = jax.jit(model.decode_step)
    with eng._mesh_scope():
        lg, state = _forward(0, model.prefill, params,
                             {"tokens": jnp.asarray(prompt)}, MAX_LEN)
        out = [lg]
        for i in range(forced.shape[0]):
            lg, state = _forward(
                i + 1, decode, params, jnp.asarray(forced[i])[:, None],
                state, jnp.asarray(prompt.shape[1] + i, jnp.int32))
            out.append(lg)
    return np.stack(out)


def pool_logits(eng, inp):
    model, params = eng.model, eng.params
    prompt, forced = inp["prompt"], inp["forced"]
    b = prompt.shape[0]
    place = getattr(eng, "core", eng)._place
    depth = PT * POOL_TABLES.shape[1]
    decode = jax.jit(model.decode_step)
    with eng._mesh_scope():
        pool = {"caches": place(jt.init_paged_caches(
            model.cfg, b, POOL_PAGES, PT))}
        first = []
        for slot in range(b):
            lg, row = _forward(
                slot, model.prefill, params,
                {"tokens": jnp.asarray(prompt[slot:slot + 1])}, depth,
                last_pos=jnp.asarray([prompt.shape[1] - 1]))
            first.append(lg[0])
            pool = model.slot_update_paged(pool, row, jnp.asarray(slot),
                                           jnp.asarray(POOL_TABLES[slot]),
                                           PT)
        out = [np.stack(first)]
        bt = jnp.asarray(POOL_TABLES)
        for i in range(forced.shape[0]):
            cl = jnp.full((b,), prompt.shape[1] + i, jnp.int32)
            lg, pool = _forward(b + i, decode, params,
                                jnp.asarray(forced[i])[:, None], pool, cl,
                                block_tables=bt)
            out.append(lg)
    return np.stack(out)


def _write(obj, path):
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


def main(inputs_path, routes_path, out_path):
    assert jax.device_count() >= 4, jax.devices()
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    cfg = get_reduced(ARCH)
    assert sum(k.mlp == "moe" for g in cfg.layer_groups()
               for _ in range(g.n_repeat) for k in g.pattern) == 1
    b, steps = inp["prompt"].shape[0], inp["forced"].shape[0]
    res = {}
    for world in (2, 4):
        eng = engine(inp, world)
        for key, fn, n in (("logits", logits, 1 + steps),
                           ("pool_logits", pool_logits, b + steps)):
            out, idx, probs = _recorded(lambda: fn(eng, inp), n)
            res[f"{key}/1x{world}"] = out
            res[f"{key.replace('logits', 'routes')}/1x{world}"] = idx
            res[f"{key.replace('logits', 'probs')}/1x{world}"] = probs
    _write({k: v for k, v in res.items() if "routes/" in k}, routes_path)
    res["stream/1x4"] = stream(engine(inp, 4), inp)
    _write(res, out_path)
    print("MLA_REFERENCE_OK")


if __name__ == "__main__":
    main(*sys.argv[1:4])
