"""Sharded serving of the GQA decoders on gloo worlds of 2 and 4, against
the reference and the port's single-device engine, and the mesh CLIs.

One spawn of a world of 2 and one of a world of 4 (``launch.mesh.spawn``,
``torch.set_num_threads(1)`` in each rank) run ``tests/torch_tp_ranks.py``,
which imports only ``repro_torch``; the reference and the port's world 1
(no mesh) are computed here, in the test process, on the same numpy
weights and inputs. The counterpart of ``tests/mesh_matrix_check.py`` and
``tests/dist_checks.py:161-188``.

* World 2 is the head path: qwen2.5-3b's smoke config has 4 query heads
  over 2 KV heads, so each rank projects, caches and attends over 2 query
  heads and 1 KV head, and ``wo`` / ``w_down`` are row-parallel. World 4 is
  the pooled path: 2 KV heads do not divide 4, so the caches are whole on
  every rank and each decode step attends over a quarter of each slot's
  positions, merged by log-sum-exp.
* Logits (prefill, then 16 teacher-forced decode steps over the dense
  slab), every rank's the same bits. World 2 against the reference's
  single-device logits within ``LOGIT_TOL`` = 1e-2, the port's 2-layer
  tolerance against the reference (``test_torch_model.py``; measured
  6.1e-3, as world 1's), and against the port's world 1 within
  ``WORLD_TOL`` = 1e-3: its row-parallel products add two f32 partials in
  another order than one device (measured 0: no bf16 rounding moved).
  World 4 within ``POOLED_TOL`` = 3e-2 of both, the reference's own
  allowance for its pooled decode (``tests/dist_checks.py:184-187``):
  each rank's range output is rounded to bf16 before the four are merged
  (measured 7.2e-3 against the reference, 8.1e-3 against world 1). A
  forward without caches (the teacher-forced check's) against world 1's
  at the same tolerances (measured 0 at worlds 2 and 4).
* Tokens: every cell (paged, paged-share, chunked, speculate, dense,
  disaggregated roles, a pool squeezed until it preempts, a stream parked
  to the host tier and resumed; world 4 the paged, speculative and dense
  ones) of a world equals that world's one-shot ``generate`` bit for bit,
  with one host sync a drain boundary (the decode role's, when
  disaggregated) on every rank, and every rank emits the same tokens. Against the reference's single-device tokens the world-2
  one-shot rollouts are equal except where the reference's teacher-forced
  top-2 margin is under ``TIE_TOL`` = 2e-2 (the near-tie rule of
  ``test_torch_serve_modes.py``).
* ``Model.init_serving(gen, mesh=)`` on each rank of world 2 equals
  ``local_shard(prepare(init(gen)))`` bit for bit. On those weights (the
  port's own, seed 0) an int8 stream at world 2 emits world 1's tokens,
  and each rank's page codes and scales equal world 1's for its KV head,
  bit for bit (the scale is one absmax over every head of a token: a max
  over ``model``); so do the int8 spill pages of an fp8 stream squeezed
  until it preempts (the tier copy requantizes each page). On the reference's weights the same stream parts from
  world 1 at its last request's first token, a near-tie (top-2 margin
  3.4e-4) that world 2's order of f32 additions flips; from there the two
  streams write other tokens' K/V, so the pages are compared where the
  streams agree.
* The CLIs: ``launch.serve --mesh 2`` / ``--mesh 4 --stream 4 --paged`` on
  spawned ranks print the mesh line (``kv pool sharded 2x`` / ``1x``);
  ``serve_bench --mesh 2 --require-scaling --requests 8`` passes, and its
  host counters (slots, kv shards, pages, pages high water, decode steps,
  tokens per forward, the modeled scaling) equal those of the reference's
  ``run_mesh`` at the same arguments, run once in a child python with two
  forced host devices (as ``test_equivalence_matrix.py`` runs
  ``mesh_matrix_check.py``). The CLIs and the reference's child start
  first, in the background, so they overlap the spawns.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import build_model as j_build_model
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch.benchmarks.common import ARTIFACT_ROOT
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve.engine import Engine, EngineConfig

import torch_tp_ranks as ranks_mod

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LOGIT_TOL = 1e-2
WORLD_TOL = 1e-3
POOLED_TOL = 3e-2
#: world -> (tolerance against the reference, against world 1)
TOLS = {2: (LOGIT_TOL, WORLD_TOL), 4: (POOLED_TOL, POOLED_TOL)}
TIE_TOL = 2e-2
MAX_LEN = ranks_mod.MAX_LEN
BENCH_ARGS = ["--mesh", "2", "--require-scaling", "--requests", "8"]
COUNTERS = ("n_slots", "kv_shards", "n_pages", "pages_high_water",
            "decode_steps", "tok_per_forward")
#: (world, cell): world 2 runs every cell, world 4 the paged, speculative
#: (a range split of every verify column) and dense ones
WORLD_CELLS = ([(2, c[0]) for c in ranks_mod.CELLS]
               + [(4, c) for c in ranks_mod.WORLD4_CELLS])
#: the reference's run_mesh at BENCH_ARGS; its artifact is printed, not
#: written, so the repository's artifact directory is left as it is
REF_BENCH = """
import json
import benchmarks.serve_bench as sb
got = {}
sb.save_artifact = lambda name, obj: got.update(obj) or name
sb.run_mesh(None, "qwen2.5-3b", n_requests=8, mesh_spec="2",
            require_scaling=True)
print("ARTIFACT" + json.dumps(got, default=float))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(extra)
    return env


#: the CLI runs, each a child python: (name, argv)
CLI_RUNS = (("serve2", ["-m", "repro_torch.launch.serve", "--device", "cpu",
                        "--mesh", "2", "--stream", "4", "--paged"]),
            ("serve4", ["-m", "repro_torch.launch.serve", "--device", "cpu",
                        "--mesh", "4", "--stream", "4", "--paged"]),
            ("bench", ["-m", "repro_torch.benchmarks.serve_bench",
                       "--device", "cpu", *BENCH_ARGS]))


@pytest.fixture(scope="module")
def children():
    """The CLI runs and the reference's run_mesh, each a child python,
    all started at once; ``children[name]`` waits for one and returns
    (return code, stdout, stderr)."""
    env = _env(XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=2")
               .strip())
    procs = {"reference": subprocess.Popen(
        [sys.executable, "-c", REF_BENCH], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for name, argv in CLI_RUNS:
        procs[name] = subprocess.Popen(
            [sys.executable, *argv], cwd=REPO, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = {}

    def wait(name):
        if name not in done:
            out, err = procs[name].communicate(timeout=900)
            done[name] = (procs[name].returncode, out, err)
        return done[name]

    yield wait
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


_requests = ranks_mod.requests


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(2)
    out = {"reqs": _requests(),
           "prompt": rng.randint(2, 512, size=(2, 9)).astype(np.int32),
           "forced": rng.randint(2, 512, size=(16, 2)).astype(np.int32)}
    out["gemma_reqs"] = out["reqs"][2:]
    for arch in ("qwen2.5-3b", "gemma3-27b"):
        out[f"{arch}/params"] = jax.tree.map(
            np.asarray, j_build_model(j_get_reduced(arch)).init(
                jax.random.PRNGKey(0)))
    return out


@pytest.fixture(scope="module")
def worlds(inputs, children, tmp_path_factory):
    """Every rank's results: {2: [rank 0, rank 1], 4: [rank 0 .. 3]}."""
    out = tmp_path_factory.mktemp("tp_ranks")
    path = os.path.join(out, "inputs.pt")
    torch.save(inputs, path)
    res = {}
    for world in (2, 4):
        mesh_lib.spawn(ranks_mod.main, world, torch.device("cpu"),
                       args=(path, str(out)))
        res[world] = [torch.load(os.path.join(out, f"w{world}_rank{r}.pt"),
                                 weights_only=False) for r in range(world)]
    return res


@pytest.fixture(scope="module")
def world1(inputs):
    """The port's single-device engine: logits on the reference's weights,
    the int8 stream's tokens and pool on its own (seed 0)."""
    torch.set_num_threads(1)
    cfg = get_reduced("qwen2.5-3b")
    model = build_model(cfg, device="cpu")
    ecfg = EngineConfig(max_len=MAX_LEN, sync_interval=4)
    eng = Engine(model, params_from_numpy(inputs["qwen2.5-3b/params"], "cpu"),
                 ecfg)
    res = {"logits": ranks_mod.logits(eng, inputs),
           "forward": ranks_mod.forward_logits(eng, inputs)}
    eng = Engine(model, model.init_serving(torch.Generator().manual_seed(0)),
                 ecfg)
    res["int8"] = ranks_mod.serve(eng, inputs["reqs"],
                                  ranks_mod.geometry(cfg, "int8"))
    res["int8_pool"] = ranks_mod.pool_leaves(eng)
    res["fp8_squeezed"] = ranks_mod.serve(eng, inputs["reqs"],
                                          ranks_mod.geometry(
                                              cfg, "fp8",
                                              ranks_mod.SQUEEZED_PAGES,
                                              spill_codec="int8"))
    res["fp8_spill"] = ranks_mod.spill_leaves(eng)
    return res


@pytest.fixture(scope="module")
def reference(inputs):
    """The reference's single-device logits and one-shot tokens."""
    jm = j_build_model(j_get_reduced("qwen2.5-3b"))
    jp = jax.tree.map(jnp.asarray, inputs["qwen2.5-3b/params"])
    prompt, forced = inputs["prompt"], inputs["forced"]
    lg, state = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, MAX_LEN)
    out = [np.asarray(lg[:, -1])]
    decode = jax.jit(jm.decode_step)
    for i in range(forced.shape[0]):
        lg, state = decode(jp, jnp.asarray(forced[i])[:, None], state,
                           jnp.asarray(prompt.shape[1] + i, jnp.int32))
        out.append(np.asarray(lg[:, -1]))
    eng = JEngine(jm, jp, JEngineConfig(max_len=MAX_LEN, sync_interval=4))
    toks = []
    for p, g in inputs["reqs"]:
        t, _ = eng.generate({"tokens": jnp.asarray(p)[None]}, n_steps=g)
        toks.append([int(x) for x in np.asarray(t)[0]])
    return {"logits": np.stack(out), "tokens": toks, "model": jm,
            "params": jp}


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


@pytest.mark.parametrize("world", [2, 4])
def test_logits_match_the_reference_and_world1(worlds, world1, reference,
                                               world):
    got = worlds[world][0]["logits"]
    vocab = get_reduced("qwen2.5-3b").vocab_size
    ref = _max_err(got[..., :vocab], reference["logits"][..., :vocab])
    one = _max_err(got, world1["logits"])
    print(f"world {world}: max |dlogit| {ref:.2e} vs the reference, "
          f"{one:.2e} vs world 1")
    assert ref <= TOLS[world][0]
    assert one <= TOLS[world][1]
    for rank in worlds[world][1:]:
        np.testing.assert_array_equal(rank["logits"], got)


@pytest.mark.parametrize("world", [2, 4])
def test_forward_without_caches_matches_world1(worlds, world1, world):
    """The teacher-forced check's forward (no caches: attention over the
    whole sequence, on the pooled path over q / k / v gathered whole)."""
    err = _max_err(worlds[world][0]["forward"], world1["forward"])
    print(f"world {world}: no-cache forward max |dlogit| {err:.2e}")
    assert err <= TOLS[world][1]


@pytest.mark.parametrize("world,cell", WORLD_CELLS)
def test_cell_equals_the_worlds_one_shot(worlds, world, cell):
    """Each serving mode's tokens are a prefix of the same world's one-shot
    rollout, with one host sync a drain boundary, on every rank."""
    first = worlds[world][0]
    for res in worlds[world]:
        rec = res[cell]
        assert rec["host_syncs"] == rec["chunks"], (world, cell)
        for got, ref in zip(rec["outputs"], res["one_shot"]):
            assert got and got == ref[:len(got)], (world, cell, got, ref)
        assert rec["outputs"] == first[cell]["outputs"]
    if cell == "speculate":
        assert first[cell]["spec_proposed"] > 0
    if cell == "paged-share":
        assert first[cell]["prefix_hits"] > 0
    if cell == "disagg":
        assert first[cell]["handovers"] == len(_requests())
    if cell == "squeezed":
        assert first[cell]["preemptions"] > 0
    if cell == "park":
        assert first[cell]["parks"] > 0


@pytest.mark.parametrize("world,heads", [(2, 1), (4, 2)])
def test_each_rank_holds_its_kv_heads(worlds, world, heads):
    """Head path: one KV head a rank; pooled: both, whole."""
    assert all(r["local_kv_heads"] == heads for r in worlds[world])


def test_world2_tokens_match_the_reference(worlds, reference):
    jm, jp = reference["model"], reference["params"]
    for (prompt, _), want, got in zip(_requests(), reference["tokens"],
                                      worlds[2][0]["one_shot"]):
        t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                 None)
        if t is None:
            assert len(got) == len(want)
            continue
        seq = np.concatenate([prompt, np.asarray(want[:t], np.int32)])[None]
        logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(seq)},
                               seq.shape[1])
        row = np.asarray(logits[0, -1, :jm.cfg.vocab_size], np.float64)
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] < TIE_TOL, (t, top2)
        assert row[got[t]] >= top2[1] - TIE_TOL, t


@pytest.mark.parametrize("stream,pool", [("int8", "int8_pool"),
                                         ("fp8_squeezed", "fp8_spill")])
def test_world2_int8_pages_equal_world1(worlds, world1, stream, pool):
    """Each rank's int8 codes and scales are world 1's for its KV head:
    the int8 stream's layer-0 pool, and the spill tier of an fp8 stream
    squeezed until it preempts (each spilled page requantized to int8)."""
    one = world1[pool]
    if stream == "fp8_squeezed":
        assert world1[stream]["preemptions"] > 0
    for rank, res in enumerate(worlds[2]):
        assert res["init_serving_bits"], rank
        assert res[stream]["host_syncs"] == res[stream]["chunks"]
        assert res[stream]["outputs"] == world1[stream]["outputs"]
        for name, leaf in res[pool].items():
            if name.endswith("_scale"):
                assert torch.equal(leaf, one[name]), (rank, name)
            else:                   # (repeats, pages, Hkv, pt, D)
                assert leaf.dtype == torch.int8
                assert torch.equal(leaf, one[name][:, :, rank:rank + 1]), (
                    rank, name)


def test_world2_gemma_window_paged_stream(worlds):
    """gemma3-27b's smoke config (window 16 on its local layers) on the
    head path: the paged stream past the window equals the one-shot."""
    for res in worlds[2]:
        rec = res["gemma_paged"]
        assert rec["host_syncs"] == rec["chunks"]
        for got, ref in zip(rec["outputs"], res["gemma_one_shot"]):
            assert got and got == ref[:len(got)]
    assert max(len(p) + g for p, g in _requests()[2:]) > 16


@pytest.mark.parametrize("mesh,shards", [("2", 2), ("4", 1)])
def test_serve_cli_spawns_its_ranks(children, mesh, shards):
    rc, out, err = children(f"serve{mesh}")
    assert rc == 0, err[-3000:]
    assert f"mesh: 1x{mesh} (data x model), kv pool sharded {shards}x" in out
    assert "completed 4/4" in out
    assert out.count("completed") == 1         # rank 0 alone reports


def test_serve_bench_mesh_matches_the_reference(children):
    rc, _, err = children("bench")
    assert rc == 0, err[-3000:]
    with open(os.path.join(ARTIFACT_ROOT, "serve_mesh_bench.json")) as f:
        port = json.load(f)
    rc, out, err = children("reference")
    assert rc == 0, err[-3000:]
    ref = json.loads(out.split("ARTIFACT", 1)[1])
    assert port["scaling_modeled"] >= 1.7
    assert port["scaling_modeled"] == ref["scaling_modeled"]
    for side in ("base", "mesh_run"):
        for key in COUNTERS:
            assert port[side][key] == ref[side][key], (side, key)
        assert port[side]["host_syncs"] == port[side]["boundaries"]
