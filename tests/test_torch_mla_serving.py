"""Sharded serving of deepseek-v2-236b (multi-head latent attention, a
dense first layer, MoE layers of routed and shared experts) on gloo worlds
of 2 and 4, against the reference at ``make_mesh((1, M), ("data",
"model"))``.

One spawn of a world of 2 and one of 4 (``launch.mesh.spawn``) run
``tests/torch_mla_ranks.py``, which imports only ``repro_torch``. The
reference runs in a child python with four forced host devices
(``tests/mla_reference_child.py``), started first, in the background,
with the CLI children; the port's world 1 and the single-rank checks run
here. The smoke config has 4 heads and 8 experts, so each rank of world 2
holds 2 heads and 4 experts, of world 4 one head and 2 experts; the
latent (``wkv_a``, the slab and the pool) is whole on every rank, the
shared expert a tensor-parallel SwiGLU, the dense first layer the
tensor-parallel MLP.

* Logits: the prefill, then 16 teacher-forced decode steps, over the
  dense slab and over a shuffled latent pool (each prompt prefilled alone
  and cut into pages), every rank the same bits. Both sides record every
  MoE call's routes; the port's own routes part from the reference's at a
  router near-tie (one token of these prompts, margin 4.8e-4 under
  ``ROUTE_TIE`` = 1e-2, ``test_torch_model.py``'s): printed, and the
  margin held. The ranks then run the same logits on the reference's
  routes (``torch_mla_ranks.Replay``: the reference child writes its
  routes first, the ranks wait for them after their streams), and those
  are held to the reference's 1x2 / 1x4 at every row and step within
  ``LOGIT_TOL`` = 2e-2: the port's two-layer allowance against the
  reference on one device is 1e-2 (``test_torch_model.py``; world 1 reads
  9.4e-3 against the reference's 1x2 on these inputs) and the mesh moves
  the port from world 1 by up to 2.7e-3 (world 2), so their sum can pass
  1e-2. Measured 9.7e-3 at both worlds and on both stores (world 4's cut
  drops one hit, as the reference's does). World 2 drops nothing
  (``cap = t k``) and holds the port's world 1 (the plain every-expert
  MoE on f32 experts, on its own routes; a row whose routes part is left
  out from that step on) within ``WORLD1_TOL`` = 3e-2, the reference's
  own allowance between its dense and expert-parallel MoE (measured
  2.7e-3, no route parting).
* Streams: at world 2 every serving mode (``torch_tp_ranks.CELLS``) equals
  the world's one-shot bit for bit with one host sync a drain boundary on
  every rank; on the port's own weights int8 and fp8 latent pools agree
  with fp16's on the first token of at least 3 of 4 requests, and their
  pages (codes and the int8 scales) are the same bits on every rank: the
  latent is whole and every rank computes it alike, with no max over
  ``model``. At world 4 the paged stream's tokens are every rank's, with
  syncs == chunks, and equal the reference engine's at 1x4 on the same
  requests but where the reference's own row has a top-2 margin under
  ``TIE_TOL`` = 2e-2 at the first token they part (as
  ``test_torch_ep_serving.py``).
* Each rank's MLA leaves hold ``n_heads / M`` heads (``wq_b`` / ``wkv_b``
  columns, ``wo`` rows) and its pools the whole latent width;
  ``init_serving(gen, mesh=)`` equals ``local_shard(prepare(init(gen)))``
  bit for bit.
* On one process: ``check_serving`` admits deepseek-v2 (smoke and full)
  where the model axis divides its heads and experts and refuses it,
  naming A13c, elsewhere; ``attention.mla_heads`` raises where one of
  ``wq_b`` / ``wkv_b`` / ``wo`` is cut and another whole; ``Engine``
  refuses MLA and shared-expert leaves that are not a rank's shards; the
  shared experts' column and row shards sum to the whole SwiGLU (f32
  partials within ``SHARED_TOL`` = 1e-6 of its largest value; measured
  1.2e-7 / 1.7e-7 at 1x2 / 1x4), and
  ``moe_block`` on one device keeps its bits.
* The CLIs: ``launch.serve --mesh 2 --arch deepseek-v2-236b`` serves on
  spawned ranks and prints ``kv pool sharded 1x``; ``serve_bench.run_mesh``
  takes deepseek-v2 at ``--mesh 2`` (without ``--require-scaling``: the
  latent pool does not scale, as in the reference).
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import build_model as j_build_model
from repro_torch.configs import get_config, get_reduced
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention, build_model, layers
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve.engine import Engine, EngineConfig

import torch_mla_ranks as ranks_mod
import torch_tp_ranks as tpr

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ARCH = ranks_mod.ARCH
LOGIT_TOL = 2e-2
WORLD1_TOL = 3e-2
ROUTE_TIE = 1e-2
TIE_TOL = 2e-2
SHARED_TOL = 1e-6
#: the run_mesh head-to-head on deepseek-v2; its artifact is printed, not
#: written (the repository's artifact directory is shared)
BENCH = """
import json
import repro_torch.benchmarks.serve_bench as sb
got = {}
sb.save_artifact = lambda name, obj: got.update(obj) or name
sb.run_mesh(None, "deepseek-v2-236b", n_requests=4, mesh_spec="2",
            device="cpu")
print("ARTIFACT" + json.dumps(got, default=float))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(7)
    return {"reqs": tpr.requests(),
            "prompt": rng.randint(2, 512, size=(2, 9)).astype(np.int32),
            "forced": rng.randint(2, 512, size=(16, 2)).astype(np.int32),
            f"{ARCH}/params": jax.tree.map(np.asarray, j_build_model(
                j_get_reduced(ARCH)).init(jax.random.PRNGKey(0)))}


@pytest.fixture(scope="module")
def children(inputs, tmp_path_factory):
    """The reference child and the CLI runs, each a child python, all
    started at once; ``children[name]`` waits for one and returns (return
    code, stdout, stderr); ``children.reference`` the reference's
    results."""
    tmp = tmp_path_factory.mktemp("mla_reference")
    path, out = os.path.join(tmp, "inputs.pkl"), os.path.join(tmp, "ref.pkl")
    routes = os.path.join(tmp, "routes.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    env = _env(XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4")
               .strip())
    runs = {"reference": ([os.path.join(HERE, "mla_reference_child.py"),
                           path, routes, out], env),
            "serve": (["-m", "repro_torch.launch.serve", "--device", "cpu",
                       "--arch", ARCH, "--mesh", "2", "--stream", "4",
                       "--paged"], _env()),
            "bench": (["-c", BENCH], _env())}
    procs = {name: subprocess.Popen([sys.executable, *argv], cwd=REPO,
                                    env=e, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, (argv, e) in runs.items()}
    done = {}

    def wait(name):
        if name not in done:
            o, e = procs[name].communicate(timeout=900)
            done[name] = (procs[name].returncode, o, e)
        return done[name]

    def reference():
        rc, o, e = wait("reference")
        assert rc == 0 and "MLA_REFERENCE_OK" in o, e[-3000:]
        with open(out, "rb") as f:
            return pickle.load(f)

    wait.reference = reference
    wait.routes = routes
    yield wait
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(children):
    return children.reference()


@pytest.fixture(scope="module")
def worlds(inputs, children, tmp_path_factory):
    """Every rank's results: {2: [rank 0, rank 1], 4: [rank 0 .. 3]}."""
    out = tmp_path_factory.mktemp("mla_ranks")
    path = os.path.join(out, "inputs.pt")
    torch.save(inputs, path)
    res = {}
    for world in (2, 4):
        mesh_lib.spawn(ranks_mod.main, world, torch.device("cpu"),
                       args=(path, children.routes, str(out)))
        res[world] = [torch.load(os.path.join(out, f"w{world}_rank{r}.pt"),
                                 weights_only=False) for r in range(world)]
    return res


@pytest.fixture(scope="module")
def world1(inputs):
    """The port on one device (no mesh: the plain every-expert MoE on f32
    experts): the slab's and the pool's logits and routes."""
    torch.set_num_threads(1)
    model = build_model(get_reduced(ARCH), device="cpu")
    params = params_from_numpy(inputs[f"{ARCH}/params"], "cpu")
    eng = Engine(model, params, EngineConfig(max_len=tpr.MAX_LEN,
                                             sync_interval=4))
    return ranks_mod.logits_and_routes(eng, inputs)


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _route_rows(calls, pool, b, s):
    """Each MoE call's tokens grouped by batch row, in step order: a list
    of steps, each {row: [sorted expert ids of its tokens], ...}. The
    slab's prefill routes all rows in one call a layer; the pool's
    prefills one row a call; each decode step one token a row."""
    cfg = get_reduced(ARCH)
    n_moe = sum(k.mlp == "moe" for g in cfg.layer_groups()
                for _ in range(g.n_repeat) for k in g.pattern)
    first = b * n_moe if pool else n_moe
    steps = [calls[:first]] + [calls[i:i + n_moe]
                               for i in range(first, len(calls), n_moe)]
    out = []
    for n, step in enumerate(steps):
        rows = {r: [] for r in range(b)}
        for j, idx in enumerate(step):
            idx = np.sort(np.asarray(idx), 1)
            if n == 0 and pool:
                rows[j // n_moe].append(idx)
            elif n == 0:
                for r in range(b):
                    rows[r].append(idx[r * s:(r + 1) * s])
            else:
                for r in range(b):
                    rows[r].append(idx[r:r + 1])
        out.append({r: np.concatenate(v) for r, v in rows.items()})
    return out


def _parted(got_calls, want_calls, want_probs, pool, b, s, what):
    """{row: step} of the first step whose routes part between the two
    sides, each parting printed with the second side's router margin
    (which must be a near-tie)."""
    got = _route_rows(got_calls, pool, b, s)
    want = _route_rows(want_calls, pool, b, s)
    probs = _route_rows(want_probs, pool, b, s) if want_probs else None
    assert len(got) == len(want), (what, len(got), len(want))
    k = get_reduced(ARCH).top_k
    parted = {}
    for n, (g, w) in enumerate(zip(got, want)):
        for r in range(b):
            if r in parted or np.array_equal(g[r], w[r]):
                continue
            parted[r] = n
            tok = np.nonzero((g[r] != w[r]).any(1))[0]
            margin = None
            if probs is not None:
                top = -np.sort(-probs[n][r][tok], 1)
                margin = float((top[:, k - 1] - top[:, k]).max())
                assert margin < ROUTE_TIE, (what, r, n, margin)
            print(f"{what}: row {r}'s routes part at step {n} (tokens "
                  f"{tok.tolist()}, router margin {margin})")
    return parted


def _compare(got, want, parted, tol, what):
    """Max |d logit| over the steps and rows whose routes agree (a row
    from the step its routes parted on is left out), each step keeping at
    least one row."""
    worst = 0.0
    for n in range(got.shape[0]):
        keep = [r for r in range(got.shape[1])
                if parted.get(r, got.shape[0]) > n]
        assert keep, (what, n, parted)
        worst = max(worst, _max_err(got[n][keep], want[n][keep]))
    print(f"{what}: max |dlogit| {worst:.2e} (rows parted: {parted})")
    assert worst <= tol, (what, worst)
    return worst


# ----------------------------------------------------------------- logits


@pytest.mark.parametrize("store", ["slab", "pool"])
@pytest.mark.parametrize("world", [2, 4])
def test_logits_match_the_reference(worlds, reference, inputs, world,
                                    store):
    """On the reference's routes every row at every step; where the port's
    own routes part from the reference's, printed (a near-tie)."""
    key = "logits" if store == "slab" else "pool_logits"
    routes = "routes" if store == "slab" else "pool_routes"
    probs = "probs" if store == "slab" else "pool_probs"
    vocab = get_reduced(ARCH).vocab_size
    b, s = inputs["prompt"].shape
    first = worlds[world][0]
    _parted(first[routes], reference[f"{routes}/1x{world}"],
            reference[f"{probs}/1x{world}"], store == "pool", b, s,
            f"world {world} {store}: the port's own routes vs the "
            f"reference's 1x{world}")
    got = first[f"replayed/{key}"]
    err = _max_err(got[..., :vocab], reference[f"{key}/1x{world}"][
        ..., :vocab])
    print(f"world {world} {store} on the reference's routes: max |dlogit| "
          f"{err:.2e} vs its 1x{world}; hits dropped by the cut: "
          f"{sum(r[f'replayed/{key}_dropped'] for r in worlds[world])} "
          f"(own routes: {sum(r[f'{key}_dropped'] for r in worlds[world])})")
    assert err <= LOGIT_TOL
    for rank in worlds[world][1:]:
        np.testing.assert_array_equal(rank[key], first[key])
        np.testing.assert_array_equal(rank[f"replayed/{key}"], got)


@pytest.mark.parametrize("store", ["slab", "pool"])
def test_world2_logits_match_world1(worlds, world1, inputs, store):
    """World 2 drops no hit (``cap = t k``), so it computes one device's
    function; rows whose routes part from world 1's are left out from
    that step on."""
    key = "logits" if store == "slab" else "pool_logits"
    routes = "routes" if store == "slab" else "pool_routes"
    vocab = get_reduced(ARCH).vocab_size
    b, s = inputs["prompt"].shape
    got = worlds[2][0]
    assert all(r[f"{key}_dropped"] == 0 for r in worlds[2])
    parted = _parted(got[routes], world1[routes], None, store == "pool", b,
                     s, f"world 2 {store} vs world 1")
    _compare(got[key][..., :vocab], world1[key][..., :vocab], parted,
             WORLD1_TOL, f"world 2 {store} vs world 1")


# ---------------------------------------------------------------- streams


@pytest.mark.parametrize("cell", [c[0] for c in tpr.CELLS])
def test_world2_cell_equals_the_one_shot(worlds, cell):
    first = worlds[2][0]
    for res in worlds[2]:
        rec = res[cell]
        assert rec["host_syncs"] == rec["chunks"], cell
        for got, ref in zip(rec["outputs"], res["one_shot"]):
            assert got and got == ref[:len(got)], (cell, got, ref)
        assert rec["outputs"] == first[cell]["outputs"]
    if cell == "speculate":
        assert first[cell]["spec_proposed"] > 0
    if cell == "paged-share":
        assert first[cell]["prefix_hits"] > 0
    if cell == "disagg":
        assert first[cell]["handovers"] == len(tpr.requests())
    if cell == "squeezed":
        assert first[cell]["preemptions"] > 0
    if cell == "park":
        assert first[cell]["parks"] > 0


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_world2_quantized_latent_pools(worlds, codec):
    fp16 = worlds[2][0]["own_fp16"]["outputs"]
    first = worlds[2][0]
    for res in worlds[2]:
        rec = res[f"own_{codec}"]
        assert rec["host_syncs"] == rec["chunks"]
        assert rec["outputs"] == first[f"own_{codec}"]["outputs"]
        assert [len(o) for o in rec["outputs"]] == [len(o) for o in fp16]
        pool = res[f"own_{codec}_pool"]
        assert set(pool) == set(first[f"own_{codec}_pool"])
        for name, t in pool.items():
            assert _same_bits(t, first[f"own_{codec}_pool"][name]), name
    if codec == "int8":
        assert any(name.endswith("_scale")
                   for name in first["own_int8_pool"])
    agree = [a[0] == b[0] for a, b in zip(first[f"own_{codec}"]["outputs"],
                                          fp16)]
    assert sum(agree) >= 0.75 * len(agree), agree


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_hold_their_heads_and_the_whole_latent(worlds, world):
    cfg = get_reduced(ARCH)
    h = cfg.n_heads // world
    want = (h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim),
            h * (cfg.qk_nope_head_dim + cfg.v_head_dim), h * cfg.v_head_dim)
    first = worlds[world][0]
    for res in worlds[world]:
        assert res["heads"] and set(res["heads"].values()) == {want}
        for store in ("pool", "paged_pool"):
            widths = {name.rsplit("/", 1)[1]: t.shape[-1]
                      for name, t in res[store].items()}
            assert widths == {"ckv": cfg.kv_lora_rank,
                              "krope": cfg.qk_rope_head_dim}, widths
            for name, t in res[store].items():
                assert _same_bits(t, first[store][name]), (store, name)


def test_world4_paged_stream_against_the_reference(worlds, reference):
    ref = reference["stream/1x4"]
    first = worlds[4][0]
    rec = first["paged"]
    for res in worlds[4]:
        assert res["paged"]["host_syncs"] == res["paged"]["chunks"]
        assert res["paged"]["outputs"] == rec["outputs"]
    assert ref["host_syncs"] == ref["chunks"]
    for i, (got, want, row) in enumerate(zip(rec["outputs"], ref["outputs"],
                                             ref["rows"])):
        own = first["one_shot"][i]
        if got != own[:len(got)]:
            t = next(j for j, (a, b) in enumerate(zip(got, own)) if a != b)
            print(f"request {i}: the stream parts from its one-shot at "
                  f"token {t}")
        t = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if t is None:
            assert len(got) == len(want)
            continue
        top2 = np.sort(row[t])[-2:]
        print(f"request {i}: parts from the reference at token {t}, its "
              f"top-2 margin {top2[1] - top2[0]:.2e}")
        assert top2[1] - top2[0] < TIE_TOL, (i, t, top2)
        assert row[t][got[t]] >= top2[1] - TIE_TOL, (i, t)


def test_init_serving_cuts_mla_and_shared_leaves_before_the_cast(worlds):
    for res in worlds[2]:
        assert res["init_serving_bits"]


# ----------------------------------------------------------- one process


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_check_serving_admits_deepseek_where_m_divides(full):
    cfg = get_config(ARCH) if full else get_reduced(ARCH)
    assert tp.ep_moe_decoder(cfg) and not tp.gqa_decoder(cfg)
    for m in (1, 2, 4):
        tp.check_serving(cfg, {"data": 1, "model": m})
    refused = ((3, "experts"), (8, "heads")) if not full else (
        (3, "experts"), (5, "heads"), (64, "experts"))
    for m, what in refused:
        with pytest.raises(NotImplementedError, match=f"{what}.*A13c"):
            tp.check_serving(cfg, {"data": 1, "model": m})


class _Split:
    """Axis names, sizes and a coordinate: enough for the checks that run
    before any collective."""

    def __init__(self, model):
        self.axis_names = ("data", "model")
        self.shape = {"data": 1, "model": model}

    def coordinate(self, name):
        return 0


def _mla_layer(cfg):
    p = attention.init_mla(cfg, torch.Generator().manual_seed(3))
    return {k: (v[0] if torch.is_tensor(v) else {n: t[0]
                                               for n, t in v.items()})
            for k, v in p.items()}


@pytest.mark.parametrize("whole", ["wq_b", "wkv_b", "wo"])
def test_mla_refuses_a_leaf_left_whole_beside_cut_ones(whole):
    """``sharding`` keeps a leaf whole where a dim does not divide; one MLA
    leaf whole beside two cut ones must raise, not compute."""
    cfg = get_reduced(ARCH)
    p = _mla_layer(cfg)
    mesh = _Split(2)
    cut = {k: (v if k == whole or not torch.is_tensor(v)
               else shd.local_shard(v, shd.spec_for_param(
                   k, tuple(v.shape), mesh), mesh))
           for k, v in p.items()}
    x = torch.zeros((1, 3, cfg.d_model), dtype=torch.bfloat16)
    pos = torch.arange(3)[None]
    kind = cfg.kind_for_layer(1)
    with tp.use_mesh(mesh), pytest.raises(ValueError, match="heads"):
        attention.mla_attention(cut, x, cfg=cfg, kind=kind, positions=pos)
    assert attention.mla_heads(p, cfg) == cfg.n_heads
    with pytest.raises(ValueError, match="heads"):
        attention.mla_heads(cut, cfg)        # cut leaves without a mesh


@pytest.mark.parametrize("leaf", ["attn", "shared"])
def test_engine_wants_a_ranks_mla_and_shared_shards(leaf):
    """A mesh engine handed the embedding's shard but whole MLA (or shared
    expert) leaves raises before serving, naming the leaf."""
    cfg = get_reduced(ARCH)
    model = build_model(cfg, device="cpu")
    mesh = _Split(2)
    params = model.init_serving(torch.Generator().manual_seed(0), mesh=mesh)
    whole = model.init_serving(torch.Generator().manual_seed(0))
    for g, group in params["groups"].items():
        for k, blk in group.items():
            if leaf == "attn" and "wkv_b" in blk.get("attn", {}):
                blk["attn"] = whole["groups"][g][k]["attn"]
            if leaf == "shared" and "shared" in blk.get("moe", {}):
                blk["moe"]["shared"] = whole["groups"][g][k]["moe"]["shared"]
    with pytest.raises(ValueError, match="MLA" if leaf == "attn"
                       else "shared-expert"):
        Engine(model, params, EngineConfig(max_len=tpr.MAX_LEN, mesh=mesh))


@pytest.mark.parametrize("m", [2, 4])
def test_shared_expert_shards_sum_to_the_whole_swiglu(m):
    """Each rank's column shards of the shared ``w_gate`` / ``w_up`` and
    row shard of ``w_down`` give an f32 partial; the partials sum to the
    whole SwiGLU's f32 product within SHARED_TOL of its largest value.
    On one device (no mesh) ``mlp(..., d_ff=)`` is the plain SwiGLU bit
    for bit."""
    cfg = get_reduced(ARCH)
    f = cfg.moe_d_ff * cfg.n_shared_experts
    p = {k: v[0] for k, v in layers.init_mlp(
        torch.Generator().manual_seed(4), cfg.d_model, f).items()}
    x = torch.from_numpy(np.random.RandomState(4).randn(
        3, 5, cfg.d_model).astype(np.float32)).to(torch.bfloat16)
    def partial(cut):
        """The f32 ``w_down`` product of the columns / rows ``cut``."""
        h = torch.nn.functional.silu(layers.linear(x, p["w_gate"][:, cut])) \
            * layers.linear(x, p["w_up"][:, cut])
        return layers.dot_f32(h, p["w_down"][cut])

    n = f // m
    want = partial(slice(None))
    total = sum(partial(slice(r * n, (r + 1) * n)) for r in range(m))
    err = float((total - want).abs().max() / want.abs().max())
    print(f"1x{m}: the shared expert's partials sum within {err:.1e} of "
          f"its largest value")
    assert err <= SHARED_TOL
    assert torch.equal(layers.mlp(p, x, d_ff=f), layers.mlp(p, x))


# ------------------------------------------------------------------- CLIs


def test_serve_cli_serves_deepseek_on_two_ranks(children):
    rc, out, err = children("serve")
    assert rc == 0, err[-3000:]
    assert "mesh: 1x2 (data x model), kv pool sharded 1x" in out
    assert "completed 4/4" in out


def test_serve_bench_mesh_takes_deepseek(children):
    rc, out, err = children("bench")
    assert rc == 0, err[-3000:]
    got = json.loads(out.split("ARTIFACT", 1)[1])
    assert got["arch"].startswith(ARCH)
    assert got["mesh_run"]["kv_shards"] == 1
    for side in ("base", "mesh_run"):
        assert got[side]["host_syncs"] == got[side]["boundaries"]
        assert got[side]["completed"] == 4
