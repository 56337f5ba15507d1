"""Expert-parallel MoE serving (qwen3-moe-30b-a3b's smoke config: d 64, 8
experts of width 64, top-2) on gloo worlds of 2 and 4, against the
reference's ``_moe_ep`` at ``make_mesh((1, M), ("data", "model"))``.

One spawn of a world of 2 and one of 4 (``launch.mesh.spawn``) run
``tests/torch_ep_ranks.py``, which imports only ``repro_torch``. The
reference runs in a child python with four forced host devices
(``tests/ep_reference_child.py``, as ``tests/dist_checks.py`` runs),
started first, in the background, with the CLI children; the port's world
1 and the checks of single ranks run here.

* The layer, ``moe_block(impl="ep")`` on a 4-row batch: at t = 64 and t =
  4, and in three cases that drop hits, the port's byte rule
  (``moe.ep_body``) takes the reference's body (weight-gather or
  partial-K, read from the reference's ``_moe_ep_inner`` call) on every
  rank, and the output is the reference's bit for bit (measured: the same
  bits in every case), the aux within 1e-5 (measured 0). Both compute
  bf16 products with f32 accumulation and sum over ``model`` in bf16
  (weight-gather) or f32 (partial-K). At world 2 the reference's output
  is its body's sum of the two ranks' shares, and the other body's sum
  differs from it: so the bit-for-bit check sees the sum's precision.
* Drops: on each rank, ``moe.ep_route``'s kept hits equal a numpy
  recomputation of the reference's stable sort and cut, and the hits the
  ranks dropped equal numpy's count (> 0 in the drop cases). Rows past the
  last offset filled with NaN never reach a rank's output.
* Logits (prefill, then 16 teacher-forced decode steps over the dense
  slab): world 2 within ``LOGIT_TOL`` = 1e-2 of the reference's 1x2, and
  within ``WORLD1_TOL`` = 3e-2 of the port's world 1 (M = 2 drops
  nothing; one device on the CPU runs the plain every-expert MoE on f32
  experts, the expert-parallel one bf16-cast experts: the reference's own
  allowance between the two); world 4 (the pooled attention path: 2 KV
  heads over 4 ranks) within ``POOLED_TOL`` = 3e-2 of the reference's
  1x4; every rank the same bits. Measured 6.4e-3 (1x2), 1.4e-2 (world 1)
  and 7.0e-3 (1x4).
* Streams: at world 2 every serving mode equals the world's one-shot bit
  for bit with one host sync a drain boundary on every rank; int8 / fp8
  pages on the port's own weights agree with fp16 pages on the first
  token of at least 3 of 4 requests. At world 4 the paged stream's tokens
  are every rank's, and equal the reference engine's at 1x4 on the same
  requests and slots but where the reference's own row (a forward over
  the prompt and its tokens) has a top-2 margin under ``TIE_TOL`` = 2e-2
  at the first token they part (measured: no part). Above two ranks a
  row's output depends on its call's other rows, idle slots included:
  the cap drops by them, and gloo sums more than two partials in an
  order that follows the buffer's size. So at world 4 a stream may part
  from its one-shot at a router near-tie: the test prints where, with
  the hits dropped.
* ``init_serving(gen, mesh=)`` equals ``local_shard(prepare(init(gen)))``
  bit for bit, expert leaves included (4 experts a rank at world 2); a
  sharded train step (its MoE experts gathered at use) makes no
  expert-parallel call and takes one device's loss within 2e-4.
* The CLIs: ``launch.serve --mesh 2 --arch qwen3-moe-30b-a3b`` serves on
  spawned ranks and prints the mesh line; ``--mesh 3``, deepseek-v2 at
  ``--mesh 8`` (its 4 heads do not split) and jamba at ``--mesh 2`` raise
  naming A13c; ``serve_bench.run_mesh`` takes
  qwen3-moe at ``--mesh 2 --require-scaling``.
"""

import dataclasses
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
from repro.models import moe as jmoe
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as cli
from repro_torch.models import build_model, moe
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.train import loop
from repro_torch.train import optimizer as opt_mod

import torch_ep_ranks as ranks_mod
import torch_tp_ranks as tpr

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ARCH = ranks_mod.ARCH
LOGIT_TOL = 1e-2
POOLED_TOL = 3e-2
#: world 2 against the port's world 1, whose CPU MoE is the plain one on
#: f32 experts: the reference's own allowance between its dense and
#: expert-parallel MoE (tests/dist_checks.py:38-41)
WORLD1_TOL = 3e-2
TIE_TOL = 2e-2
LOSS_TOL = 2e-4
CASES = {c[0]: c for c in ranks_mod.LAYER_CASES}
DROP_CASES = ("drop2", "pk4", "drop4")
#: the run_mesh head-to-head on qwen3-moe; its artifact is printed, not
#: written (the repository's artifact directory is shared with
#: test_torch_tp_serving.py's run_mesh)
BENCH = """
import json
import repro_torch.benchmarks.serve_bench as sb
got = {}
sb.save_artifact = lambda name, obj: got.update(obj) or name
sb.run_mesh(None, "qwen3-moe-30b-a3b", n_requests=4, mesh_spec="2",
            require_scaling=True, device="cpu")
print("ARTIFACT" + json.dumps(got, default=float))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(extra)
    return env


def _bf16(a):
    return np.asarray(torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float())


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(5)
    jcfg = j_get_reduced(ARCH)
    out = {"reqs": _requests(),
           "prompt": rng.randint(2, 512, size=(2, 9)).astype(np.int32),
           "forced": rng.randint(2, 512, size=(16, 2)).astype(np.int32),
           "train": {"tokens": rng.randint(2, 512, (2, 16)).astype(np.int32)},
           "layer_cases": ranks_mod.LAYER_CASES,
           "layer/params": jax.tree.map(np.asarray, jmoe.init_moe(
               jcfg, jax.random.PRNGKey(5))),
           f"{ARCH}/params": jax.tree.map(np.asarray, j_build_model(
               jcfg).init(jax.random.PRNGKey(0)))}
    out["train"]["labels"] = np.roll(out["train"]["tokens"], -1, axis=1)
    for s in (1, 16):
        out[f"layer/x{s}"] = _bf16(rng.randn(4, s, jcfg.d_model))
    return out


_requests = tpr.requests


@pytest.fixture(scope="module")
def children(inputs, tmp_path_factory):
    """The reference child and the CLI runs, each a child python, all
    started at once; ``children[name]`` waits for one and returns (return
    code, stdout, stderr); ``children.reference`` the reference's
    results."""
    tmp = tmp_path_factory.mktemp("ep_reference")
    path, out = os.path.join(tmp, "inputs.pkl"), os.path.join(tmp, "ref.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    env = _env(XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4")
               .strip())
    runs = {"reference": ([os.path.join(HERE, "ep_reference_child.py"),
                           path, out], env),
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
        assert rc == 0 and "EP_REFERENCE_OK" in o, e[-3000:]
        with open(out, "rb") as f:
            return pickle.load(f)

    wait.reference = reference
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
    out = tmp_path_factory.mktemp("ep_ranks")
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
    """The port on one device (no mesh: the plain every-expert MoE on f32
    experts): logits, and one train step's loss."""
    torch.set_num_threads(1)
    model = build_model(get_reduced(ARCH), device="cpu")
    params = params_from_numpy(inputs[f"{ARCH}/params"], "cpu")
    eng = Engine(model, params, EngineConfig(max_len=tpr.MAX_LEN,
                                             sync_interval=4))
    tcfg = loop.TrainConfig(opt=opt_mod.OptConfig(warmup_steps=1))
    step = loop.make_train_step(model, tcfg)
    batch = {k: torch.from_numpy(v) for k, v in inputs["train"].items()}
    _, _, metrics = step(params, opt_mod.init_opt_state(params, tcfg.opt),
                         batch)
    return {"logits": tpr.logits(eng, inputs),
            "loss": float(metrics["total_loss"])}


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def _world(name):
    return CASES[name][1]


# ------------------------------------------------------------------ layer


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_takes_the_reference_body(worlds, reference, case):
    want = reference["layers"][case]["bodies"]
    assert len(set(want)) == 1, want
    _, world, s, cf = CASES[case]
    assert moe.ep_body(_case_cfg(cf), 4, s, world) == want[0]
    for rank in worlds[world]:
        assert rank["layers"][case]["bodies"] == {want[0]: 1}, rank


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_the_reference(worlds, reference, case):
    ref = reference["layers"][case]
    got = worlds[_world(case)][0]["layers"][case]
    err = _max_err(got["y"], ref["y"])
    print(f"{case}: max |dy| {err:.2e} (|y| <= "
          f"{np.abs(ref['y']).max():.3f}), aux {got['aux']:.6f} vs "
          f"{ref['aux']:.6f}")
    assert got["dtype"] == "torch.bfloat16"
    np.testing.assert_array_equal(got["y"], ref["y"])
    assert abs(got["aux"] - ref["aux"]) <= 1e-5 * max(1.0, abs(ref["aux"]))
    for rank in worlds[_world(case)][1:]:
        np.testing.assert_array_equal(rank["layers"][case]["y"], got["y"])


def test_the_sums_precision_tells_the_bodies_apart(inputs, reference):
    """At world 2 the reference's output is its body's sum of the two
    ranks' shares (``moe._ep_partial``, f32) bit for bit: the weight-gather
    body's bf16 sum, the partial-K body's f32 sum cast once. The other
    body's sum differs from it in some case, so a port that summed in the
    other precision would fail the bit-for-bit layer check."""
    differ = []
    for case in sorted(c for c in CASES if _world(c) == 2):
        _, world, s, cf = CASES[case]
        cfg = _case_cfg(cf)
        xt = torch.from_numpy(inputs[f"layer/x{s}"]).to(
            torch.bfloat16).reshape(-1, cfg.d_model)
        a, b = (moe._ep_partial(_rank_params(inputs, world, r), xt, cfg, r,
                                world)[0] for r in range(world))
        sums = {moe.WEIGHT_GATHER: (a.to(torch.bfloat16)
                                    + b.to(torch.bfloat16)).float().numpy(),
                moe.PARTIAL_K: (a + b).to(torch.bfloat16).float().numpy()}
        want = reference["layers"][case]["y"]
        body = moe.ep_body(cfg, 4, s, world)
        np.testing.assert_array_equal(sums[body].reshape(want.shape), want)
        other, = (v for k, v in sums.items() if k != body)
        if not np.array_equal(other.reshape(want.shape), want):
            differ.append(case)
    print(f"the other body's sum differs from the reference in {differ}")
    assert differ


def _numpy_kept(idx, cfg, rank, world, t):
    """The reference's stable sort and cut, in numpy: the flat hits
    (``token k + j``) rank ``rank`` keeps of its own experts, and how many
    of its own it drops."""
    e_loc = cfg.n_experts // world
    flat = idx.reshape(-1)
    lo = rank * e_loc
    local = (flat >= lo) & (flat < lo + e_loc)
    loc_e = np.where(local, flat - lo, e_loc)
    order = np.argsort(loc_e, kind="stable")
    cap = min(t * cfg.top_k, int(np.ceil(cfg.capacity_factor * t * cfg.top_k
                                         / world)))
    sel = order[:cap]
    kept = sel[loc_e[sel] < e_loc]
    return kept, int(local.sum()) - len(kept)


def _rank_params(inputs, world, rank):
    p = {k: torch.from_numpy(np.array(v))
         for k, v in inputs["layer/params"].items()}
    e_loc = p["we_gate"].shape[0] // world
    return {k: (v[rank * e_loc:(rank + 1) * e_loc] if k != "router" else v)
            for k, v in p.items()}


def _case_cfg(cf):
    return dataclasses.replace(get_reduced(ARCH), capacity_factor=cf)


@pytest.mark.parametrize("case", DROP_CASES)
def test_drops_keep_the_reference_hits(worlds, inputs, case):
    _, world, s, cf = CASES[case]
    cfg = _case_cfg(cf)
    x = torch.from_numpy(inputs[f"layer/x{s}"]).to(torch.bfloat16)
    xt = x.reshape(-1, cfg.d_model)
    dropped = 0
    for rank in range(world):
        p = _rank_params(inputs, world, rank)
        r = moe.ep_route(p["router"], xt, cfg, rank, world)
        e_loc = cfg.n_experts // world
        got = r.sel[r.sel_e < e_loc].numpy()
        want, drop = _numpy_kept(r.idx.numpy(), cfg, rank, world,
                                 xt.shape[0])
        np.testing.assert_array_equal(got, want)
        dropped += drop
    ranks = sum(res["layers"][case]["dropped"] for res in worlds[world])
    print(f"{case}: {dropped} hits dropped of {xt.shape[0] * cfg.top_k}")
    assert ranks == dropped
    if case != "pk4":
        assert dropped > 0


@pytest.mark.parametrize("world", [2, 4])
def test_no_garbage_row_reaches_the_output(inputs, monkeypatch, world):
    """The rows past the last offset (hits of other ranks' experts kept
    under the cap) hold NaN here; each rank's share is finite and the same
    bits as without them."""
    cfg = _case_cfg(2.0)
    x = torch.from_numpy(inputs["layer/x16"]).to(torch.bfloat16)
    xt = x.reshape(-1, cfg.d_model)
    clean = [moe._ep_partial(_rank_params(inputs, world, r), xt, cfg, r,
                             world) for r in range(world)]
    grouped = moe._grouped
    filled = []

    def poisoned(xs, w, offs):
        out = grouped(xs, w, offs)
        end = int(offs[-1])
        filled.append(out.shape[0] - end)
        out[end:] = float("nan")
        return out

    monkeypatch.setattr(moe, "_grouped", poisoned)
    for r in range(world):
        y, aux = moe._ep_partial(_rank_params(inputs, world, r), xt, cfg, r,
                                 world)
        assert torch.isfinite(y).all(), r
        assert torch.equal(y, clean[r][0]) and torch.equal(aux, clean[r][1])
    assert sum(filled) > 0


# ----------------------------------------------------------------- logits


@pytest.mark.parametrize("world", [2, 4])
def test_logits_match_the_reference(worlds, reference, world1, inputs,
                                    world):
    got = worlds[world][0]["logits"]
    vocab = get_reduced(ARCH).vocab_size
    ref = _max_err(got[..., :vocab], reference[f"logits/1x{world}"][
        ..., :vocab])
    one = _max_err(got[..., :vocab], world1["logits"][..., :vocab])
    print(f"world {world}: max |dlogit| {ref:.2e} vs the reference's "
          f"1x{world}, {one:.2e} vs the port's world 1")
    assert ref <= (LOGIT_TOL if world == 2 else POOLED_TOL)
    if world == 2:
        assert one <= WORLD1_TOL
        # every layer's prefill call (2 x 9 tokens) and decode call (2 x
        # 1) takes the body the reference's rule picks for its batch
        cfg = get_reduced(ARCH)
        layers = cfg.n_layers
        want = {}
        for s, calls in ((inputs["prompt"].shape[1], layers),
                         (1, layers * inputs["forced"].shape[0])):
            body = moe.ep_body(cfg, 2, s, 2)
            want[body] = want.get(body, 0) + calls
        assert worlds[2][0]["logit_bodies"] == want
    for rank in worlds[world][1:]:
        np.testing.assert_array_equal(rank["logits"], got)


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
        assert first[cell]["handovers"] == len(_requests())
    if cell == "squeezed":
        assert first[cell]["preemptions"] > 0
    if cell == "park":
        assert first[cell]["parks"] > 0


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_world2_quantized_pages(worlds, codec):
    fp16 = worlds[2][0]["own_fp16"]["outputs"]
    for res in worlds[2]:
        rec = res[f"own_{codec}"]
        assert rec["host_syncs"] == rec["chunks"]
        assert rec["outputs"] == worlds[2][0][f"own_{codec}"]["outputs"]
        assert [len(o) for o in rec["outputs"]] == [len(o) for o in fp16]
    first = [a[0] == b[0] for a, b in zip(
        worlds[2][0][f"own_{codec}"]["outputs"], fp16)]
    assert sum(first) >= 0.75 * len(first), first


def test_world4_paged_stream_against_the_reference(worlds, reference):
    ref = reference["stream/1x4"]
    first = worlds[4][0]
    rec = first["paged"]
    for res in worlds[4]:
        assert res["paged"]["host_syncs"] == res["paged"]["chunks"]
        assert res["paged"]["outputs"] == rec["outputs"]
    assert ref["host_syncs"] == ref["chunks"]
    dropped = sum(r["paged"]["dropped"] for r in worlds[4])
    one_shot = sum(r["one_shot_dropped"] for r in worlds[4])
    for i, (got, want, row) in enumerate(zip(rec["outputs"], ref["outputs"],
                                             ref["rows"])):
        own = first["one_shot"][i]
        if got != own[:len(got)]:
            t = next(j for j, (a, b) in enumerate(zip(got, own)) if a != b)
            print(f"request {i}: the stream parts from its one-shot at "
                  f"token {t} (hits dropped: {dropped} in the stream, "
                  f"{one_shot} in the one-shots)")
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
    print(f"world 4 paged stream: {dropped} hits dropped over the ranks")


# ------------------------------------------------------- weights, training


def test_init_serving_cuts_experts_before_the_cast(worlds):
    for res in worlds[2]:
        assert res["init_serving_bits"]
        assert res["own_experts"] == 4


def test_training_keeps_the_gather_at_use_moe(worlds, world1):
    for res in worlds[2]:
        assert res["train"]["ep_calls"] == 0
        assert res["train"]["expert_shard"] == 4
        assert abs(res["train"]["loss"] - world1["loss"]) <= LOSS_TOL


# ------------------------------------------------------------------- CLIs


def test_serve_cli_serves_qwen3_moe_on_two_ranks(children):
    rc, out, err = children("serve")
    assert rc == 0, err[-3000:]
    assert "mesh: 1x2 (data x model), kv pool sharded 2x" in out
    assert "completed 4/4" in out


@pytest.mark.parametrize("arch,mesh", [(ARCH, "3"),
                                       ("deepseek-v2-236b", "8"),
                                       ("jamba-1.5-large-398b", "2")])
def test_serve_cli_refuses(arch, mesh):
    with pytest.raises(NotImplementedError, match="A13c"):
        cli.run(["--device", "cpu", "--arch", arch, "--mesh", mesh,
                 "--stream", "2"])


def test_serve_bench_mesh_takes_qwen3_moe(children):
    rc, out, err = children("bench")
    assert rc == 0, err[-3000:]
    got = json.loads(out.split("ARTIFACT", 1)[1])
    assert got["arch"].startswith(ARCH)
    assert got["scaling_modeled"] >= 1.7
    for side in ("base", "mesh_run"):
        assert got[side]["host_syncs"] == got[side]["boundaries"]
