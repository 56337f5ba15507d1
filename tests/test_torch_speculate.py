"""The port's speculative decoding against the JAX package's, on the CPU.

  * ``propose_ngram``: equal to the reference's on hand cases and on
    seeded contexts (random, motif-tiled, constant runs), every k.
  * ``fold_acceptance``: every field equal to the reference's on its hand
    cases and on seeded random cases (exact: integer and boolean math).
  * ``Model.verify_step``: logits within ``LOGIT_TOL = 1e-2`` of the
    reference's (the frameworks round bf16 at different places, as in
    ``test_torch_model.py``), over the dense slot slab and over the paged
    pool with both slots' verify chunks crossing a page boundary; the
    first layer's K rows it writes equal the reference's within 1e-2 too.
  * Inside the port, verify column j against the j-th of k+1 sequential
    ``decode_step`` calls: logits within ``STEP_TOL = 1e-4`` (the CPU's f32
    GEMM is not row-invariant: k+1 rows a slot against one), equal
    argmax, and the same K/V rows bit for bit after bf16 rounding.
  * Inside the port, the speculating engine emits the plain engine's
    tokens in {dense, paged, paged-share} x {whole, chunk 6} over the
    serve-modes matrix's requests and in a squeezed paged pool that
    preempts; every cell reads the device once per boundary
    (``host_syncs == chunks == decode_steps``). Tokens, not logits, and
    equal except where a request parts at a step whose teacher-forced
    top-2 margin (the port's own forward, computed here) is under
    ``TIE_TOL = 2e-2``.
  * Against the reference's engine on the same weights (k = 4): the
    tokens are equal by the same near-tie rule with the reference's
    margin, and the counters (chunks, decode steps, proposed / accepted /
    rejected drafts, prefill chunks, prefix hits, COW copies, preemptions,
    host syncs) are equal. A request that parts at a near-tie changes
    every draft after it, so then the counters are held on a second run
    of the requests that did not part.
  * falcon-mamba-7b refuses speculation in the engine and in
    ``Model.verify_step``, with the reference's exceptions.
  * The CLI serves ``--speculate-tokens 0`` (derived) and ``2`` on
    ``--device cpu`` on both pools and gives the reference's argument
    errors.
  * ``derive_speculate_tokens`` / ``derive_prefill_chunk`` equal the
    reference's under ``tpu-v5e`` for the four dense GQA archs; under
    ``h100`` (priced against L2) they give 8 and 128 for qwen2.5-3b.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core.target import get_target as j_get_target
from repro.models import build_model as j_build_model
from repro.models.config import ModelConfig as JModelConfig
from repro.serve import scheduler as j_sm
from repro.serve import speculate as j_sp
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.target import get_target
from repro_torch.launch import serve as cli
from repro_torch.models import build_model, layers, transformer
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.serve import scheduler as sm
from repro_torch.serve import speculate as sp
from repro_torch.serve.engine import Engine, EngineConfig

from test_torch_serve_modes import engines  # noqa: F401

torch.set_num_threads(1)
MAX_LEN, PT, K = 64, 8, 4
LOGIT_TOL = 1e-2
STEP_TOL = 1e-4
TIE_TOL = 2e-2
COUNTERS = ("chunks", "decode_steps", "spec_proposed", "spec_accepted",
            "spec_rejected", "prefill_chunks", "prefix_hits", "preemptions",
            "restores", "host_syncs")

_TINY = dict(name="tiny-spec", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)
TCFG, JCFG = ModelConfig(**_TINY), JModelConfig(**_TINY)


def _requests():
    """The serve-modes matrix's requests: two share a repetitive system
    prefix, one repeats it (a copy-on-write admission), one tiles a motif
    (high acceptance), one is random (rejections)."""
    rng = np.random.RandomState(11)
    system = np.tile(rng.randint(2, 128, size=4).astype(np.int32), 4)
    tails = [rng.randint(2, 128, size=n).astype(np.int32) for n in (7, 11)]
    motif = np.tile(rng.randint(2, 128, size=5).astype(np.int32), 5)[:22]
    rand = rng.randint(2, 128, size=13).astype(np.int32)
    return [(np.concatenate([system, tails[0]]), 14),
            (np.concatenate([system, tails[1]]), 12),
            (system, 6),
            (motif, 16),
            (rand, 10)]


REQS = _requests()


def _geometry(mod, cfg, n_layer0=40):
    pb = mod.kv_bytes_per_token(cfg) * PT
    return mod.PageGeometry(page_tokens=PT, n_pages=n_layer0 + 1,
                            n_spill_pages=65,
                            max_pages_per_slot=-(-MAX_LEN // PT),
                            page_bytes=pb)


def _scheduler(mod, cfg, mode, chunk, n_layer0=40):
    return mod.Scheduler(
        3, pages=None if mode == "dense" else _geometry(mod, cfg, n_layer0),
        prefix_share=(mode == "paged-share"), chunk_prefill_tokens=chunk)


@pytest.fixture(scope="module")
def tiny():
    """(reference model, its params, reference engine, port engine) over
    the same weights; each serve sets ``speculate_tokens`` itself."""
    jm = j_build_model(JCFG)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(TCFG, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ecfg = dict(max_len=MAX_LEN, sync_interval=4)
    return (jm, jp, JEngine(jm, jp, JEngineConfig(**ecfg)),
            Engine(tm, tp, EngineConfig(**ecfg)))


def _serve(eng, sch, reqs, spec):
    prev = eng.ecfg.speculate_tokens
    eng.ecfg.speculate_tokens = spec
    try:
        rids = [sch.submit(p, g).rid for p, g in reqs]
        with jax.transfer_guard_device_to_host("disallow"):
            rep = eng.serve(scheduler=sch)
    finally:
        eng.ecfg.speculate_tokens = prev
    return [rep.outputs[r] for r in rids], rep.stats


def _margin_ok(logits_fn, prompt, want, got, what):
    """Equal, or parted where the teacher-forced top-2 margin of
    ``logits_fn(prompt + want[:t])`` (last row, f64) is under TIE_TOL and
    ``got``'s token is within it."""
    t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if t is None:
        assert len(got) == len(want), what
        return
    row = logits_fn(np.concatenate([prompt, np.asarray(want[:t], np.int32)]))
    top2 = np.sort(row)[-2:]
    assert top2[1] - top2[0] < TIE_TOL, (what, t, top2)
    assert row[got[t]] >= top2[1] - TIE_TOL, (what, t)


def _port_logits(teng):
    def fn(seq):
        x, _, _ = transformer.forward(teng.model.cfg, teng.params,
                                      torch.as_tensor(seq[None]))
        row = layers.unembed_logits(teng.params["tok"], x[:, -1:])
        return row[0, 0, :teng.model.cfg.vocab_size].double().numpy()
    return fn


def _ref_logits(jm, jp):
    def fn(seq):
        logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(seq[None])},
                               seq.shape[0])
        return np.asarray(logits[0, -1, :jm.cfg.vocab_size], np.float64)
    return fn


# ------------------------------------------------------------- proposer


def _contexts():
    rng = np.random.RandomState(5)
    out = [np.asarray([5, 9, 3] + [7] * 20, np.int32),
           np.asarray([1, 2] + [8, 9, 4] * 6, np.int32),
           np.asarray([3, 4, 10, 11, 12, 3, 4, 20, 21, 22, 3, 4], np.int32),
           np.arange(2, 30, dtype=np.int32), np.asarray([5], np.int32),
           np.zeros((0,), np.int32)]
    for n in (2, 5, 17, 40, 90):
        out.append(rng.randint(2, 6, size=n).astype(np.int32))
        motif = rng.randint(2, 128, size=int(rng.randint(2, 9)))
        out.append(np.tile(motif, n)[:n + 3].astype(np.int32))
    return out


@pytest.mark.parametrize("k", [0, 1, 3, 8])
def test_propose_ngram_equals_the_reference(k):
    for ctx in _contexts():
        for g in (1, 3):
            got = sp.propose_ngram(ctx, k, max_ngram=g)
            want = j_sp.propose_ngram(ctx, k, max_ngram=g)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ fold


def _fold_both(targets, drafts, dlen, done, n_gen, budget, cache_len,
               max_len=MAX_LEN, eos=1):
    got = sp.fold_acceptance(
        torch.as_tensor(targets), torch.as_tensor(drafts),
        torch.as_tensor(dlen), done=torch.as_tensor(done),
        n_gen=torch.as_tensor(n_gen), budget=torch.as_tensor(budget),
        cache_len=torch.as_tensor(cache_len), max_len=max_len,
        eos_token=eos)
    want = j_sp.fold_acceptance(
        jnp.asarray(targets), jnp.asarray(drafts), jnp.asarray(dlen),
        done=jnp.asarray(done), n_gen=jnp.asarray(n_gen),
        budget=jnp.asarray(budget), cache_len=jnp.asarray(cache_len),
        max_len=max_len, eos_token=eos)
    for field in ("valid", "emitted", "tok", "done", "n_gen", "cache_len"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
        assert g.dtype == (torch.bool if w.dtype == bool else torch.int32), \
            field


def test_fold_hand_cases_equal_the_reference():
    """tests/test_speculate.py's hand cases: full accept, a rejection,
    a done slot, dlen = 0, EOS mid-chunk, a budget and the max_len wall."""
    targets = np.asarray([
        [10, 11, 12, 13, 14], [10, 99, 12, 13, 14], [10, 11, 12, 13, 14],
        [20, 21, 22, 23, 24], [10, 1, 12, 13, 14], [30, 31, 32, 33, 34],
        [40, 41, 42, 43, 44]], np.int32)
    drafts = np.asarray([
        [10, 11, 12, 13], [10, 11, 12, 13], [10, 11, 12, 13],
        [0, 0, 0, 0], [10, 1, 12, 13], [30, 31, 32, 33],
        [40, 41, 42, 43]], np.int32)
    dlen = np.asarray([4, 4, 4, 0, 4, 4, 4], np.int32)
    done = np.asarray([0, 0, 1, 0, 0, 0, 0], bool)
    n_gen = np.asarray([3, 3, 3, 1, 3, 3, 3], np.int32)
    budget = np.asarray([20, 20, 20, 20, 20, 5, 20], np.int32)
    cache_len = np.asarray([10, 10, 10, 10, 10, 10, MAX_LEN - 3], np.int32)
    _fold_both(targets, drafts, dlen, done, n_gen, budget, cache_len)


@pytest.mark.parametrize("seed", range(6))
def test_fold_random_cases_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    s, k = 16, int(rng.randint(1, 9))
    targets = rng.randint(1, 6, size=(s, k + 1)).astype(np.int32)
    drafts = np.where(rng.rand(s, k) < 0.7, targets[:, :k],
                      rng.randint(1, 6, size=(s, k))).astype(np.int32)
    _fold_both(targets, drafts,
               rng.randint(0, k + 1, size=s).astype(np.int32),
               rng.rand(s) < 0.2,
               rng.randint(0, 10, size=s).astype(np.int32),
               rng.randint(1, 14, size=s).astype(np.int32),
               rng.randint(0, MAX_LEN, size=s).astype(np.int32))


# --------------------------------------------------------- verify_step


PROMPTS = [np.random.RandomState(7).randint(2, 128, size=n).astype(np.int32)
           for n in (13, 6)]


def _dense_pools(jeng, teng):
    """Both engines' dense slabs with PROMPTS admitted at slots 0 and 1."""
    jpool, tpool = jeng.init_pool(2), teng.pools.init_pool(2)
    for slot, prompt in enumerate(PROMPTS):
        jpool, _ = jeng.admit_into_slot(jpool, slot, prompt, 20)
        tpool, _ = teng.prefill_role.admit_into_slot(tpool, slot, prompt, 20)
    return jpool, tpool


def _paged_pools(jeng, teng):
    """Both engines' paged pools with PROMPTS prefilled into fixed pages:
    slot 0's 13 tokens end 3 short of its second page, so a 5-token verify
    chunk crosses into the third; slot 1's end 2 short of its first."""
    rows = np.zeros((2, MAX_LEN // PT), np.int32)
    rows[0, :3], rows[1, :2] = [5, 2, 9], [7, 3]
    out = []
    for eng, mod in ((jeng, j_sm), (teng, sm)):
        sch = mod.Scheduler(2, pages=_geometry(mod, eng.model.cfg))
        pool, _ = (eng.init_paged_pool(sch) if eng is jeng
                   else eng.pools.init_paged_pool(sch))
        for slot, prompt in enumerate(PROMPTS):
            if eng is jeng:
                _, row = jeng.model.prefill(
                    jeng.params, {"tokens": jnp.asarray(prompt[None])},
                    MAX_LEN)
                state = jeng.model.slot_update_paged(
                    pool.state, row, jnp.asarray(slot),
                    jnp.asarray(rows[slot]), PT)
                pool = dataclasses.replace(pool, state=state)
            else:
                _, row = teng.model.prefill(
                    teng.params, {"tokens": torch.as_tensor(prompt[None])},
                    MAX_LEN)
                teng.model.slot_update_paged(
                    pool.state, row, slot, torch.as_tensor(rows[slot]), PT)
        out.append(pool)
    return out[0], out[1], rows


def _verify_tokens():
    return np.random.RandomState(8).randint(2, 128, size=(2, K + 1)
                                            ).astype(np.int32)


def _cache_rows(caches, getter):
    return np.concatenate([np.asarray(getter(c), np.float32).ravel()
                           for c in caches])


@pytest.mark.parametrize("pool_kind", ["dense", "paged"])
def test_verify_step_matches_the_reference(tiny, pool_kind):
    jm, jp, jeng, teng = tiny
    lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    tokens = _verify_tokens()
    if pool_kind == "dense":
        jpool, tpool = _dense_pools(jeng, teng)
        jbt = tbt = None
    else:
        jpool, tpool, rows = _paged_pools(jeng, teng)
        jbt, tbt = jnp.asarray(rows), torch.as_tensor(rows)
    jl, jstate = jm.verify_step(jeng.params, jnp.asarray(tokens), jpool.state,
                                jnp.asarray(lens), block_tables=jbt)
    tl, tstate = teng.model.verify_step(
        teng.params, torch.as_tensor(tokens), tpool.state,
        torch.as_tensor(lens), block_tables=tbt)
    v = TCFG.vocab_size
    assert tl.shape == (2, K + 1, TCFG.padded_vocab)
    np.testing.assert_allclose(tl[..., :v].numpy(),
                               np.asarray(jl[..., :v]), atol=LOGIT_TOL,
                               rtol=0)
    # the K/V both wrote: the first layer's keys of every slab row / page
    # (deeper layers' inputs already differ by the frameworks' bf16
    # rounding, by up to a few ulps)
    jk = np.asarray(jstate["caches"][next(iter(jstate["caches"]))]["pos0"]
                    ["k"][0], np.float32)
    tk = tstate["caches"][next(iter(tstate["caches"]))]["pos0"]["k"][0]
    np.testing.assert_allclose(tk.float().numpy(), jk, atol=LOGIT_TOL,
                               rtol=0)


@pytest.mark.parametrize("pool_kind", ["dense", "paged"])
def test_verify_column_j_is_the_jth_decode_step(tiny, pool_kind):
    """Inside the port: one verify forward against k+1 sequential decode
    steps fed the same tokens, from the same pool."""
    *_, teng = tiny
    lens = torch.as_tensor([len(p) for p in PROMPTS], dtype=torch.int32)
    tokens = torch.as_tensor(_verify_tokens())
    pools = []
    for _ in range(2):
        if pool_kind == "dense":
            pools.append(_dense_pools(*tiny[2:])[1])
            bt = None
        else:
            _, pool, rows = _paged_pools(*tiny[2:])
            pools.append(pool)
            bt = torch.as_tensor(rows)
    model, params = teng.model, teng.params
    logits, _ = model.verify_step(params, tokens, pools[0].state, lens,
                                  block_tables=bt)
    state = pools[1].state
    for j in range(K + 1):
        step, state = model.decode_step(params, tokens[:, j:j + 1], state,
                                        lens + j, block_tables=bt)
        np.testing.assert_allclose(logits[:, j].numpy(), step[:, 0].numpy(),
                                   atol=STEP_TOL, rtol=0)
        assert torch.equal(logits[:, j].argmax(-1), step[:, 0].argmax(-1))
    for a, b in zip(_leaves(pools[0].state), _leaves(state)):
        assert torch.equal(a, b)


def _leaves(tree):
    """The tensors of a nested dict, in key order."""
    if torch.is_tensor(tree):
        return [tree]
    return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]


# ------------------------------------------------------------ engine


CELLS = [(mode, chunk) for mode in ("dense", "paged", "paged-share")
         for chunk in (None, 6)]


@pytest.mark.parametrize("mode,chunk", CELLS,
                         ids=[f"{m}-{'chunk6' if c else 'whole'}"
                              for m, c in CELLS])
def test_spec_tokens_equal_plain_tokens(tiny, mode, chunk):
    *_, teng = tiny
    plain, _ = _serve(teng, _scheduler(sm, TCFG, mode, chunk), REQS, 0)
    spec, st = _serve(teng, _scheduler(sm, TCFG, mode, chunk), REQS, K)
    assert st["speculate_tokens"] == K and st["spec_proposed"] > 0
    assert st["host_syncs"] == st["chunks"] == st["decode_steps"]
    assert st["spec_rejected"] == st["spec_proposed"] - st["spec_accepted"]
    if mode == "paged-share":
        assert st["prefix_hits"] >= 2 and st["cow_copies"] >= 1
    for rid, ((prompt, _), want, got) in enumerate(zip(REQS, plain, spec)):
        assert len(got) > 0
        _margin_ok(_port_logits(teng), prompt, want, got, (mode, chunk, rid))


@pytest.mark.parametrize("mode,chunk", CELLS,
                         ids=[f"{m}-{'chunk6' if c else 'whole'}"
                              for m, c in CELLS])
def test_mla_spec_tokens_equal_plain_tokens(engines, mode, chunk):
    """The same cells on the equivalence matrix's ``TINY_MLA``: the verify
    forward runs MLA's latent-space decode at per-slot offsets, k + 1 rows
    a slot, over the slab or the latent pool."""
    *_, teng, _ = engines("tiny-eq-mla")
    cfg = teng.model.cfg
    plain, _ = _serve(teng, _scheduler(sm, cfg, mode, chunk), REQS, 0)
    spec, st = _serve(teng, _scheduler(sm, cfg, mode, chunk), REQS, K)
    assert st["speculate_tokens"] == K and st["spec_proposed"] > 0
    assert st["host_syncs"] == st["chunks"] == st["decode_steps"]
    for rid, ((prompt, _), want, got) in enumerate(zip(REQS, plain, spec)):
        assert len(got) > 0
        _margin_ok(_port_logits(teng), prompt, want, got, (mode, chunk, rid))


def test_spec_survives_preemption_and_spill(tiny):
    """A squeezed layer-0 pool preempts, spills and restores while
    speculating; the tokens are the roomy plain stream's."""
    *_, teng = tiny
    stream = [(s["prompt"], s["max_new_tokens"])
              for s in sm.repetitive_stream(6, 24, 20, 128, seed=7)]
    plain, _ = _serve(teng, _scheduler(sm, TCFG, "paged", None), stream, 0)
    spec, st = _serve(teng, _scheduler(sm, TCFG, "paged", None, n_layer0=12),
                      stream, K)
    assert st["preemptions"] >= 1 and st["restores"] >= 1
    assert st["host_syncs"] == st["chunks"]
    for rid, ((prompt, _), want, got) in enumerate(zip(stream, plain, spec)):
        _margin_ok(_port_logits(teng), prompt, want, got, ("squeezed", rid))


@pytest.mark.parametrize("mode,chunk", [("dense", None), ("paged", 6),
                                        ("paged-share", 6)],
                         ids=["dense-whole", "paged-chunk6",
                              "paged-share-chunk6"])
def test_spec_counters_and_tokens_equal_the_reference(tiny, mode, chunk):
    """Every counter equal, every token equal or parted at a measured
    near-tie. A request that parts changes the drafts that follow it, so
    the draft counters are then held on a second run of the requests that
    did not part, where tokens and every counter must be equal."""
    jm, jp, jeng, teng = tiny
    reqs = REQS
    for attempt in range(2):
        want, jst = _serve(jeng, _scheduler(j_sm, JCFG, mode, chunk), reqs,
                           K)
        got, tst = _serve(teng, _scheduler(sm, TCFG, mode, chunk), reqs, K)
        for rid, ((prompt, _), w, g) in enumerate(zip(reqs, want, got)):
            _margin_ok(_ref_logits(jm, jp), prompt, w, g, (mode, chunk, rid))
        parted = [rid for rid, (w, g) in enumerate(zip(want, got)) if w != g]
        if not parted:
            break
        assert attempt == 0, (mode, chunk, parted)
        reqs = [r for rid, r in enumerate(reqs) if rid not in parted]
    for key in COUNTERS + ("speculate_tokens", "cow_copies"):
        assert tst.get(key) == jst.get(key), key
    assert tst["spec_proposed"] > 0
    assert tst["spec_acceptance_rate"] == pytest.approx(
        jst["spec_acceptance_rate"])


def test_falcon_refuses_speculation_as_the_reference_does():
    jm = j_build_model(j_get_reduced("falcon-mamba-7b"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_reduced("falcon-mamba-7b"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with pytest.raises(ValueError, match="roll back"):
        JEngine(jm, jp, JEngineConfig(max_len=32, speculate_tokens=4))
    with pytest.raises(ValueError, match="roll back"):
        Engine(tm, tp, EngineConfig(max_len=32, speculate_tokens=4))
    jeng = JEngine(jm, jp, JEngineConfig(max_len=32))
    teng = Engine(tm, tp, EngineConfig(max_len=32))
    jpool, tpool = jeng.init_pool(2), teng.pools.init_pool(2)
    with pytest.raises(ValueError, match="attention-only"):
        jm.verify_step(jp, jnp.zeros((2, 3), jnp.int32), jpool.state,
                       jpool.cache_len)
    with pytest.raises(ValueError, match="attention-only"):
        tm.verify_step(teng.params, torch.zeros((2, 3), dtype=torch.int32),
                       tpool.state, tpool.cache_len)


# -------------------------------------------------------- the launcher


@pytest.mark.parametrize("flags", [
    ["--paged", "--speculate-tokens", "0"],
    ["--speculate-tokens", "2"],
    ["--paged", "--speculate-tokens", "2", "--chunk-prefill-tokens", "4"],
], ids=["paged-derived", "dense-2", "paged-chunk-2"])
def test_launch_serve_speculates_on_cpu(capsys, flags):
    rec = cli.run(["--stream", "4", "--batch", "2", "--prompt-len", "16",
                   "--gen-len", "24", "--sync-interval", "4",
                   "--page-tokens", "8", "--device", "cpu"] + flags)
    out = capsys.readouterr().out
    k = int(flags[flags.index("--speculate-tokens") + 1]) or 8
    if "0" in flags:
        assert "derived --speculate-tokens 8 (target tpu-v5e)" in out
    assert "completed 4/4" in out and f"speculative decoding: k={k}," in out
    assert rec["speculate_tokens"] == k and rec["spec_proposed"] > 0
    assert rec["host_syncs"] == rec["chunks"] == rec["decode_steps_total"]
    # without --prefix-share a speculating stream is the repetitive one
    want = sm.repetitive_stream(4, 16, 24,
                                get_reduced("qwen2.5-3b").vocab_size)
    assert rec["n_requests"] == 4
    assert all(0 < len(rec["outputs"][i]) <= want[i]["max_new_tokens"]
               for i in range(4))


def test_launch_serve_speculation_argument_errors(capsys):
    for flags in (["--speculate-tokens", "2"],
                  ["--stream", "2", "--disaggregate"]):
        with pytest.raises(SystemExit):
            cli.run(flags + ["--prompt-len", "8", "--device", "cpu"])
    capsys.readouterr()


# --------------------------------------------------------- the budgets


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "yi-6b", "mistral-nemo-12b",
                                  "gemma3-27b"])
def test_derived_budgets_under_tpu_v5e_equal_the_reference(arch):
    tgt, jtgt = get_target("tpu-v5e"), j_get_target("tpu-v5e")
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert sm.derive_speculate_tokens(cfg, target=tgt) == \
        j_sm.derive_speculate_tokens(jcfg, target=jtgt)
    assert sm.derive_prefill_chunk(cfg, target=tgt) == \
        j_sm.derive_prefill_chunk(jcfg, target=jtgt)


def test_derived_budgets_under_h100_price_against_l2():
    h100 = get_target("h100")
    assert h100.stream_level == "l2" and h100.scratchpad_level == "smem"
    assert get_target("tpu-v5e").stream_level is None
    cfg = get_config("qwen2.5-3b")
    assert sm.derive_speculate_tokens(cfg, target=h100) == 8
    assert sm.derive_prefill_chunk(cfg, target=h100) == 128
