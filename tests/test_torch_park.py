"""The port's layer-2 host tier (park / resume) against the JAX package's,
on the CPU.

The ports of every case of ``tests/test_park_resume.py``, over its four
requests (two share a 16-token system prefix) on ``TINY`` with the
reference's weights through the numpy bridge (the fixtures of
``test_torch_serve_modes.py``):

  * fp16 park / resume emits the uninterrupted stream's tokens, exactly;
  * the blob holds the exact pool bytes the session was resident with, at
    fp16 and at int8 (codes and per-page scales), and the serializer's own
    round trip is lossless; an int8 session resumes with those codes and
    scales byte for byte in its new pages;
  * park / resume through preemption (an 8-page pool, chunks of 6), with a
    parked sharer (its shared pages stay resident for the other reader and
    are re-matched on resume), and under disaggregated roles: each equal
    to its uninterrupted stream, token for token;
  * a mid-prefill session and an unknown rid are refused, as is a
    recurrent model (falcon-mamba-7b); ``submit_parked`` validates;
  * a blob of a foreign format (another format number, the reference's
    msgpack blob, bytes that are no blob) raises ``ValueError``.

Against the reference's engine: the two-phase stream through preemption
gives the reference's ``parks``, ``park_resumes``, preemptions, spills,
restores, chunks and prefill chunks, and its tokens up to the reference's
measured near-ties (``TIE_TOL = 2e-2``, as in ``test_torch_serve_modes``).
The CLI serves ``--park-idle`` on ``--device cpu`` and refuses it without
``--paged``. A second ``serve()`` on a scheduler that still holds a request
preempted into layer 1 raises, naming it: every call builds a fresh spill
tier, and the request would be restored from zeros. The ``cuda``-marked case parks a stream on the card at fp16
(tokens == uninterrupted), int8 and fp8.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro.serve import park as j_park
from repro.serve import scheduler as j_sm
from repro_torch.configs import get_reduced
from repro_torch.kernels.paged_attention import as_bits
from repro_torch.launch import serve as cli
from repro_torch.models import build_model, transformer
from repro_torch.serve import park as park_mod
from repro_torch.serve import scheduler as sm
from repro_torch.serve.engine import Engine, EngineConfig

from test_torch_serve_modes import (CONFIGS, _assert_tokens_match,  # noqa: F401
                                    engines)

torch.set_num_threads(1)
MAX_LEN, PT = 64, 8
COUNTERS = ("parks", "park_resumes", "preemptions", "spilled_pages",
            "restores", "chunks", "decode_steps", "prefill_chunks",
            "prefix_hits", "handovers")


def _requests():
    """``tests/test_park_resume.py``'s requests."""
    rng = np.random.RandomState(7)
    system = np.tile(rng.randint(2, 128, size=4).astype(np.int32), 4)
    tails = [rng.randint(2, 128, size=n).astype(np.int32) for n in (7, 11)]
    rand = rng.randint(2, 128, size=13).astype(np.int32)
    long = rng.randint(2, 128, size=27).astype(np.int32)
    return [(np.concatenate([system, tails[0]]), 14),
            (np.concatenate([system, tails[1]]), 12),
            (rand, 10),
            (long, 12)]


REQS = _requests()


def _geometry(mod, cfg, n_pages=41, kv_quant=None):
    if kv_quant:
        geom = mod.derive_page_geometry(cfg, MAX_LEN, page_tokens=PT,
                                        max_slots=3, kv_quant=kv_quant)
        return dataclasses.replace(geom, n_pages=n_pages, n_spill_pages=65)
    pb = mod.kv_bytes_per_token(cfg) * PT
    return mod.PageGeometry(page_tokens=PT, n_pages=n_pages, n_spill_pages=65,
                            max_pages_per_slot=-(-MAX_LEN // PT),
                            page_bytes=pb)


def _park_all(eng, sch):
    """Park every decoding resident, requeue every mid-prefill one (the
    launcher's two-phase flow); return [(old rid, blob)]."""
    blobs = []
    for slot in sorted(sch.active):
        req = sch.active[slot]
        if req.status == sm.DECODING:
            blobs.append((req.rid, eng.park_request(sch, req.rid)))
        elif req.status == sm.PREFILLING:
            sch.requeue(slot)
    return blobs


def _run(eng, reqs, *, park_at=0, geom=None, **sch_kwargs):
    """``reqs`` on a fresh scheduler; with ``park_at``: serve ``park_at``
    decode steps, park / requeue the residents, resume the blobs into the
    same scheduler and serve to the end. Returns (outputs by submission
    order, report, number parked)."""
    sch = sm.Scheduler(3, pages=geom or _geometry(sm, eng.model.cfg),
                       **sch_kwargs)
    rids = [sch.submit(p, g).rid for p, g in reqs]
    rid_map = {r: r for r in rids}
    blobs = []
    if park_at:
        eng.serve(scheduler=sch, max_steps=park_at)
        blobs = _park_all(eng, sch)
        for old, blob in blobs:
            rid_map[old] = eng.resume_parked(sch, blob).rid
    rep = eng.serve(scheduler=sch)
    return [rep.outputs[rid_map[r]] for r in rids], rep, len(blobs)


def _leaves(eng, pool, req, slot):
    """What a park of ``req`` must hold: its pages' bytes (codes and
    scales) and its rows, keyed as the blob keys them."""
    pages = torch.as_tensor(req.pages).long()
    out = {}
    for gname, gkey, attn in transformer.cache_attn_kinds(
            eng.model.cfg):
        for name, arr in pool.state["caches"][gname][gkey].items():
            key = f"{gname}/{gkey}/{name}"
            if attn != "mamba":
                out["pages/" + key] = as_bits(arr)[:, pages].clone()
            else:
                out["rows/" + key] = arr[:, slot:slot + 1].clone()
    return out


def _bits(t: torch.Tensor) -> bytes:
    return as_bits(t).contiguous().reshape(-1).view(torch.uint8).numpy() \
        .tobytes()


def test_park_resume_outputs_bit_exact(engines):
    *_, teng, _ = engines("tiny-eq")
    outs_u, rep_u, _ = _run(teng, REQS)
    outs_p, rep_p, n_parked = _run(teng, REQS, park_at=4)
    assert n_parked > 0
    st = rep_p.stats
    assert st["parks"] == st["park_resumes"] == n_parked
    assert st["layer0_codec"] == "fp16" and rep_u.stats["parks"] == 0
    assert outs_p == outs_u
    assert all(len(o) > 0 for o in outs_p)


def test_mla_park_resume_outputs_bit_exact(engines):
    """The same on the equivalence matrix's ``TINY_MLA``: the blob carries
    the latent pages (``ckv`` / ``krope``) and the resumed sessions emit
    the uninterrupted tokens, bit for bit."""
    *_, teng, _ = engines("tiny-eq-mla")
    outs_u, _, _ = _run(teng, REQS)
    outs_p, rep_p, n_parked = _run(teng, REQS, park_at=4)
    assert n_parked > 0
    assert rep_p.stats["parks"] == rep_p.stats["park_resumes"] == n_parked
    assert outs_p == outs_u
    assert all(len(o) > 0 for o in outs_p)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp16", "int8"])
def test_park_blob_holds_exact_pool_bytes(engines, kv_quant):
    """A park is a byte copy of the session's pages and rows; the
    serializer round-trips them losslessly, and after the resume the
    session's new private pages hold exactly the parked bytes (int8 codes
    and scales included) before its first decode step writes."""
    *_, teng, _ = engines("tiny-eq")
    geom = _geometry(sm, teng.model.cfg, kv_quant=kv_quant)
    sch = sm.Scheduler(3, pages=geom)
    rids = [sch.submit(p, g).rid for p, g in REQS]
    teng.serve(scheduler=sch, max_steps=4)
    slot, req = next((s, r) for s, r in sorted(sch.active.items())
                     if r.status == sm.DECODING)
    expect = _leaves(teng, teng._last_pool, req, slot)
    prompt, tokens, n_pages = list(req.prompt), list(req.tokens), len(req.pages)
    blob = teng.park_request(sch, req.rid)
    blobs = [(req.rid, blob)] + _park_all(teng, sch)

    meta, arrays = park_mod.unpack_parked(blob)
    assert meta["prompt"] == [int(t) for t in prompt]
    assert meta["tokens"] == [int(t) for t in tokens] and meta["tokens"]
    assert meta["n_pages"] == n_pages
    assert set(arrays) == set(expect)
    for key, got in arrays.items():
        assert got.shape == expect[key].shape, key
        assert _bits(got) == _bits(expect[key]), key
    if kv_quant:
        assert arrays["pages/blocks/pos0/k"].dtype == torch.int8
        assert any(k.endswith("_scale") for k in arrays)
    meta2, arrays2 = park_mod.unpack_parked(park_mod.pack_parked(meta,
                                                                 arrays))
    assert meta2 == meta
    for key in arrays:
        assert arrays2[key].dtype == arrays[key].dtype
        assert _bits(arrays2[key]) == _bits(arrays[key])

    rid_map = {r: r for r in rids}
    for old, b in blobs:
        rid_map[old] = teng.resume_parked(sch, b).rid
    new_rid = rid_map[req.rid]
    resumed = {}
    real = teng._exec_resume

    def spy(pool, rs, g):
        pool = real(pool, rs, g)
        if rs.req.rid == new_rid:
            resumed.update(_leaves(teng, pool, rs.req, rs.slot))
        return pool

    teng._exec_resume = spy
    try:
        rep = teng.serve(scheduler=sch)
    finally:
        del teng._exec_resume
    assert all(len(rep.outputs[rid_map[r]]) > 0 for r in rids)
    assert set(resumed) == set(expect)
    for key, got in resumed.items():
        k = min(got.shape[1], expect[key].shape[1])
        assert _bits(got[:, :k]) == _bits(expect[key][:, :k]), key


def test_park_resume_through_preemption(engines):
    *_, teng, _ = engines("tiny-eq")
    geom = _geometry(sm, teng.model.cfg, n_pages=8)
    outs_u, _, _ = _run(teng, REQS, geom=geom, chunk_prefill_tokens=6)
    outs_p, rep_p, n_parked = _run(teng, REQS, park_at=14, geom=geom,
                                   chunk_prefill_tokens=6)
    assert n_parked > 0
    assert rep_p.stats["preemptions"] > 0, "tight pool never preempted"
    assert outs_p == outs_u


def test_park_one_sharer_keeps_shared_pages_resident(engines):
    *_, teng, _ = engines("tiny-eq")
    outs_u, _, _ = _run(teng, REQS, prefix_share=True)
    sch = sm.Scheduler(3, pages=_geometry(sm, teng.model.cfg),
                       prefix_share=True)
    rids = [sch.submit(p, g).rid for p, g in REQS]
    teng.serve(scheduler=sch, max_steps=4)
    sharer = next(r for r in sch.active.values()
                  if r.status == sm.DECODING and r.n_shared > 0)
    shared = list(sharer.pages[:sharer.n_shared])
    refs_before = [sch.page_pool._refs[p] for p in shared]
    assert shared and all(rc >= 2 for rc in refs_before)
    blobs = [(sharer.rid, teng.park_request(sch, sharer.rid))]
    for p, before in zip(shared, refs_before):
        assert p not in sch.page_pool._free_set, "shared page was freed"
        assert sch.page_pool._refs[p] == before - 1
    blobs += _park_all(teng, sch)
    assert sch.page_pool.in_use == 0
    assert all(p in sch.page_pool._free_set for p in shared)
    rid_map = {r: r for r in rids}
    for old, blob in blobs:
        rid_map[old] = teng.resume_parked(sch, blob).rid
    rep = teng.serve(scheduler=sch)
    assert rep.stats["parks"] == rep.stats["park_resumes"] == len(blobs)
    assert rep.stats["prefix_hits"] > 0
    assert [rep.outputs[rid_map[r]] for r in rids] == outs_u
    assert sch.page_pool.in_use == 0 and sch.page_pool.mapped == 0


def test_park_resume_disaggregated(engines):
    *_, teng, _ = engines("tiny-eq")
    outs_u, _, _ = _run(teng, REQS, chunk_prefill_tokens=6, disaggregate=True)
    outs_p, rep_p, n_parked = _run(teng, REQS, park_at=14,
                                   chunk_prefill_tokens=6, disaggregate=True)
    assert n_parked > 0
    assert rep_p.stats["parks"] == n_parked
    assert rep_p.stats["handovers"] > 0
    assert outs_p == outs_u
    assert not teng.pools.owner


def test_park_stream_counters_equal_the_reference(engines):
    """The two-phase stream through preemption, on both engines: equal
    scheduler counters, and the reference's tokens up to its near-ties."""
    jm, jp, jeng, teng, _ = engines("tiny-eq")
    reports = []
    for eng, mod in ((jeng, j_sm), (teng, sm)):
        sch = mod.Scheduler(3, pages=_geometry(mod, eng.model.cfg, 8),
                            chunk_prefill_tokens=6)
        rids = [sch.submit(p, g).rid for p, g in REQS]
        rid_map = {r: r for r in rids}
        with jax.transfer_guard_device_to_host("disallow"):
            eng.serve(scheduler=sch, max_steps=14)
        for slot in sorted(sch.active):
            req = sch.active[slot]
            if req.status == mod.DECODING:
                blob = eng.park_request(sch, req.rid)
                rid_map[req.rid] = eng.resume_parked(sch, blob).rid
            elif req.status == mod.PREFILLING:
                sch.requeue(slot)
        with jax.transfer_guard_device_to_host("disallow"):
            rep = eng.serve(scheduler=sch)
        reports.append(([rep.outputs[rid_map[r]] for r in rids], rep.stats))
    (want, want_st), (got, got_st) = reports
    assert got_st["parks"] > 0 and got_st["preemptions"] > 0
    for key in COUNTERS:
        assert got_st.get(key) == want_st.get(key), key
    for i, (prompt, _) in enumerate(REQS):
        _assert_tokens_match(jm, jp, prompt, want[i], got[i], i)


# -------------------------------------------------------------- refusals


def test_park_rejects_mid_prefill_and_unknown_rid(engines):
    *_, teng, _ = engines("tiny-eq")
    sch = sm.Scheduler(3, pages=_geometry(sm, teng.model.cfg),
                       chunk_prefill_tokens=6)
    rids = [sch.submit(p, g).rid for p, g in REQS]
    teng.serve(scheduler=sch, max_steps=1)
    _, req = next((s, r) for s, r in sorted(sch.active.items())
                  if r.status == sm.PREFILLING)
    with pytest.raises(ValueError, match="only decoding sessions park"):
        teng.park_request(sch, req.rid)
    with pytest.raises(KeyError, match="not active"):
        teng.park_request(sch, 10 ** 9)
    for s in sorted(sch.active):
        sch.requeue(s)
    rep = teng.serve(scheduler=sch)
    assert all(len(rep.outputs[r]) > 0 for r in rids)


def test_park_refuses_a_recurrent_model():
    fcfg = get_reduced("falcon-mamba-7b")
    model = build_model(fcfg, device="cpu")
    eng = Engine(model, model.init(torch.Generator().manual_seed(0)),
                 EngineConfig(max_len=32, sync_interval=4))
    sch = sm.Scheduler(2, pages=sm.derive_page_geometry(
        fcfg, 32, page_tokens=8, max_slots=2))
    sch.submit(np.arange(2, 8, dtype=np.int32), 12)
    eng.serve(scheduler=sch, max_steps=4)
    (slot, req), = sch.active.items()
    with pytest.raises(ValueError, match="attention-only"):
        eng.park_request(sch, req.rid)
    assert sch.active[slot] is req


def test_submit_parked_validates():
    cfg = get_reduced("qwen2.5-3b")
    with pytest.raises(ValueError, match="park/resume requires the paged"):
        sm.Scheduler(3).submit_parked([1, 2, 3], 4, [5])
    paged = sm.Scheduler(3, pages=_geometry(sm, cfg))
    with pytest.raises(ValueError, match="empty token list"):
        paged.submit_parked([1, 2, 3], 4, [])


def test_unpack_rejects_foreign_formats():
    blob = park_mod.pack_parked({"a": 1}, {"x": torch.zeros(3)})
    head = len(park_mod.MAGIC) + 4
    n = int.from_bytes(blob[len(park_mod.MAGIC):head], "little")
    other = blob[head:head + n].replace(b'"format": 1', b'"format": 99')
    bad = (park_mod.MAGIC + len(other).to_bytes(4, "little") + other
           + blob[head + n:])
    with pytest.raises(ValueError, match="blob format 99"):
        park_mod.unpack_parked(bad)
    reference_blob = j_park.pack_parked({"a": 1}, {"x": np.zeros(3)})
    for foreign in (reference_blob, b"", b"RTPAR"):
        with pytest.raises(ValueError, match="not a parked-session blob"):
            park_mod.unpack_parked(foreign)
    meta, arrays = park_mod.unpack_parked(blob)
    assert meta == {"a": 1} and arrays["x"].tolist() == [0.0, 0.0, 0.0]


# --------------------------------------------------------- the launcher


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp16", "int8"])
def test_launch_serve_park_idle_on_cpu(capsys, kv_quant):
    base = ["--stream", "4", "--paged", "--batch", "2", "--prompt-len", "8",
            "--gen-len", "12", "--sync-interval", "4", "--page-tokens", "8",
            "--device", "cpu"] + (["--kv-quant", kv_quant] if kv_quant else [])
    plain = cli.run(base)
    rec = cli.run(base + ["--park-idle", "4"])
    out = capsys.readouterr().out
    assert "host parking:" in out and "parked at step 4" in out
    assert rec["parks"] == rec["park_resumes"] > 0
    assert rec["host_syncs"] == rec["chunks"]
    if not kv_quant:
        assert rec["outputs"] == plain["outputs"]


def test_launch_serve_park_idle_needs_paged(capsys):
    with pytest.raises(SystemExit):
        cli.run(["--stream", "2", "--park-idle", "4", "--device", "cpu"])
    assert "--park-idle requires --paged" in capsys.readouterr().err


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_park_stream_on_the_card(kv_quant):
    """A stream parked at step 4 on the card: every request drains, parks
    equal resumes, and at fp16 the tokens are the uninterrupted stream's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_reduced("qwen2.5-3b"), head_dim=128)
    model = build_model(cfg, device="cuda")
    eng = Engine(model, model.init(torch.Generator("cuda").manual_seed(0)),
                 EngineConfig(max_len=48, sync_interval=4))
    reqs = [(r["prompt"], r["max_new_tokens"])
            for r in sm.synthetic_stream(6, 24, 12, cfg.vocab_size, seed=2)]
    geom = sm.derive_page_geometry(cfg, 48, page_tokens=8, max_slots=3,
                                   kv_quant=kv_quant)
    outs_u, _, _ = _run(eng, reqs, geom=geom)
    outs_p, rep, n_parked = _run(eng, reqs, park_at=4, geom=geom)
    assert n_parked > 0
    assert rep.stats["parks"] == rep.stats["park_resumes"] == n_parked
    assert all(len(o) > 0 for o in outs_p)
    if kv_quant is None:
        assert outs_p == outs_u


def test_a_second_serve_refuses_requests_stranded_in_layer_1():
    """Every serve() builds a fresh layer-1 spill tier. One that stops
    (``max_steps``) while a request is preempted into layer 1 strands it:
    the next serve() on that scheduler raises ``ValueError`` naming it,
    where it would restore the request's KV from zeros."""
    cfg = CONFIGS["tiny-eq"][0]
    model = build_model(cfg, device="cpu")
    eng = Engine(model, model.init(torch.Generator().manual_seed(0)),
                 EngineConfig(max_len=MAX_LEN, sync_interval=4))
    sch = sm.Scheduler(3, pages=_geometry(sm, cfg, 8),
                       chunk_prefill_tokens=6)
    for prompt, gen in REQS:
        sch.submit(prompt, gen)
    eng.serve(scheduler=sch, max_steps=25)
    stranded = [r.rid for r in sch.queue if r.status == sm.PREEMPTED]
    assert stranded and sch.preemptions >= 1
    with pytest.raises(ValueError, match=re.escape(
            f"requests {stranded} are still preempted into the layer-1")):
        eng.serve(scheduler=sch)
