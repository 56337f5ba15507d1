"""The port's disaggregated prefill/decode roles against the JAX package's,
on the CPU.

  * ``PoolManager.transfer_ownership`` flips one owner entry and counts
    the handover and its pages, refuses a slot its ``src`` role does not
    own (never claimed, already handed over) and a released slot, with the
    reference's ``RuntimeError``; ``release`` is idempotent.
  * A scheduler without pages and a late ``enable_disaggregation`` are
    refused, and an engine with ``disaggregate=True`` refuses the dense
    slot slab, as the reference's do; ``EngineConfig(disaggregate=True)``
    turns a plain paged scheduler's routing on.
  * Disaggregated == combined inside the port, token for token and in
    every scheduler counter, in the reference matrix's three
    disaggregation cells (``tests/test_equivalence_matrix.py``
    ``DISAGG_CELLS``), all chunked by 6: ``share-cow`` (prefix sharing, 40
    layer-0 pages, a page-aligned duplicate prompt forces a copy-on-write
    admission), ``preempt`` (7 layer-0 pages: mid-prefill preemption and
    restore fire) and ``speculate`` (k = 4). Exact: the role split changes
    only issue order and the decode role's view of rows it does not own.
    Each cell holds the per-role sync rule (decode-role syncs == chunks,
    0 < prefill-role syncs <= chunks, their sum == host syncs) and leaves
    the ownership map empty.
  * Against the reference's engine on the same weights (``TINY``): equal
    ``host_syncs_by_role``, ``handovers``, ``handover_pages``,
    ``decode_tokens`` and scheduler counters, and equal tokens up to the
    reference's measured near-ties (``TIE_TOL = 2e-2``, as in
    ``test_torch_serve_modes.py``).
  * ``EngineConfig(phase_timing=True)`` charges every phase and both
    roles a wall time and moves no token.
  * The CLI serves ``--disaggregate`` on ``--device cpu``.
  * ``cuda``-marked: the chunked stream on the card, disaggregated and
    combined, bit for bit in tokens and counters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as j_build_model
from repro.models.config import ModelConfig as JModelConfig
from repro.serve import scheduler as j_sm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as cli
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.serve import scheduler as sm
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.pool import DECODE_ROLE, PREFILL_ROLE, PoolManager

from test_torch_serve_modes import engines  # noqa: F401

torch.set_num_threads(1)
MAX_LEN, PT = 64, 8
TIE_TOL = 2e-2
COUNTERS = ("chunks", "decode_steps", "prefill_chunks", "prefix_hits",
            "shared_prefix_tokens", "cow_copies", "preemptions", "restores",
            "handovers", "handover_pages", "decode_tokens", "host_syncs",
            "spec_proposed", "spec_accepted")

_TINY = dict(name="tiny-disagg", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)
TCFG, JCFG = ModelConfig(**_TINY), JModelConfig(**_TINY)

#: tests/test_equivalence_matrix.py's DISAGG_CELLS: (name, prefix_share,
#: layer-0 data pages, speculate_tokens), every cell chunked by 6
DISAGG_CELLS = (("share-cow", True, 40, 0),
                ("preempt", False, 7, 0),
                ("speculate", False, 40, 4))


def _requests():
    """The equivalence matrix's four requests, then a page-aligned prompt
    twice (the duplicate's match ends mid-page: a copy-on-write admission)
    and a long one."""
    rng = np.random.RandomState(11)
    system = np.tile(rng.randint(2, 128, size=4).astype(np.int32), 4)
    tails = [rng.randint(2, 128, size=n).astype(np.int32) for n in (7, 11)]
    motif = np.tile(rng.randint(2, 128, size=5).astype(np.int32), 5)[:22]
    rand = rng.randint(2, 128, size=13).astype(np.int32)
    rng = np.random.RandomState(23)
    aligned = rng.randint(2, 128, size=3 * PT).astype(np.int32)
    long = rng.randint(2, 128, size=44).astype(np.int32)
    return [(np.concatenate([system, tails[0]]), 14),
            (np.concatenate([system, tails[1]]), 12),
            (motif, 16), (rand, 10),
            (aligned, 8), (aligned.copy(), 6), (long, 12)]


REQS = _requests()


def _geometry(mod, cfg, n_layer0=40):
    pb = mod.kv_bytes_per_token(cfg) * PT
    return mod.PageGeometry(page_tokens=PT, n_pages=n_layer0 + 1,
                            n_spill_pages=65,
                            max_pages_per_slot=-(-MAX_LEN // PT),
                            page_bytes=pb)


@pytest.fixture(scope="module")
def tiny():
    jm = j_build_model(JCFG)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(TCFG, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ecfg = dict(max_len=MAX_LEN, sync_interval=4)
    return (jm, jp, JEngine(jm, jp, JEngineConfig(**ecfg)),
            Engine(tm, tp, EngineConfig(**ecfg)))


def _serve(eng, mod, cfg, cell, disagg):
    _, share, n_layer0, spec = cell
    sch = mod.Scheduler(3, pages=_geometry(mod, cfg, n_layer0),
                        prefix_share=share, chunk_prefill_tokens=6,
                        disaggregate=disagg)
    prev = eng.ecfg.speculate_tokens
    eng.ecfg.speculate_tokens = spec
    try:
        rids = [sch.submit(p, g).rid for p, g in REQS]
        with jax.transfer_guard_device_to_host("disallow"):
            rep = eng.serve(scheduler=sch)
    finally:
        eng.ecfg.speculate_tokens = prev
    return [rep.outputs[r] for r in rids], rep.stats


# ------------------------------------------------- the handover primitive


def test_transfer_ownership_flips_one_entry():
    pools = PoolManager(None, None)
    pools.claim(3, PREFILL_ROLE)
    pools.transfer_ownership(3, [5, 9, 12])
    assert pools.owner == {3: DECODE_ROLE}
    assert (pools.handovers, pools.handover_pages) == (1, 3)
    pools.release(3)
    assert pools.owner == {}
    pools.release(3)                       # idempotent


def test_transfer_ownership_guards_src():
    pools = PoolManager(None, None)
    with pytest.raises(RuntimeError, match="owned by None"):
        pools.transfer_ownership(0, [1])
    pools.claim(0, PREFILL_ROLE)
    pools.transfer_ownership(0, [1])
    with pytest.raises(RuntimeError, match="owned by 'decode'"):
        pools.transfer_ownership(0, [1])   # a second handover
    assert (pools.handovers, pools.handover_pages) == (1, 1)


def test_released_slot_cannot_hand_over():
    pools = PoolManager(None, None)
    pools.claim(2, PREFILL_ROLE)
    pools.release(2)
    with pytest.raises(RuntimeError, match="owned by None"):
        pools.transfer_ownership(2, [4])


def test_a_spill_frees_the_owner_entry(tiny):
    """A preempted slot loses its owner with its pages, as the
    reference's ``exec_spill`` drops it."""
    *_, teng = tiny
    sch = sm.Scheduler(2, pages=_geometry(sm, TCFG))
    pool, spill = teng.pools.init_paged_pool(sch)
    teng.pools.claim(1, DECODE_ROLE)
    act = sm.SpillAction(slot=1, req=None, src_pages=[2], dst_pages=[3],
                         seat=1)
    teng.pools.exec_spill(pool, spill, act, sch.pages.max_pages_per_slot)
    assert 1 not in teng.pools.owner


# ------------------------------------------------- construction-time gates


@pytest.mark.parametrize("mod", [j_sm, sm], ids=["reference", "port"])
def test_disaggregate_requires_pages_and_an_early_switch(mod):
    with pytest.raises(ValueError, match="paged pool"):
        mod.Scheduler(2, disaggregate=True)
    with pytest.raises(ValueError, match="paged pool"):
        mod.Scheduler(2).enable_disaggregation()
    cfg = JCFG if mod is j_sm else TCFG
    sch = mod.Scheduler(2, pages=_geometry(mod, cfg), chunk_prefill_tokens=6)
    sch.submit(np.arange(2, 10, dtype=np.int32), 4)
    sch.plan_boundary(chunk_tokens=4, max_len=MAX_LEN)
    with pytest.raises(RuntimeError, match="precede the first admission"):
        sch.enable_disaggregation()


def test_engine_refuses_disaggregation_on_the_dense_slab(tiny):
    jm, jp, _, teng = tiny
    engines = ((JEngine(jm, jp, JEngineConfig(max_len=MAX_LEN,
                                              disaggregate=True)), j_sm),
               (Engine(teng.model, teng.params,
                       EngineConfig(max_len=MAX_LEN, disaggregate=True)),
                sm))
    for eng, mod in engines:
        sch = mod.Scheduler(2)
        sch.submit(np.arange(2, 10, dtype=np.int32), 4)
        with pytest.raises(ValueError, match="paged pool"):
            eng.serve(scheduler=sch)


def test_engine_config_flag_turns_routing_on(tiny):
    *_, teng = tiny
    teng.ecfg.disaggregate = True
    try:
        sch = sm.Scheduler(3, pages=_geometry(sm, TCFG),
                           chunk_prefill_tokens=8)
        sch.submit(np.arange(2, 20, dtype=np.int32), 4)
        rep = teng.serve(scheduler=sch)
    finally:
        teng.ecfg.disaggregate = False
    assert sch.disaggregate is True
    assert rep.stats["handovers"] == 1
    assert rep.stats["host_syncs_by_role"][DECODE_ROLE] == rep.stats["chunks"]


# ------------------------------------------------------------ the cells


@pytest.mark.parametrize("cell", DISAGG_CELLS, ids=[c[0] for c in DISAGG_CELLS])
def test_disaggregated_equals_combined(tiny, cell):
    *_, teng = tiny
    outs, st = _serve(teng, sm, TCFG, cell, True)
    base, bst = _serve(teng, sm, TCFG, cell, False)
    assert outs == base, cell[0]
    assert all(len(o) > 0 for o in outs)
    for key in ("chunks", "decode_steps", "prefill_chunks", "prefix_hits",
                "cow_copies", "preemptions", "restores", "spec_proposed",
                "spec_accepted"):
        assert st.get(key) == bst.get(key), key
    assert st["handovers"] == len(REQS) and st["handover_pages"] > 0
    assert bst["handovers"] == 0 and "host_syncs_by_role" not in bst
    by_role = st["host_syncs_by_role"]
    assert by_role[DECODE_ROLE] == st["chunks"]
    assert 0 < by_role[PREFILL_ROLE] <= st["chunks"]
    assert st["host_syncs"] == by_role[DECODE_ROLE] + by_role[PREFILL_ROLE]
    assert st["decode_tokens"] == sum(len(o) for o in outs) - len(REQS)
    assert len(st["boundary_decode_wall_s"]) == st["chunks"]
    assert teng.pools.owner == {}
    _, share, n_layer0, spec = cell
    if share:
        assert st["cow_copies"] > 0 and st["prefix_hits"] > 0
    if n_layer0 < 40:
        assert st["preemptions"] > 0 and st["restores"] > 0
    if spec:
        assert st["spec_proposed"] > 0
        assert st["decode_steps"] == st["chunks"]


@pytest.mark.parametrize("cell", DISAGG_CELLS, ids=[c[0] for c in DISAGG_CELLS])
def test_mla_disaggregated_equals_combined(engines, cell):
    """The same cells on the equivalence matrix's ``TINY_MLA``: the latent
    pages hand over as the GQA pages do, and the tokens and counters are
    the combined engine's, bit for bit."""
    *_, teng, _ = engines("tiny-eq-mla")
    cfg = teng.model.cfg
    outs, st = _serve(teng, sm, cfg, cell, True)
    base, bst = _serve(teng, sm, cfg, cell, False)
    assert outs == base, cell[0]
    assert all(len(o) > 0 for o in outs)
    for key in ("chunks", "decode_steps", "prefill_chunks", "prefix_hits",
                "cow_copies", "preemptions", "restores", "spec_proposed",
                "spec_accepted"):
        assert st.get(key) == bst.get(key), key
    assert st["handovers"] == len(REQS) and st["handover_pages"] > 0
    _, share, n_layer0, _ = cell
    if share:
        assert st["cow_copies"] > 0 and st["prefix_hits"] > 0
    if n_layer0 < 40:
        assert st["preemptions"] > 0 and st["restores"] > 0


def test_phase_timing_charges_phases_and_roles(tiny):
    """``phase_timing`` charges each phase's wall time and, disaggregated,
    each role's, and moves no token."""
    *_, teng = tiny
    cell = DISAGG_CELLS[0]
    base, _ = _serve(teng, sm, TCFG, cell, True)
    teng.ecfg.phase_timing = True
    try:
        outs, st = _serve(teng, sm, TCFG, cell, True)
    finally:
        teng.ecfg.phase_timing = False
    assert outs == base
    assert set(st["phase_s"]) == {"prefill", "generate", "drain",
                                  "handover"}
    assert set(st["role_s"]) == {PREFILL_ROLE, DECODE_ROLE}
    assert all(t > 0 for t in st["phase_s"].values())


def _assert_tokens_match(jm, jp, prompt, want, got, what):
    t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if t is None:
        assert len(got) == len(want), what
        return
    seq = np.concatenate([prompt, np.asarray(want[:t], np.int32)])[None]
    logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(seq)}, seq.shape[1])
    row = np.asarray(logits[0, -1, :jm.cfg.vocab_size], np.float64)
    top2 = np.sort(row)[-2:]
    assert top2[1] - top2[0] < TIE_TOL, (what, t, top2)
    assert row[got[t]] >= top2[1] - TIE_TOL, (what, t)


@pytest.mark.parametrize("cell", DISAGG_CELLS[:2],
                         ids=[c[0] for c in DISAGG_CELLS[:2]])
def test_disaggregated_counters_equal_the_reference(tiny, cell):
    jm, jp, jeng, teng = tiny
    want, jst = _serve(jeng, j_sm, JCFG, cell, True)
    got, tst = _serve(teng, sm, TCFG, cell, True)
    for key in COUNTERS:
        assert tst.get(key) == jst.get(key), key
    assert tst["host_syncs_by_role"] == jst["host_syncs_by_role"]
    for rid, ((prompt, _), w, g) in enumerate(zip(REQS, want, got)):
        _assert_tokens_match(jm, jp, prompt, w, g, (cell[0], rid))


def test_launch_serve_disaggregates_on_cpu(capsys):
    rec = cli.run(["--stream", "4", "--paged", "--disaggregate",
                   "--chunk-prefill-tokens", "4", "--batch", "2",
                   "--prompt-len", "8", "--gen-len", "6", "--sync-interval",
                   "4", "--page-tokens", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mode=paged+disagg" in out and "completed 4/4" in out
    assert "disaggregated roles: 4 handovers" in out
    assert rec["disaggregate"] and rec["handovers"] == 4
    assert rec["host_syncs_by_role"]["decode"] == rec["chunks"]
    assert rec["host_syncs"] == sum(rec["host_syncs_by_role"].values())


# --------------------------------------------------------- on the card


@pytest.mark.cuda
def test_disaggregated_equals_combined_on_the_card():
    """The chunked paged stream on the card, with and without the role
    split: the same tokens and counters, bit for bit (the owned rows see
    the same tables and the same kernels; the paged kernel's rows are
    independent of the other rows of the table)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.target import use_target
    # the smoke config at the kernels' head_dim (both take D = 128)
    cfg = dataclasses.replace(get_reduced("qwen2.5-3b"), head_dim=128)
    reqs = sm.synthetic_stream(6, 40, 12, cfg.vocab_size, seed=3)
    with use_target("h100"):
        model = build_model(cfg)
        eng = Engine(model, model.init(torch.Generator(device="cuda")
                                       .manual_seed(0)),
                     EngineConfig(max_len=52, sync_interval=4))
        runs = {}
        for disagg in (False, True):
            pages = sm.derive_page_geometry(cfg, 52, page_tokens=16,
                                            max_slots=3)
            sch = sm.Scheduler(3, pages=pages, chunk_prefill_tokens=16,
                               disaggregate=disagg)
            for r in reqs:
                sch.submit(r["prompt"], r["max_new_tokens"])
            rep = eng.serve(scheduler=sch)
            runs[disagg] = rep
    a, b = runs[False], runs[True]
    assert a.outputs == b.outputs
    for key in ("chunks", "decode_steps", "prefill_chunks"):
        assert a.stats[key] == b.stats[key], key
    assert b.stats["handovers"] == len(reqs)
    assert b.stats["host_syncs_by_role"][DECODE_ROLE] == b.stats["chunks"]
