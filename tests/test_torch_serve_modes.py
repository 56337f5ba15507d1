"""The port's serving modes — dense slot slab, prefix sharing with
copy-on-write, chunked prefill — against the port's own one-shot decode and
against the JAX package's engine, on the CPU.

The matrix is the reference's equivalence matrix
(``tests/test_equivalence_matrix.py``) restricted to what the port serves:
{dense, paged, paged-share} x {whole prompt, chunks of 6} over its
``TINY``, ``TINY_WINDOW`` and ``TINY_MLA`` configs (the last caches only
MLA's latent: the slab and the pool hold ``ckv`` / ``krope`` rows, decode
runs in latent space, prefill and chunks decompress for attention) and its
four requests, speculation
off, plus a fifth request that repeats the two shared prompts' 16-token
system prefix. That prompt is page-aligned and wholly covered by the
prefix index, so its match is capped one token short and its frontier page
is copied on write (``cow_copies >= 1`` in every paged-share cell, whole
or chunked). Every cell must

  * read the device once per drain boundary (``host_syncs == chunks``);
  * emit a prefix of the port's own one-shot ``Engine.generate`` rollout,
    token for token (the matrix's rule inside one package). Tokens, not
    logits: the CPU's f32 GEMM is not row-invariant at M = 1, so a
    one-token chunk's logits may differ from the whole prompt's in the last
    bit; the greedy tokens may not.

The ``TINY`` cells are also served by the reference's engine with the same
weights (its ``Model.init`` through the numpy bridge): the scheduler's
counters must be equal (chunks, prefill chunks, prefix hits, shared
prefix tokens, COW copies, preemptions), and so must the tokens, except where a request parts at a step where the
reference's own teacher-forced top-2 margin is under ``TIE_TOL = 2e-2``
(the frameworks round bf16 at different places; see
``test_torch_serve.py``). The margin is computed, never assumed.

falcon-mamba-7b's smoke config serves the dense stream with the
reference's counters and tokens (same rule); it and jamba-1.5-large-398b's
refuse prefix sharing, chunked prefill, speculation and quantized pages as
the reference does, and host parking, which the reference does not refuse
(``test_falcon_refuses_what_the_reference_refuses``). jamba's streams are
``test_torch_hybrid.py``'s. The CLI serves
every new mode on ``--device cpu``. The page-id guard raises on a bad id
before anything reaches the device. The ``cuda``-marked cases serve a dense
and a prefix-shared stream on the card and hold their greedy tokens within
0.05 of a teacher-forced pass (``chip_smoke.py``'s ``LOGIT_TOL``), as the
CPU's stream tokens are.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import build_model as j_build_model
from repro.models.config import ModelConfig as JModelConfig
from repro.serve import scheduler as j_sm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as cli
from repro_torch.models import build_model, layers, transformer
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.serve import scheduler as sm
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.pool import check_page_ids

torch.set_num_threads(1)
MAX_LEN, PT = 64, 8
TIE_TOL = 2e-2
LOGIT_TOL = 0.05
COUNTERS = ("chunks", "decode_steps", "prefill_chunks", "prefix_hits",
            "shared_prefix_tokens", "cow_copies", "preemptions",
            "host_syncs")

# tests/test_equivalence_matrix.py's configs and requests, plus a repeat
# of the system prefix that forces a copy-on-write admission
_TINY = dict(name="tiny-eq", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)
_WINDOW = dict(name="tiny-eq-win", n_layers=3, window=8,
               local_global_ratio=2)
_MLA = dict(name="tiny-eq-mla", n_kv_heads=4, use_mla=True, kv_lora_rank=16,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
CONFIGS = {
    "tiny-eq": (ModelConfig(**_TINY), JModelConfig(**_TINY)),
    "tiny-eq-win": (ModelConfig(**{**_TINY, **_WINDOW}),
                    JModelConfig(**{**_TINY, **_WINDOW})),
    "tiny-eq-mla": (ModelConfig(**{**_TINY, **_MLA}),
                    JModelConfig(**{**_TINY, **_MLA})),
}


def _requests():
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


def _geometry(sched_mod, cfg):
    pb = sched_mod.kv_bytes_per_token(cfg) * PT
    return sched_mod.PageGeometry(page_tokens=PT, n_pages=41,
                                  n_spill_pages=65,
                                  max_pages_per_slot=-(-MAX_LEN // PT),
                                  page_bytes=pb)


def _scheduler(sched_mod, cfg, mode, chunk):
    return sched_mod.Scheduler(
        3, pages=None if mode == "dense" else _geometry(sched_mod, cfg),
        prefix_share=(mode == "paged-share"), chunk_prefill_tokens=chunk)


@pytest.fixture(scope="module")
def engines():
    """Per config: (reference model, its params, reference engine, port
    engine, the port's one-shot rollouts of REQS)."""
    cache = {}

    def get(name):
        if name not in cache:
            tcfg, jcfg = CONFIGS[name]
            jm = j_build_model(jcfg)
            jp = jm.init(jax.random.PRNGKey(0))
            tm = build_model(tcfg, device="cpu")
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
            ecfg = dict(max_len=MAX_LEN, sync_interval=4)
            teng = Engine(tm, tp, EngineConfig(**ecfg))
            refs = []
            for prompt, gen in REQS:
                toks, _ = teng.generate(
                    {"tokens": torch.as_tensor(prompt[None])}, n_steps=gen)
                refs.append(toks[0].tolist())
            cache[name] = (jm, jp, JEngine(jm, jp, JEngineConfig(**ecfg)),
                           teng, refs)
        return cache[name]

    return get


def _assert_tokens_match(jm, jp, prompt, want, got, what):
    """Equal, or parted where the reference's own teacher-forced top-2
    margin is a near-tie (and the port's token is within it)."""
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


@pytest.mark.parametrize("chunk", [None, 6], ids=["whole", "chunk6"])
@pytest.mark.parametrize("mode", ["dense", "paged", "paged-share"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_matrix_cell(engines, name, mode, chunk):
    jm, jp, jeng, teng, refs = engines(name)
    cfg = teng.model.cfg
    sch = _scheduler(sm, cfg, mode, chunk)
    rids = [sch.submit(p, g).rid for p, g in REQS]
    rep = teng.serve(scheduler=sch)
    assert rep.stats["host_syncs"] == rep.stats["chunks"]
    if mode == "paged-share":
        assert rep.stats["prefix_hits"] >= 2
        assert rep.stats["cow_copies"] >= 1
    if chunk:
        assert rep.stats["prefill_chunks"] > len(REQS)
        assert rep.stats["max_boundary_prefill_tokens"] <= chunk
    for rid, ref in zip(rids, refs):
        got = rep.outputs[rid]
        assert len(got) > 0
        assert got == ref[:len(got)], (name, mode, chunk, rid)
    if name != "tiny-eq":
        return
    j_sch = _scheduler(j_sm, jm.cfg, mode, chunk)
    for p, g in REQS:
        j_sch.submit(p, g)
    with jax.transfer_guard_device_to_host("disallow"):
        want = jeng.serve(scheduler=j_sch)
    for key in COUNTERS:
        assert rep.stats.get(key) == want.stats.get(key), key
    for rid, (prompt, _) in zip(rids, REQS):
        _assert_tokens_match(jm, jp, prompt, want.outputs[rid],
                             rep.outputs[rid], (mode, chunk, rid))


@pytest.mark.parametrize("chunk", [None, 6], ids=["whole", "chunk6"])
def test_a_repeated_prompt_is_copied_on_write(engines, chunk):
    """The same page-aligned prompt twice over two slots: the second
    shares the first page, prefills only the last token over a private
    copy of the second, and emits exactly the first's tokens, which are
    the one-shot rollout's. The reference counts the same copy."""
    jm, _, jeng, teng, refs = engines("tiny-eq")
    prompt, gen = REQS[2]
    stats = []
    for eng, mod, cfg in ((jeng, j_sm, jm.cfg), (teng, sm, teng.model.cfg)):
        sch = mod.Scheduler(2, pages=_geometry(mod, cfg), prefix_share=True,
                            chunk_prefill_tokens=chunk)
        rids = [sch.submit(prompt, gen).rid for _ in range(2)]
        with jax.transfer_guard_device_to_host("disallow"):
            rep = eng.serve(scheduler=sch)
        stats.append(rep.stats)
    assert stats[1]["cow_copies"] == 1 == stats[0]["cow_copies"]
    assert stats[1]["shared_prefix_tokens"] == len(prompt) - 1
    assert rep.outputs[rids[0]] == rep.outputs[rids[1]] == refs[2]


def test_admission_refuses_an_over_long_prompt(engines):
    *_, teng, _ = engines("tiny-eq")
    pool = teng.pools.init_pool(1)
    with pytest.raises(ValueError, match="exceeds the KV slot depth"):
        teng.prefill_role.admit_into_slot(
            pool, 0, np.full((MAX_LEN + 1,), 5, np.int32), 4)


# ------------------------------------------------------------- the SSM


FALCON, JAMBA = "falcon-mamba-7b", "jamba-1.5-large-398b"


def _recurrent_engines(arch):
    """(jax model, jax params, jax engine, port engine) of a smoke config
    with recurrent state, the port's weights the reference's."""
    jm = j_build_model(j_get_reduced(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_reduced(arch), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ecfg = dict(max_len=32, sync_interval=4)
    return (jm, jp, JEngine(jm, jp, JEngineConfig(**ecfg)),
            Engine(tm, tp, EngineConfig(**ecfg)))


@pytest.fixture(scope="module")
def falcon():
    return _recurrent_engines(FALCON)


@pytest.fixture(scope="module")
def jamba():
    return _recurrent_engines(JAMBA)


def _falcon_prompts(vocab):
    rng = np.random.RandomState(4)
    return [rng.randint(2, vocab, size=n).astype(np.int32)
            for n in (6, 9, 4, 7, 5)]


def test_falcon_dense_stream_matches_jax(falcon):
    """Five requests over two dense slots (slots are reused, so each
    admission overwrites a drained slot's recurrent rows): the reference's
    counters and tokens, and the port's own one-shot tokens."""
    jm, jp, jeng, teng = falcon
    prompts = _falcon_prompts(teng.model.cfg.vocab_size)
    reports = []
    for eng, mod in ((jeng, j_sm), (teng, sm)):
        sch = mod.Scheduler(n_slots=2)
        for p in prompts:
            sch.submit(p, 12)
        with jax.transfer_guard_device_to_host("disallow"):
            reports.append(eng.serve(scheduler=sch))
    want, got = reports
    for key in COUNTERS + ("max_slot_reuse",):
        assert got.stats.get(key) == want.stats.get(key), key
    assert got.stats["max_slot_reuse"] >= 2
    assert got.stats["host_syncs"] == got.stats["chunks"]
    for rid, prompt in enumerate(prompts):
        _assert_tokens_match(jm, jp, prompt, want.outputs[rid],
                             got.outputs[rid], rid)
        one, _ = teng.generate({"tokens": torch.as_tensor(prompt[None])},
                               n_steps=12)
        assert got.outputs[rid] == one[0].tolist()[:len(got.outputs[rid])]


#: the serving modes the reference refuses a model with recurrent state
REFUSED = ["paged-share", "paged-chunk", "dense-chunk", "speculate", "int8",
           "fp8", "park"]


@pytest.mark.parametrize("model,mode", [
    pytest.param(model, mode, id=mode if model == "falcon"
                 else f"{model}-{mode}")
    for model in ("falcon", "jamba") for mode in REFUSED])
def test_falcon_refuses_what_the_reference_refuses(request, model, mode):
    """falcon-mamba-7b and jamba-1.5-large-398b (the cases named
    ``jamba-*``) refuse prefix sharing, chunked prefill on either pool,
    speculation and int8 / fp8 pages in both packages, with the
    reference's messages. Host parking is the exception: the port refuses
    it for a model with recurrent state, while the reference parks one and
    resumes it (it slices the slot's recurrent rows into the blob, though
    its ``serve/park.py`` says recurrent families never park); the
    ``park`` cases hold both behaviours as they stand."""
    jm, jp, jeng, teng = request.getfixturevalue(model)
    ports = ((jeng, j_sm, jm.cfg, JEngine, JEngineConfig, jm, jp),
             (teng, sm, teng.model.cfg, Engine, EngineConfig, teng.model,
              teng.params))
    for eng, mod, cfg, engine_cls, ecfg_cls, m, params in ports:
        if mode == "speculate":
            with pytest.raises(ValueError, match="roll back"):
                engine_cls(m, params, ecfg_cls(max_len=32,
                                               speculate_tokens=4))
            continue
        if mode in ("int8", "fp8"):
            with pytest.raises(ValueError, match="recurrent"):
                mod.derive_page_geometry(cfg, 32, page_tokens=8,
                                         max_slots=2, kv_quant=mode)
            continue
        pages = None if mode.startswith("dense") else \
            mod.derive_page_geometry(cfg, 32, page_tokens=8, max_slots=2)
        sch = mod.Scheduler(n_slots=2, pages=pages,
                            prefix_share=(mode == "paged-share"),
                            chunk_prefill_tokens=(
                                4 if mode.endswith("chunk") else None))
        rid = sch.submit(np.arange(2, 8, dtype=np.int32), 12).rid
        if mode != "park":
            with pytest.raises(ValueError, match="attention-only"):
                eng.serve(scheduler=sch)
            continue
        eng.serve(scheduler=sch, max_steps=4)
        if eng is teng:
            with pytest.raises(ValueError, match="attention-only"):
                eng.park_request(sch, rid)
        else:
            assert isinstance(eng.park_request(sch, rid), bytes)


def test_dense_stream_rejects_an_over_long_prompt(engines):
    """One bad request is rejected cleanly: the stream goes on and the
    slot is not leaked."""
    *_, teng, refs = engines("tiny-eq")
    sch = sm.Scheduler(2)
    sch.submit(np.arange(2, 2 + MAX_LEN + 1, dtype=np.int32) % 120 + 2, 4)
    rids = [sch.submit(p, g).rid for p, g in REQS[:2]]
    rep = teng.serve(scheduler=sch)
    assert rep.stats["rejected"] == 1 and rep.stats["drained"] == 2
    for rid, ref in zip(rids, refs):
        assert rep.outputs[rid] == ref[:len(rep.outputs[rid])]


# ---------------------------------------------------------- the guard


def test_page_ids_are_checked_on_the_host(engines):
    """A block-table, read, write or tier-copy id outside the pool raises
    before any upload: the kernels index pages unchecked."""
    assert check_page_ids(np.asarray([0, 3, 40]), 41, "t").tolist() == \
        [0, 3, 40]
    for bad in ([0, 41], [-1, 2]):
        with pytest.raises(ValueError, match="outside"):
            check_page_ids(np.asarray(bad), 41, "block table")
    *_, teng, _ = engines("tiny-eq")
    sch = _scheduler(sm, teng.model.cfg, "paged", None)
    sch.submit(REQS[0][0], 4)
    real = sch.block_table

    def corrupt(role=None):
        table = real(role)
        table[0, 0] = 99
        return table

    sch.block_table = corrupt
    with pytest.raises(ValueError, match=r"block table: page ids \[99\]"):
        teng.serve(scheduler=sch)
    teng.pools.geom = _geometry(sm, teng.model.cfg)
    with pytest.raises(ValueError, match="outside"):
        teng.pools.pad_pages([3, 41], 8, 41)


# -------------------------------------------------------- the launcher


@pytest.mark.parametrize("flags", [
    ["--stream", "4"],
    ["--stream", "4", "--paged", "--prefix-share", "--prompt-len", "24",
     "--system-len", "16"],
    ["--stream", "4", "--paged", "--chunk-prefill-tokens", "4"],
    ["--stream", "4", "--chunk-prefill-tokens", "4"],
], ids=["dense", "paged-share", "paged-chunk", "dense-chunk"])
def test_launch_serve_modes_on_cpu(capsys, flags):
    args = ["--batch", "2", "--prompt-len", "8", "--gen-len", "6",
            "--sync-interval", "4", "--page-tokens", "8", "--device",
            "cpu"] + flags
    rec = cli.run(args)
    out = capsys.readouterr().out
    assert "completed 4/4" in out and "device=cpu" in out
    assert rec["host_syncs"] == rec["chunks"]
    if "--chunk-prefill-tokens" in flags:
        assert "chunked prefill: 4 tokens/boundary" in out
        assert rec["max_boundary_prefill_tokens"] <= 4
    if "--prefix-share" in flags:
        assert rec["prefix_hits"] >= 1 and "prefix sharing:" in out
    else:
        assert "mode=" + ("paged" if "--paged" in flags else "dense") in out


def test_launch_serve_argument_errors(capsys):
    for flags in (["--prefix-share", "--stream", "2"],
                  ["--paged"],
                  ["--stream", "2", "--paged", "--prefix-share",
                   "--system-len", "8"]):
        with pytest.raises(SystemExit):
            cli.run(flags + ["--prompt-len", "8", "--device", "cpu"])
    capsys.readouterr()


def test_serving_target_follows_the_device():
    assert cli.serving_target(torch.device("cuda")) == "h100"
    assert cli.serving_target(torch.device("cpu")) is None


def test_launch_serve_derives_the_chunk_from_the_target(capsys):
    rec = cli.run(["--stream", "2", "--paged", "--chunk-prefill-tokens", "0",
                   "--batch", "2", "--prompt-len", "8", "--gen-len", "4",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "derived --chunk-prefill-tokens 512 (target tpu-v5e)" in out
    assert rec["chunk_prefill_tokens"] == 512


# --------------------------------------------------------- on the card


def _teacher_forced_gap(model, params, prompt, tokens) -> float:
    """The largest gap between the best logit and the served token's, over
    one full-sequence forward of prompt + tokens."""
    dev = model.device
    seq = torch.as_tensor(list(prompt) + list(tokens[:-1]), dtype=torch.int32,
                          device=dev)[None]
    x, _, _ = transformer.forward(model.cfg, params, seq)
    logits = layers.unembed_logits(params["tok"], x[0, len(prompt) - 1:])
    logits = logits[:, :model.cfg.vocab_size].float()
    picked = logits.gather(1, torch.as_tensor(
        list(tokens), device=dev)[:, None].long())[:, 0]
    return (logits.max(dim=1).values - picked).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "paged-share"])
def test_stream_on_the_card_matches_the_cpu(mode):
    """The same stream with the same weights on the CPU and on the card:
    the tokens of both are held within LOGIT_TOL of a teacher-forced pass
    on the card (cuBLAS picks GEMM algorithms by row count, so the two may
    part at a near-tie, but neither may pick a token the card's model
    ranks clearly worse)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the smoke config at the kernels' head_dim (both take D = 128)
    cfg = dataclasses.replace(get_reduced("qwen2.5-3b"), head_dim=128)
    reqs = sm.shared_prefix_stream(6, 16, 8, 12, cfg.vocab_size, seed=2)
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = cpu_model if dev == "cpu" else build_model(cfg, device=dev)
        eng = Engine(model, params_from_numpy(params_to_numpy(params), dev),
                     EngineConfig(max_len=40, sync_interval=4))
        pages = None if mode == "dense" else sm.derive_page_geometry(
            cfg, 40, page_tokens=8, max_slots=3)
        sch = sm.Scheduler(3, pages=pages,
                           prefix_share=(mode == "paged-share"))
        for r in reqs:
            sch.submit(r["prompt"], r["max_new_tokens"])
        rep = eng.serve(scheduler=sch)
        assert rep.stats["host_syncs"] == rep.stats["chunks"]
        if mode == "paged-share":
            assert rep.stats["prefix_hits"] >= 1
        runs[dev] = (model, eng.params, rep.outputs)
    card_model, card_params, _ = runs["cuda"]
    for rid, r in enumerate(reqs):
        for dev in ("cpu", "cuda"):
            gap = _teacher_forced_gap(card_model, card_params, r["prompt"],
                                      runs[dev][2][rid])
            assert gap <= LOGIT_TOL, (dev, rid, gap)
