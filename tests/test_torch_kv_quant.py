"""The port's int8 / fp8-e4m3 KV tier codecs against the JAX package's, on
the CPU.

Bit for bit against the reference, on the same numpy inputs (f32 division
is IEEE on both sides and both round half to even, so equality, not a
tolerance):

  * ``quantize_page_int8`` codes and scales (and ``dequantize_page_int8``)
    at the pooled leaf layouts, f32 and bf16 inputs, an all-zero page and
    a page of exact half-step ties;
  * the fp8-e4m3 cast (``ml_dtypes``' round to nearest even on the
    reference's side) for in-range f32 and bf16 values, ties and
    subnormals included, and the upcast back;
  * ``_paged_cache_write_q`` over a sequence of appends (one token and
    three a step) that crosses pages, grows a page's scale and resets it
    at offset 0 for a second tenant; every page but the null page 0 is
    compared (page 0 takes the junk writes, whose winner is unspecified);
  * ``slot_update_paged`` / ``gather_row_paged`` on int8 and fp8 pools and
    the tier copies between every codec pair a policy uses (the reference's
    jitted copy run eagerly, under ``jax.disable_jit``: inside jit XLA
    rewrites the division by a broadcast scale into a multiplication by
    its reciprocal, which can move a code by one; the reference's source,
    and the port, divide);
  * ``quant_policy``, the codec table and ``derive_page_geometry``'s page
    counts per codec (int8 holds at least 1.8x fp16's pages in one budget).

Against the reference's engine on the same weights (``TINY`` through the
numpy bridge, the fixtures of ``test_torch_serve_modes.py``): one decode
step's logits off an int8 / fp8 pool within ``REF_LOGIT_TOL = 1e-2`` of the
reference's, and the scheduler counters of a quantized stream that
preempts, and of one that chunks, equal to the reference's.

Inside the port, the cells of the reference's equivalence matrix
(``tests/test_equivalence_matrix.py`` ``KVQ_CELLS``: paged, paged-share,
chunked, speculate, disagg) over its four requests: the fp16 codec path
bit-identical to the one-shot rollout; one-step drift against the fp16
pool within the pinned 0.05 (int8) / 0.10 (fp8) with the same argmax;
first-token agreement of at least 0.75; quantized spill -> restore equal
to never spilled, token for token.

Refusals: quantized codecs for the recurrent falcon-mamba-7b, and the
paged kernel for a quantized pool. The CLI serves ``--kv-quant`` on
``--device cpu`` and refuses it without ``--paged``. The ``cuda``-marked
cases serve an int8 and an fp8 stream on the card (the fp8 one through
both cross-codec tier copies) with no paged-kernel launch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as j_pq
from repro.models.attention import _paged_cache_write_q as j_write_q
from repro.serve import pool as j_pool
from repro.serve import scheduler as j_sm
from repro_torch.configs import get_reduced
from repro_torch.kernels import paged_attention as pq
from repro_torch.launch import serve as cli
from repro_torch.models import build_model, transformer
from repro_torch.models.attention import _paged_cache_write_q
from repro_torch.serve import scheduler as sm
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.pool import CODECS, PoolManager, quant_policy

from test_torch_serve_modes import CONFIGS, REQS as MODE_REQS, engines  # noqa: F401

torch.set_num_threads(1)
MAX_LEN, PT = 64, 8
REF_LOGIT_TOL = 1e-2
KVQ_LOGIT_BOUND = {"int8": 0.05, "fp8": 0.10}
KVQ_FIRST_TOKEN_AGREEMENT = 0.75
KVQ_CELLS = (("paged", False, None, 0, False),
             ("paged-share", True, None, 0, False),
             ("chunked", False, 6, 0, False),
             ("speculate", False, None, 4, False),
             ("disagg", False, 6, 0, True))
#: the equivalence matrix's four requests (test_torch_serve_modes adds a
#: fifth, the bare system prefix, at index 2)
REQS = MODE_REQS[:2] + MODE_REQS[3:]
REF_IDX = (0, 1, 3, 4)
COUNTERS = ("chunks", "decode_steps", "prefill_chunks", "preemptions",
            "spilled_pages", "restores", "host_syncs", "n_pages",
            "n_spill_pages", "pages_high_water", "spill_high_water",
            "resident_high_water", "layer0_codec", "layer1_codec")


def _torch(x: np.ndarray) -> torch.Tensor:
    """A numpy array of any dtype the pools use (bf16 and fp8 included)
    as a CPU tensor with the same bits."""
    name = str(x.dtype)
    if name == "float8_e4m3fn":
        return torch.from_numpy(x.view(np.uint8).copy()).view(pq.FP8)
    if name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True))


def _bytes(t) -> bytes:
    """The raw bytes of a tensor or a reference array."""
    if torch.is_tensor(t):
        return pq.as_bits(t).cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
    return np.asarray(t).tobytes()


# ------------------------------------------------------------- the codecs


def _pages(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * np.exp(rng.randn(shape[0], *(1,) * (len(shape) - 1)))
         ).astype(np.float32)
    x[0] = 0.0                                  # an all-zero page
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5, -126.5],
                    np.float32)                 # scale 1: exact half steps
    x[1].reshape(-1)[:] = np.resize(ties, x[1].size)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axes", [((6, 2, PT, 16), (1, 2, 3)),
                                        ((3, 4, 2, PT, 16), (2, 3, 4)),
                                        ((6, PT, 24), (1, 2))],
                         ids=["gqa-pages", "stacked-cut", "flat-pages"])
def test_int8_codes_and_scales_equal_the_reference(shape, axes, dtype):
    x = _pages(shape, 7)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jc, js = j_pq.quantize_page_int8(jx, axes)
    tc, ts = pq.quantize_page_int8(tx, axes)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert _bytes(tc) == _bytes(jc)
    assert _bytes(ts) == _bytes(js)
    assert int(tc.min()) >= -127
    assert _bytes(pq.dequantize_page_int8(tc, ts, axes)) == \
        _bytes(j_pq.dequantize_page_int8(jc, js, axes))
    if x.ndim == 4:
        assert (ts[0] == 0).all() and (tc[0] == 0).all()
        # round half to even at scale 1: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
        assert tc[1].reshape(-1)[:6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_cast_equals_the_reference(dtype):
    rng = np.random.RandomState(3)
    x = np.concatenate([
        rng.randn(4096).astype(np.float32) * 40.0,
        rng.randn(1024).astype(np.float32) * 2.0 ** -8,    # subnormals
        np.array([1.0625, 1.1875, -1.0625, 448.0, -448.0, 2.0 ** -9 * 1.5,
                  2.0 ** -10, 0.0, -0.0, 240.0, 232.0], np.float32)])
    x = np.clip(x, -448.0, 448.0)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jx.astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = tx.to(pq.FP8)
    assert pq.as_bits(got).numpy().tobytes() == want.tobytes()
    back = np.asarray(jx.astype(jnp.float8_e4m3fn).astype(jnp.float32))
    assert got.float().numpy().tobytes() == back.tobytes()


@pytest.mark.parametrize("axis", [0, 1], ids=["tokens-first", "gqa"])
@pytest.mark.parametrize("s", [1, 3], ids=["decode", "verify3"])
def test_paged_cache_write_q_equals_the_reference(axis, s):
    """Two rows append over their block tables; row 1's third logical page
    is unmapped, so its late appends resolve to null page 0. Then row 0's
    first page gets a second tenant at offset 0 with a 100x smaller
    amplitude: its scale must reset, not keep the old amax."""
    rng = np.random.RandomState(11 + s)
    n_pages, hkv, hd = 6, 2, 4
    shape = (n_pages, PT, hkv * hd) if axis == 0 else (n_pages, hkv, PT, hd)
    pages = np.zeros(shape, np.int8)
    scales = np.zeros((n_pages,), np.float32)
    bt = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    t_pages, t_scales = torch.from_numpy(pages.copy()), torch.zeros(n_pages)
    j_pages, j_scales = jnp.asarray(pages), jnp.asarray(scales)
    steps = [(np.array([t * s, 5 + t * s], np.int32), 10.0 ** rng.uniform(-1, 1))
             for t in range(-(-(2 * PT + 2) // s))]
    steps += [(np.array([0, 0], np.int32), 1e-2)]   # a second tenant
    history = []
    for cache_len, amp in steps:
        new_shape = (2, s, hkv * hd) if axis == 0 else (2, hkv, s, hd)
        new = (rng.randn(*new_shape) * amp).astype(np.float32)
        _paged_cache_write_q(t_pages, t_scales, torch.from_numpy(new),
                             torch.from_numpy(cache_len), torch.from_numpy(bt),
                             axis)
        j_pages, j_scales = j_write_q(j_pages, j_scales, jnp.asarray(new),
                                      jnp.asarray(cache_len), jnp.asarray(bt),
                                      axis)
        assert _bytes(t_pages[1:]) == _bytes(j_pages[1:])
        assert _bytes(t_scales[1:]) == _bytes(j_scales[1:])
        history.append((cache_len[0], t_scales[1].item()))
    # page 1 (row 0's first page): monotone while its first tenant fills it
    first = [sc for pos, sc in history[:-1] if pos < PT]
    assert first == sorted(first) and first[-1] > 0
    assert history[-1][1] < first[-1] / 10, "offset 0 did not reset the scale"


def _codec_state(cfg, codec, n_pages, seed):
    """Random pool contents at ``codec`` for ``cfg``'s paged caches, as the
    same bits in a port tree and a reference tree."""
    rng = np.random.RandomState(seed)
    c = CODECS[codec]
    port = transformer.init_paged_caches(cfg, 1, n_pages, PT, "cpu",
                                         dtype=c.dtype, quant_scales=c.scaled)
    ref = {}
    for gname, gkey, _ in transformer.cache_attn_kinds(cfg):
        out = {}
        for name, leaf in port[gname][gkey].items():
            f = (rng.randn(*leaf.shape) * 1.5).astype(np.float32)
            if name.endswith("_scale"):
                arr = np.abs(f) / 127
            elif codec == "int8":
                arr = np.clip(np.round(f * 40), -127, 127).astype(np.int8)
            elif codec == "fp8":
                arr = np.asarray(jnp.asarray(f).astype(jnp.float8_e4m3fn))
            else:
                arr = np.asarray(jnp.asarray(f).astype(jnp.bfloat16))
            pq.as_bits(leaf).copy_(pq.as_bits(_torch(arr)))
            out[name] = jnp.asarray(arr)
        ref.setdefault(gname, {})[gkey] = out
    return port, ref


def _assert_same_tree(port, ref, what):
    for gname, gkey, _ in transformer.cache_attn_kinds(CONFIGS["tiny-eq"][0]):
        for name, leaf in port[gname][gkey].items():
            assert _bytes(leaf) == _bytes(ref[gname][gkey][name]), \
                (what, gname, gkey, name)


@pytest.mark.parametrize("src,dst", [("int8", "int8"), ("fp8", "int8"),
                                     ("int8", "fp8"), ("fp8", "fp8")])
def test_tier_copies_equal_the_reference(engines, src, dst):
    """Same codec: codes and scales verbatim. Across codecs: dequantize,
    then re-encode with fresh scales for int8. Padded entries route
    through the null pages, which are left out of the comparison by
    zeroing them on both sides first."""
    jm, _, jeng, teng, _ = engines("tiny-eq")
    cfg = teng.model.cfg
    s_port, s_ref = _codec_state(cfg, src, 9, 1)
    d_port, d_ref = _codec_state(cfg, dst, 7, 2)
    pages_src, pages_dst = [3, 8, 5, 0], [6, 1, 2, 0]
    teng.pools._tier_copy(s_port, d_port, 0, 0,
                          torch.tensor(pages_src), torch.tensor(pages_dst),
                          src, dst)
    fn = j_pool.PoolManager(jm, jeng.ecfg, lambda t: t).tier_copy_fn(src, dst)
    with jax.disable_jit():
        d_ref = fn(s_ref, d_ref, jnp.int32(0), jnp.int32(0),
                   jnp.asarray(pages_src, jnp.int32),
                   jnp.asarray(pages_dst, jnp.int32))
    for tree in (d_port, d_ref):
        for gname, gkey, _ in transformer.cache_attn_kinds(cfg):
            for name in list(tree[gname][gkey]):
                leaf = tree[gname][gkey][name]
                if torch.is_tensor(leaf):
                    pq.as_bits(leaf)[:, 0] = 0
                else:
                    tree[gname][gkey][name] = leaf.at[:, 0].set(
                        jnp.zeros((), leaf.dtype))
    _assert_same_tree(d_port, d_ref, (src, dst))


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_row_moves_equal_the_reference(engines, codec):
    """``slot_update_paged`` quantizes each page cut with fresh scales (or
    casts it) exactly as the reference; ``gather_row_paged`` dequantizes
    the pool back into the same bf16 row."""
    jm, _, _, teng, _ = engines("tiny-eq")
    cfg = teng.model.cfg
    rng = np.random.RandomState(4)
    p_max = MAX_LEN // PT
    row = {}
    t_row = {}
    for gname, gkey, _ in transformer.cache_attn_kinds(cfg):
        g = teng.model.cfg.layer_groups()
        n_rep = next(gr.n_repeat for gr in g if gr.name == gname)
        shape = (n_rep, 1, cfg.n_kv_heads, MAX_LEN, cfg.head_dim)
        leaves = {n: np.asarray(jnp.asarray(
            rng.randn(*shape).astype(np.float32)).astype(jnp.bfloat16))
            for n in ("k", "v")}
        row.setdefault(gname, {})[gkey] = {n: jnp.asarray(a)
                                           for n, a in leaves.items()}
        t_row.setdefault(gname, {})[gkey] = {n: _torch(a)
                                             for n, a in leaves.items()}
    block_row = np.array([4, 9, 2, 7, 0, 0, 0, 0], np.int32)[:p_max]
    t_pool, j_pool_caches = _codec_state(cfg, codec, 10, 5)
    teng.model.slot_update_paged({"caches": t_pool}, {"caches": t_row}, 0,
                                 torch.from_numpy(block_row), PT)
    j_state = jm.slot_update_paged({"caches": j_pool_caches},
                                   {"caches": row}, jnp.int32(0),
                                   jnp.asarray(block_row), PT)
    for tree in (t_pool, j_state["caches"]):       # null page: junk rows
        for gname, gkey, _ in transformer.cache_attn_kinds(cfg):
            for name in list(tree[gname][gkey]):
                leaf = tree[gname][gkey][name]
                if torch.is_tensor(leaf):
                    pq.as_bits(leaf)[:, 0] = 0
                else:
                    tree[gname][gkey][name] = leaf.at[:, 0].set(
                        jnp.zeros((), leaf.dtype))
    _assert_same_tree(t_pool, j_state["caches"], codec)
    read = np.array([4, 9, 2, 7, 3, 0, 0, 0], np.int32)[:p_max]
    t_back = teng.model.gather_row_paged({"caches": t_pool},
                                         torch.from_numpy(read), PT)
    j_back = jm.gather_row_paged(j_state, jnp.asarray(read), PT)
    _assert_same_tree(t_back["caches"], j_back["caches"], codec)


# ------------------------------------------------------ policy and pages


def test_quant_policy_and_codecs_equal_the_reference():
    for knob in (None, "none", "fp16", "fp8", "int8"):
        assert quant_policy(knob) == j_pool.quant_policy(knob)
    with pytest.raises(ValueError, match="kv quant"):
        quant_policy("int4")
    for name, codec in CODECS.items():
        ref = j_pool.CODECS[name]
        assert (codec.bytes_per_value, codec.scaled) == \
            (ref.bytes_per_value, ref.scaled)
        assert torch.empty(0, dtype=codec.dtype).element_size() == \
            np.dtype(ref.dtype).itemsize
    assert CODECS["fp8"].dtype == torch.float8_e4m3fn
    assert CODECS["int8"].dtype == torch.int8


@pytest.mark.parametrize("budget", [16 * 1024, 32 * 1024, 128 * 1024])
def test_page_counts_per_codec_equal_the_reference(budget):
    tcfg, jcfg = CONFIGS["tiny-eq"]
    geoms = {}
    for q in ("fp16", "fp8", "int8"):
        kw = dict(page_tokens=PT, max_slots=32, layer0_bytes=budget,
                  layer1_bytes=budget // 2, kv_quant=q)
        got = sm.derive_page_geometry(tcfg, MAX_LEN, **kw)
        want = j_sm.derive_page_geometry(jcfg, MAX_LEN, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), q
        geoms[q] = got
    assert (geoms["int8"].n_pages - 1) >= 1.8 * (geoms["fp16"].n_pages - 1)
    assert geoms["fp8"].layer1_codec == "int8"


# --------------------------------------------------- one step of decode


def _one_step_logits(eng, kv_quant, pools, to_tables):
    cfg = eng.model.cfg
    geom = (sm if isinstance(eng, Engine) else j_sm).derive_page_geometry(
        cfg, MAX_LEN, page_tokens=PT, max_slots=3, layer0_bytes=64 * 1024,
        kv_quant=kv_quant)
    sch = (sm if isinstance(eng, Engine) else j_sm).Scheduler(3, pages=geom)
    sch.submit(REQS[0][0], 8)
    plan = sch.plan_boundary(chunk_tokens=1, max_len=MAX_LEN)
    pool, _ = pools(sch)
    slot, req = plan.admits[0]
    pool, _ = eng.prefill_role.paged_admit(pool, slot, req, geom)
    tables = to_tables(sch.block_table())
    logits, _ = eng.model.decode_step(
        eng.params, pool.tok[:, None], pool.state, pool.cache_len,
        plans=eng.plans, block_tables=tables)
    return np.asarray(logits[slot, 0, :cfg.vocab_size], np.float32)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_one_step_logits_against_the_reference(engines, kv_quant):
    """Port vs reference off the same quantized pool within
    REF_LOGIT_TOL; inside the port, drift against the fp16 pool within the
    matrix's pinned bound, with the same argmax."""
    _, _, jeng, teng, _ = engines("tiny-eq")
    port = {q: _one_step_logits(teng, q, teng.pools.init_paged_pool,
                                torch.as_tensor)
            for q in ("fp16", kv_quant)}
    ref = _one_step_logits(jeng, kv_quant, jeng.init_paged_pool, jnp.asarray)
    assert np.abs(port[kv_quant] - ref).max() <= REF_LOGIT_TOL
    drift = np.abs(port[kv_quant] - port["fp16"]).max()
    assert drift <= KVQ_LOGIT_BOUND[kv_quant], drift
    assert np.argmax(port[kv_quant]) == np.argmax(port["fp16"])


# ------------------------------------------------------------ the streams


def _quant_geometry(mod, cfg, kv_quant, layer0_bytes=64 * 1024,
                    layer1_bytes=None):
    return mod.derive_page_geometry(cfg, MAX_LEN, page_tokens=PT,
                                    max_slots=3, layer0_bytes=layer0_bytes,
                                    layer1_bytes=layer1_bytes,
                                    kv_quant=kv_quant)


def _serve(eng, sch, reqs):
    rids = [sch.submit(p, g).rid for p, g in reqs]
    with jax.transfer_guard_device_to_host("disallow"):
        rep = eng.serve(scheduler=sch)
    return [rep.outputs[r] for r in rids], rep.stats


def _spill_requests():
    """The reference's spill case (``test_kv_quant.py``): four prompts that
    preempt a 9000-byte (8-page) quantized layer 0."""
    rng = np.random.RandomState(5)
    return [(rng.randint(2, 128, size=n).astype(np.int32), g)
            for n, g in ((21, 12), (17, 10), (25, 8), (13, 14))]


SPILL_REQS = _spill_requests()


@pytest.mark.parametrize("chunk", [None, 6], ids=["whole", "chunk6"])
@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantized_stream_counters_equal_the_reference(engines, kv_quant,
                                                       chunk):
    """The spill case over an 8-page layer 0, whole (it preempts, spills
    and restores; fp8 spills across codecs into int8) and chunked by 6:
    every scheduler counter equals the reference's."""
    jm, _, jeng, teng, _ = engines("tiny-eq")
    stats = []
    for eng, mod, cfg in ((jeng, j_sm, jm.cfg), (teng, sm, teng.model.cfg)):
        geom = _quant_geometry(mod, cfg, kv_quant, 9000, 256 * 1024)
        sch = mod.Scheduler(3, pages=geom, chunk_prefill_tokens=chunk)
        outs, st = _serve(eng, sch, SPILL_REQS)
        assert all(len(o) > 0 for o in outs)
        stats.append(st)
    want, got = stats
    if chunk is None:
        assert got["preemptions"] > 0 and got["restores"] > 0
    else:
        assert got["prefill_chunks"] > len(SPILL_REQS)
    assert got["layer0_codec"] == kv_quant
    for key in COUNTERS:
        assert got[key] == want[key], key


@pytest.mark.parametrize("cell", KVQ_CELLS, ids=[c[0] for c in KVQ_CELLS])
def test_fp16_codec_cells_bit_identical(engines, cell):
    _, share, chunk, spec, disagg = cell
    *_, teng, refs = engines("tiny-eq")
    eng = Engine(teng.model, teng.params,
                 EngineConfig(max_len=MAX_LEN, sync_interval=4,
                              speculate_tokens=spec))
    sch = sm.Scheduler(3, pages=_quant_geometry(sm, eng.model.cfg, "fp16"),
                       prefix_share=share, chunk_prefill_tokens=chunk,
                       disaggregate=disagg)
    outs, st = _serve(eng, sch, REQS)
    assert st["layer0_codec"] == "fp16"
    assert st["host_syncs"] == st["chunks"] or disagg
    for got, i in zip(outs, REF_IDX):
        assert len(got) > 0
        assert got == refs[i][:len(got)], (cell[0], i)


@pytest.mark.parametrize("cell", KVQ_CELLS, ids=[c[0] for c in KVQ_CELLS])
@pytest.mark.parametrize("kv_quant", sorted(KVQ_LOGIT_BOUND))
def test_quantized_cells_serve_with_greedy_agreement(engines, kv_quant,
                                                     cell):
    _, share, chunk, spec, disagg = cell
    *_, teng, refs = engines("tiny-eq")
    eng = Engine(teng.model, teng.params,
                 EngineConfig(max_len=MAX_LEN, sync_interval=4,
                              speculate_tokens=spec))
    sch = sm.Scheduler(3, pages=_quant_geometry(sm, eng.model.cfg, kv_quant),
                       prefix_share=share, chunk_prefill_tokens=chunk,
                       disaggregate=disagg)
    outs, st = _serve(eng, sch, REQS)
    assert st["layer0_codec"] == kv_quant
    assert all(len(o) > 0 for o in outs)
    agree = sum(o[0] == refs[i][0] for o, i in zip(outs, REF_IDX))
    assert agree >= KVQ_FIRST_TOKEN_AGREEMENT * len(REQS), (cell[0], agree)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantized_spill_restore_matches_never_spilled(engines, kv_quant):
    """The reference's case: same-codec copies move codes and scales
    verbatim, so a tight int8 pool serves the ample pool's tokens. The fp8
    policy spills into int8 and back, a lossy round trip the reference
    also holds to the ample pool's tokens on these requests."""
    *_, teng, _ = engines("tiny-eq")
    reqs, cfg = SPILL_REQS, teng.model.cfg
    ample, st_a = _serve(teng, sm.Scheduler(3, pages=_quant_geometry(
        sm, cfg, kv_quant, 128 * 1024, 256 * 1024)), reqs)
    tight, st_t = _serve(teng, sm.Scheduler(3, pages=_quant_geometry(
        sm, cfg, kv_quant, 9000, 256 * 1024)), reqs)
    assert st_t["preemptions"] > 0 and st_a["preemptions"] == 0
    assert tight == ample


# -------------------------------------------------------------- refusals


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_recurrent_family_refuses_quantized_codecs(kv_quant):
    fcfg = get_reduced("falcon-mamba-7b")
    with pytest.raises(ValueError, match="recurrent"):
        sm.derive_page_geometry(fcfg, 32, page_tokens=8, max_slots=2,
                                kv_quant=kv_quant)
    geom = dataclasses.replace(
        sm.derive_page_geometry(fcfg, 32, page_tokens=8, max_slots=2),
        layer0_codec=kv_quant, layer1_codec=kv_quant)
    pools = PoolManager(build_model(fcfg, device="cpu"),
                        EngineConfig(max_len=32))
    with pytest.raises(ValueError, match="recurrent"):
        pools.init_paged_pool(sm.Scheduler(2, pages=geom))


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_quantized_pool_refuses_the_paged_kernel(codec):
    """The page walk reads bf16 pages: ``impl="kernel"`` raises on a
    quantized pool before any launch, and ``impl="auto"`` gathers."""
    c = CODECS[codec]
    pages = torch.zeros((4, 2, PT, 16), dtype=torch.uint8).view(c.dtype) \
        if codec == "fp8" else torch.zeros((4, 2, PT, 16), dtype=c.dtype)
    scale = torch.zeros((4,)) if c.scaled else None
    q = torch.randn(1, 4, 1, 16).to(torch.bfloat16)
    bt = torch.tensor([[1, 2]], dtype=torch.int32)
    cl = torch.tensor([9], dtype=torch.int32)
    kw = dict(k_scale=scale, v_scale=scale)
    with pytest.raises(NotImplementedError, match="bf16 pages"):
        pq.paged_decode_attention(q, pages, pages, bt, cl, impl="kernel",
                                  **kw)
    launches = pq.paged_flash_decode.launches
    out = pq.paged_decode_attention(q, pages, pages, bt, cl, **kw)
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    assert pq.paged_flash_decode.launches == launches


# --------------------------------------------------------- the launcher


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_launch_serve_kv_quant_on_cpu(capsys, kv_quant):
    rec = cli.run(["--stream", "4", "--paged", "--kv-quant", kv_quant,
                   "--batch", "2", "--prompt-len", "8", "--gen-len", "6",
                   "--sync-interval", "4", "--page-tokens", "8",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completed 4/4" in out and f"mode=paged+{kv_quant}" in out
    assert f"tier codecs: layer0={kv_quant} layer1=int8" in out
    assert rec["layer0_codec"] == kv_quant
    assert rec["host_syncs"] == rec["chunks"]


def test_launch_serve_kv_quant_needs_paged(capsys):
    for flags in (["--stream", "2", "--kv-quant", "int8"],
                  ["--stream", "2", "--kv-quant", "fp8"]):
        with pytest.raises(SystemExit):
            cli.run(flags + ["--device", "cpu"])
    assert "--kv-quant requires --paged" in capsys.readouterr().err


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantized_stream_on_the_card(kv_quant):
    """A quantized stream on the card at the kernels' head_dim: every
    request drains, the paged kernel is never launched (gather + oracle,
    the reference's dispatch), and the first tokens agree with the fp16
    paged stream's. The tight fp8 pool spills into int8 and restores, so
    the fp8 write, gather and both cross-codec copies run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_reduced("qwen2.5-3b"), head_dim=128)
    model = build_model(cfg, device="cuda")
    eng = Engine(model, model.init(torch.Generator("cuda").manual_seed(0)),
                 EngineConfig(max_len=48, sync_interval=4))
    reqs = [(r["prompt"], r["max_new_tokens"])
            for r in sm.synthetic_stream(6, 24, 12, cfg.vocab_size, seed=2)]
    runs = {}
    for q, n_pages in (("fp16", None), (kv_quant, 7)):
        geom = sm.derive_page_geometry(cfg, 48, page_tokens=8, max_slots=3,
                                       kv_quant=q)
        if n_pages:
            geom = sm.derive_page_geometry(
                cfg, 48, page_tokens=8, max_slots=3, kv_quant=q,
                layer0_bytes=n_pages * geom.page_bytes)
        launches = pq.paged_flash_decode.launches
        outs, st = _serve(eng, sm.Scheduler(3, pages=geom), reqs)
        runs[q] = (outs, st, pq.paged_flash_decode.launches - launches)
    outs, st, paged = runs[kv_quant]
    assert paged == 0 and runs["fp16"][2] > 0
    assert st["layer0_codec"] == kv_quant and st["preemptions"] > 0
    assert st["host_syncs"] == st["chunks"]
    agree = sum(a[0] == b[0] for a, b in zip(outs, runs["fp16"][0]))
    assert agree >= KVQ_FIRST_TOKEN_AGREEMENT * len(reqs)
