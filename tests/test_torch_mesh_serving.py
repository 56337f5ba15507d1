"""Sharded serving's host arithmetic and plain math on the CPU, without a
process group: the mesh budgets against the reference's, the greedy
pick's merge over vocabulary shards, the pooled decode's range split and
the refusals that name ROADMAP A13c.

* ``kv_shards``, ``derive_page_geometry``, ``derive_n_slots`` (paged and
  dense, with ``data_shards``), ``CapacityPartition.scaled`` and
  ``TieredPartition.scaled`` at ``model_shards`` 1-4 equal the
  reference's functions on the same inputs, exactly (host integers and
  dataclasses; ``tests/test_mesh_serving.py``'s cases over every REDUCED
  config and its two tiny ones).
* The greedy merge (``tensor_parallel.local_greedy`` on each rank's
  columns, then ``merge_greedy``) equals ``torch.argmax`` over the whole
  row exactly, on built ties within a rank, across ranks and against
  larger values in the padded columns past ``vocab_size``.
* The range split: each slot's live positions cut into 2, 3 and 4 ranges
  (``decode_range``), each range's plain decode with its log-sum-exp
  (``decode_attention_lse`` on the slab, ``paged_decode_attention(span=)``
  on the pool), merged (``merge_ranges``) against the whole walk, with and
  without a window, at one query column and at a verify chunk of 3, with
  ranges that are empty (a frontier of 0 over 4 ranges) and ranges wholly
  behind the window. In f32 within ``F32_TOL`` = 1e-5 (measured 3.6e-7:
  the merge reassociates the softmax sums); in bf16 within ``BF16_TOL``
  = 2e-2, the paged kernel's tolerance (each range output is rounded to
  bf16 before the merge; measured 7.8e-3, one bf16 ulp at values in
  [1, 2)). The merged lse equals the whole walk's (``F32_TOL``), and an
  empty range gives a zero output and -inf, never NaN.
* ``paged_flash_decode_plain(start=, return_lse=True)``, the kernel's
  plain version, hides the positions before ``start`` as the window hides
  those behind it: the larger bound wins (exactly the slab oracle's
  masks).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core.target import CapacityPartition as JCapacityPartition
from repro.core.target import TieredPartition as JTieredPartition
from repro.models.config import ModelConfig as JModelConfig
from repro.serve import scheduler as jsm
from repro_torch.benchmarks import serve_bench
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.target import CapacityPartition, TieredPartition
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.paged_attention import (decode_attention_lse,
                                                 decode_range,
                                                 gather_kv_pages,
                                                 merge_ranges,
                                                 paged_decode_attention,
                                                 paged_flash_decode_plain)
from repro_torch.launch import serve as cli
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.serve import scheduler as sm
from repro_torch.serve.engine import Engine, EngineConfig

F32_TOL = 1e-5
BF16_TOL = 2e-2
MAX_LEN = 64
SHARDS = (1, 2, 3, 4)
_TINY = dict(name="tiny-mesh", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)
_MLA = dict(_TINY, name="tiny-mesh-mla", n_kv_heads=4, use_mla=True,
            kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16)
CONFIGS = {"tiny": (ModelConfig(**_TINY), JModelConfig(**_TINY)),
           "tiny-mla": (ModelConfig(**_MLA), JModelConfig(**_MLA))}
CONFIGS.update({arch: (get_reduced(arch), j_get_reduced(arch))
                for arch in ARCH_IDS})
#: the configs sharded serving runs above a model axis of 1
GQA_DECODERS = ("qwen2.5-3b", "yi-6b", "mistral-nemo-12b", "gemma3-27b")
#: expert-parallel MoE decoders, at the model axes that divide their
#: experts (the smoke configs' 8) and, with MLA, their heads (deepseek's 4)
EP_DECODERS = {"qwen3-moe-30b-a3b": (1, 2, 4),
               "deepseek-v2-236b": (1, 2, 4)}
#: (arch, model axis) refused: every other config at 2, the expert-parallel
#: ones at an axis that does not divide their experts (3) or MLA's heads
#: (deepseek at 8)
REFUSED = sorted([(arch, 2) for arch in ARCH_IDS
                  if arch not in GQA_DECODERS and arch not in EP_DECODERS]
                 + [("qwen3-moe-30b-a3b", 3), ("deepseek-v2-236b", 3),
                    ("deepseek-v2-236b", 8)])
#: one id an arch: its first refusal's is the arch's name
REFUSED_IDS = [arch if [a for a, _ in REFUSED].index(arch) == i
               else f"{arch}-m{model}"
               for i, (arch, model) in enumerate(REFUSED)]


def _fields(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_budgets_equal_the_reference(name, shards):
    cfg, jcfg = CONFIGS[name]
    assert sm.kv_shards(cfg, shards) == jsm.kv_shards(jcfg, shards)
    l0 = 8 * jsm.kv_bytes_per_token(jcfg) * MAX_LEN or 64
    kw = dict(page_tokens=8, max_slots=32, layer0_bytes=l0,
              model_shards=shards)
    geom = sm.derive_page_geometry(cfg, MAX_LEN, **kw)
    jgeom = jsm.derive_page_geometry(jcfg, MAX_LEN, **kw)
    assert _fields(geom) == _fields(jgeom)
    for data in (1, 2):
        for pages, jpages in ((geom, jgeom), (None, None)):
            got = sm.derive_n_slots(cfg, MAX_LEN, pages=pages, max_slots=16,
                                    model_shards=shards, data_shards=data)
            want = jsm.derive_n_slots(jcfg, MAX_LEN, pages=jpages,
                                      max_slots=16, model_shards=shards,
                                      data_shards=data)
            assert got == want, (pages is None, data)


@pytest.mark.parametrize("shards", SHARDS)
def test_partitions_scale_as_the_reference(shards):
    part = CapacityPartition(capacity_bytes=1 << 20, fraction=0.5)
    jpart = JCapacityPartition(capacity_bytes=1 << 20, fraction=0.5)
    assert _fields(part.scaled(shards)) == _fields(jpart.scaled(shards))
    tiers = TieredPartition(layer0=CapacityPartition(capacity_bytes=1024),
                            layer1=CapacityPartition(capacity_bytes=4096))
    jtiers = JTieredPartition(
        layer0=JCapacityPartition(capacity_bytes=1024),
        layer1=JCapacityPartition(capacity_bytes=4096))
    assert _fields(tiers.scaled(shards)) == _fields(jtiers.scaled(shards))


def _merge_over(logits, ranks, vocab):
    """The greedy pick of ``logits`` as ``ranks`` vocabulary shards make
    it."""
    n = logits.shape[-1] // ranks
    cands = [tp.local_greedy(logits[..., r * n:(r + 1) * n], r, vocab)
             for r in range(ranks)]
    return tp.merge_greedy(torch.stack([c[0] for c in cands]),
                           torch.stack([c[1] for c in cands]))


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_greedy_merge_equals_argmax_on_ties(ranks):
    vocab, padded = 100, 128
    rng = np.random.RandomState(0)
    rows = torch.from_numpy(rng.randn(6, padded).astype(np.float32))
    rows[0, [3, 5]] = 9.0              # a tie inside rank 0's columns
    rows[1, [20, 40, 70, 90]] = 9.0    # ties across every rank's columns
    rows[2, [97, 99]] = 9.0            # a tie in the last rank's columns
    rows[2, 100:] = 50.0               # larger values past vocab_size
    rows[3, :] = 1.0                   # the whole row one value
    rows[4, 63:66] = 7.0               # a tie over a shard boundary
    for row in range(rows.shape[0]):
        want = torch.argmax(rows[row, :vocab])
        assert _merge_over(rows[row], ranks, vocab) == want, row
    batch = rows.reshape(2, 3, padded)
    assert torch.equal(_merge_over(batch, ranks, vocab),
                       torch.argmax(batch[..., :vocab], dim=-1))


def _pool(dtype, b=4, hq=4, hkv=2, d=16, pt=8, p_max=6, seed=0):
    gen = torch.Generator().manual_seed(seed)
    n_pages = b * p_max + 1

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    kp, vp = rnd(n_pages, hkv, pt, d), rnd(n_pages, hkv, pt, d)
    bt = (torch.randperm(n_pages - 1, generator=gen) + 1).reshape(
        b, p_max).to(torch.int32)
    return rnd, kp, vp, bt


#: per-slot frontiers: empty (0 over 4 ranges leaves ranges empty), a
#: page edge, mid-page, the last position
LENS = [0, 8, 21, 46]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", ["dense", "paged"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_range_split_merges_to_the_whole_walk(n, s, window, pool, dtype):
    rnd, kp, vp, bt = _pool(dtype)
    cl = torch.tensor(LENS, dtype=torch.int32) - (s - 1) * (
        torch.tensor(LENS) > 0).int()
    q = rnd(4, 4, s, 16)
    k = gather_kv_pages(kp, bt, seq_axis=1)
    v = gather_kv_pages(vp, bt, seq_axis=1)
    whole, whole_lse = decode_attention_lse(q, k, v, cl, window=window)
    outs, lses = [], []
    for r in range(n):
        span = decode_range(cl, s, n, r, batch=4, window=window)
        if pool == "dense":
            o, lse = decode_attention_lse(q, k, v, cl, window=window,
                                          start=span[0], end=span[1])
        else:
            o, lse = paged_decode_attention(q, kp, vp, bt, cl,
                                            window=window, span=span)
        assert not torch.isnan(o).any() and not torch.isnan(lse).any()
        empty = span[1] <= span[0]
        assert torch.isneginf(lse[empty]).all()
        assert (o[empty] == 0).all()
        outs.append(o)
        lses.append(lse)
    merged = merge_ranges(outs, lses)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert (merged.float() - whole.float()).abs().max() <= tol
    lse = torch.logsumexp(torch.stack(lses), dim=0)
    assert (lse - whole_lse).abs().max() <= F32_TOL * max(
        1.0, float(whole_lse.abs().max()))
    # the whole walk is the plain decode the engine runs without a mesh
    plain = paged_decode_attention(q, kp, vp, bt, cl, window=window)
    assert (plain.float() - whole.float()).abs().max() <= tol


def test_ranges_cover_the_live_positions_in_order():
    cl = torch.tensor([0, 5, 40, 63], dtype=torch.int32)
    for window in (None, 16):
        for n in (2, 3, 4):
            spans = [decode_range(cl, 2, n, r, batch=4, window=window)
                     for r in range(n)]
            lo = (torch.zeros_like(cl) if window is None
                  else torch.clamp(cl - window + 1, min=0))
            assert torch.equal(spans[0][0], lo.int())
            assert torch.equal(spans[-1][1], (cl + 2).int())
            for a, b in zip(spans, spans[1:]):
                assert torch.equal(a[1], b[0])
    one = decode_range(torch.tensor(7), 1, 2, 1, batch=3)
    assert one[0].shape == (3,)
    assert torch.equal(one[1], torch.full((3,), 8, dtype=torch.int32))


@pytest.mark.parametrize("window", [None, 5, 30])
def test_plain_start_combines_with_the_window(window):
    rnd, kp, vp, bt = _pool(torch.float32)
    cl = torch.tensor([3, 17, 30, 47], dtype=torch.int32)
    start = torch.tensor([0, 12, 29, 40], dtype=torch.int32)
    q = rnd(4, 4, 1, 16)
    got, lse = paged_flash_decode_plain(q, kp, vp, bt, cl, window=window,
                                        start=start, return_lse=True)
    k = gather_kv_pages(kp, bt, seq_axis=1)
    v = gather_kv_pages(vp, bt, seq_axis=1)
    lo = start if window is None else torch.maximum(start, cl - window + 1)
    want, want_lse = decode_attention_lse(q, k, v, cl, start=lo)
    assert torch.equal(got, want)
    assert torch.equal(lse, want_lse[:, :, 0])
    assert lse.shape == (4, 4)


@pytest.mark.parametrize("arch,model", REFUSED, ids=REFUSED_IDS)
def test_other_families_refuse_a_model_axis(arch, model):
    cfg = get_reduced(arch)
    with pytest.raises(NotImplementedError, match="A13c"):
        tp.check_serving(cfg, {"data": 1, "model": model})
    tp.check_serving(cfg, {"data": 1, "model": 1})
    with pytest.raises(NotImplementedError, match="A13c"):
        cli.run(["--device", "cpu", "--arch", arch, "--mesh", str(model)])


@pytest.mark.parametrize("arch", GQA_DECODERS)
def test_gqa_decoders_run_any_model_axis(arch):
    cfg = get_reduced(arch)
    assert tp.gqa_decoder(cfg)
    for m in SHARDS:
        tp.check_serving(cfg, {"data": 1, "model": m})


@pytest.mark.parametrize("arch", sorted(EP_DECODERS))
def test_ep_decoders_run_a_dividing_model_axis(arch):
    cfg, full = get_reduced(arch), get_config(arch)
    assert tp.ep_moe_decoder(cfg) and tp.ep_moe_decoder(full)
    assert not tp.gqa_decoder(cfg)
    for m in EP_DECODERS[arch]:
        tp.check_serving(cfg, {"data": 1, "model": m})
        tp.check_serving(full, {"data": 1, "model": m})


@pytest.mark.parametrize("shape", [{"data": 2, "model": 1},
                                   {"data": 2, "model": 2},
                                   {"pod": 2, "data": 1, "model": 2}])
def test_axes_besides_model_refuse(shape):
    with pytest.raises(NotImplementedError, match="A13c"):
        tp.check_serving(get_reduced("qwen2.5-3b"), shape)


class FakeMesh:
    """Axis names and sizes only: the refusals run before any collective."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


@pytest.mark.parametrize("arch,sizes", [
    ("deepseek-v2-236b", dict(data=1, model=8)),
    ("falcon-mamba-7b", dict(data=1, model=4)),
    ("qwen2.5-3b", dict(data=2, model=1))])
def test_engine_construction_refuses(arch, sizes):
    cfg = get_reduced(arch)
    model = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A13c"):
        Engine(model, {}, EngineConfig(max_len=MAX_LEN,
                                       mesh=FakeMesh(**sizes)))


def test_clis_refuse_a_data_axis():
    with pytest.raises(NotImplementedError, match="A13c"):
        cli.run(["--device", "cpu", "--stream", "2", "--mesh", "2x2"])
    with pytest.raises(NotImplementedError, match="A13c"):
        serve_bench.main(["--device", "cpu", "--mesh", "2x1"])
    with pytest.raises(NotImplementedError, match="A13c"):
        serve_bench.main(["--device", "cpu", "--arch", "deepseek-v2-236b",
                          "--mesh", "8"])


def test_engine_wants_a_ranks_shards():
    """A mesh engine handed whole params (the embedding not cut to a
    rank's vocabulary rows) raises before serving."""
    cfg = get_reduced("qwen2.5-3b")
    model = build_model(cfg, device="cpu")
    params = model.init_serving(torch.Generator().manual_seed(0))

    class Split(FakeMesh):
        def coordinate(self, name):
            return 0

    with pytest.raises(ValueError, match="shards"):
        Engine(model, params, EngineConfig(max_len=MAX_LEN,
                                           mesh=Split(data=1, model=2)))
    assert shd.spec_for_param("tok/embed", (cfg.padded_vocab, 64),
                              Split(data=1, model=2))[0] == "model"


def test_engine_wants_a_ranks_experts():
    """A mesh engine handed whole expert leaves (the embedding cut to the
    rank's rows, the experts not) raises before serving: a rank holds
    n_experts / M experts."""
    cfg = get_reduced("qwen3-moe-30b-a3b")
    model = build_model(cfg, device="cpu")
    params = model.init_serving(torch.Generator().manual_seed(0))

    class Split(FakeMesh):
        def coordinate(self, name):
            return 0

    mesh = Split(data=1, model=2)
    table = params["tok"]["embed"]
    params["tok"]["embed"] = shd.local_shard(
        table, shd.spec_for_param("tok/embed", tuple(table.shape), mesh),
        mesh)
    with pytest.raises(ValueError, match="holds 8 experts, a rank.s shard 4"):
        Engine(model, params, EngineConfig(max_len=MAX_LEN, mesh=mesh))


# ----------------------------------------------------------------- the card

#: (label, page_tokens, frontiers, window): chip_smoke's rows 2 (16-token
#: pages), 2a (8-token pages) and 2b (gemma3's window of 1024)
CARD_ROWS = (("row 2", 16, [0, 15, 300, 575], None),
             ("row 2a", 8, [63, 64, 1000, 4099], None),
             ("row 2b", 16, [2048, 2730, 3413, 4095], 1024))


def _card_case(pt, lens, hq=16, hkv=2, d=128, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, p_max = len(lens), -(-(max(lens) + 1) // pt)
    n_pages = b * p_max + 1

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    kp, vp = rnd(n_pages, hkv, pt, d), rnd(n_pages, hkv, pt, d)
    bt = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
          ).reshape(b, p_max).to(torch.int32)
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return rnd(b, hq, 1, d), kp, vp, bt, cl


@pytest.mark.cuda
@pytest.mark.parametrize("row", CARD_ROWS, ids=[r[0] for r in CARD_ROWS])
def test_range_kernel_merges_to_the_whole_walk_on_card(row):
    """The paged kernel over each range of a 2- and 4-way split, merged by
    its log-sum-exp, against the whole walk and the plain version within
    ``BF16_TOL``; each range's lse against the plain version's (1e-3 of
    its size); a range call's output bits equal with and without its lse;
    an empty range zero and -inf. Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.paged_attention import paged_flash_decode
    _, pt, lens, window = row
    q, kp, vp, bt, cl = _card_case(pt, lens)
    whole = paged_flash_decode(q, kp, vp, bt, cl, window=window)
    plain = paged_flash_decode_plain(q, kp, vp, bt, cl, window=window)
    for n in (2, 4):
        outs, lses = [], []
        for r in range(n):
            start, end = decode_range(cl, 1, n, r, batch=len(lens),
                                      window=window)
            o, lse = paged_decode_attention(q, kp, vp, bt, cl,
                                            window=window, span=(start,
                                                                 end))
            po, plse = paged_decode_attention(q, kp, vp, bt, cl,
                                              window=window,
                                              span=(start, end), impl="ref")
            assert (o.float() - po.float()).abs().max() <= BF16_TOL
            live = torch.isfinite(plse)
            assert torch.equal(live, torch.isfinite(lse))
            assert ((lse - plse).abs()[live] <= 1e-3 * plse.abs()[live]
                    .clamp(min=1)).all()
            assert (o[~live[..., 0]] == 0).all()
            front = (torch.minimum(end, cl + 1) - 1).contiguous()
            lo = start if window is None else torch.maximum(
                start, cl - window + 1)
            bare = paged_flash_decode(q, kp, vp, bt, front,
                                      start=lo.to(torch.int32).contiguous())
            assert torch.equal(bare, o)
            outs.append(o)
            lses.append(lse)
        merged = merge_ranges(outs, lses)
        assert (merged.float() - whole.float()).abs().max() <= BF16_TOL
        assert (merged.float() - plain.float()).abs().max() <= BF16_TOL


@pytest.mark.cuda
def test_mesh_world1_equals_one_device_on_card():
    """A serving mesh of one rank (NCCL world 1, every collective over one
    rank) emits the single-device paged stream's tokens and counters bit
    for bit at head_dim 128. Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import mesh as mesh_lib
    cfg = ModelConfig(name="tiny-card", family="dense", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, head_dim=128,
                      d_ff=512, vocab_size=512, qkv_bias=True)
    model = build_model(cfg)
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(2, 512, size=n).astype(np.int32), g)
            for n, g in ((40, 12), (17, 20), (70, 9))]
    pb = sm.kv_bytes_per_token(cfg) * 16
    geom = sm.PageGeometry(page_tokens=16, n_pages=41, n_spill_pages=65,
                           max_pages_per_slot=8, page_bytes=pb)

    def stream(mesh):
        params = model.init_serving(
            torch.Generator(device="cuda").manual_seed(0), mesh=mesh)
        eng = Engine(model, params, EngineConfig(max_len=128, mesh=mesh))
        sch = sm.Scheduler(3, pages=geom)
        rids = [sch.submit(p, g).rid for p, g in reqs]
        rep = eng.serve(scheduler=sch)
        return [rep.outputs[r] for r in rids], {
            k: rep.stats[k] for k in ("host_syncs", "chunks",
                                      "decode_steps", "pages_high_water")}

    one = stream(None)
    with mesh_lib.ranks(1, torch.device("cuda")):
        meshed = stream(mesh_lib.make_host_mesh(1, 1,
                                                device=torch.device("cuda")))
    assert meshed == one
    assert one[1]["host_syncs"] == one[1]["chunks"]
