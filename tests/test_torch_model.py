"""The port's models (dense GQA, MoE with GQA or MLA, the hybrid
attention + mamba + MoE stack) against the JAX package, on the CPU.

Weights come from the reference's ``Model.init`` through the numpy bridge,
inputs from numpy seeds. Layers compare in bf16 at ``rtol = 1.6e-2`` (1-2
bf16 ulp: the two frameworks round bf16 at different places). Whole
models compare f32 logits: prefill plus 16 teacher-forced decode steps
over the dense slab and over the paged pool, within ``LOGIT_TOL = 1e-2``.
Measured on the CPU: max |dlogit| 8.6e-3 (mistral-nemo-12b, paged decode;
prefill 4-6e-3, logits up to ~0.5). It comes from bf16 roundings that
differ between the frameworks, SiLU above all: XLA's bf16 SiLU and
PyTorch's differ in the last bit of about a third of their outputs.
Wherever the reference's top-2 margin exceeds 2e-2, the argmax
must agree.

That 1e-2 was measured at the smoke configs' 2 layers; bf16 noise grows
with depth. ``gemma3-27b``'s smoke config has 8 layers (window 16, 5:1
local:global; the decode steps run past the window, so both the slab's
mask and the page walk's ``cache_len - window`` mask cut positions off),
and it is held at ``DEEP_LOGIT_TOL = 2e-2`` beside its depth control, the
same network without the window (``gemma3-27b-nowindow``), at the same
tolerance. Measured on the CPU: gemma3 1.20e-2 (prefill + dense decode)
and 1.01e-2 (paged); the control 1.03e-2 and 1.24e-2. The window adds
nothing the depth does not.

``jamba-1.5-large-398b``'s smoke config (8 layers: GQA at layer 4, mamba
at the other seven, MoE with 4 experts top-2 at the odd layers) runs on
the reference's routes (:class:`RouteReplay`): its own router parts from
the reference's at margins above ``ROUTE_TIE`` (measured: 1.97e-3,
4.52e-3 and 1.96e-2 in the dense test's prefill; 1.07e-2, 2.00e-3 and
1.95e-4 in the paged test's), and a parted token takes other experts
through the rest of the stack. It is held at ``HYBRID_LOGIT_TOL = 5e-2``
beside two 8-layer depth controls without MoE, at the same tolerance:
the same network without experts (``jamba-1.5-large-398b-noexperts``)
and falcon-mamba-7b's smoke config deepened from 2 to 8 layers
(``falcon-mamba-7b-8layers``, no attention). Measured on the CPU
(prefill + dense decode / paged): jamba 3.10e-2 / 2.85e-2, without
experts 4.04e-2 / 3.23e-2, falcon at 8 layers 3.00e-2 / 2.45e-2 (7.0e-3
at its 2 layers). Each of jamba's three layer kinds alone holds to
``BF16_RTOL`` (max |dy| 3.1e-2 at |y| up to 5.1: 1-2 bf16 ulp): the gap
is the mamba stack's depth, not a fault of the port.

MoE models (qwen3-moe-30b-a3b, deepseek-v2-236b) route every token in both
frameworks; the routes are recorded (the reference's through
``jax.debug.callback``) and must name the same experts. Where they part,
the reference's margin between its k-th and (k+1)-th expert probability
must be under ``ROUTE_TIE = 1e-2`` (the bf16 roundings that differ between
the frameworks move a router probability by up to ~1e-3; measured: a part
at margin 6.7e-4, qwen3-moe paged decode), and the rows holding a parted
token are left out of that step's logit check: their MoE output takes
another expert. The test reports each part; it never re-seeds to avoid
one.
"""

import collections
import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import build_model as j_build_model
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro_torch.configs import get_reduced
from repro_torch.models import build_model, layers, transformer
from repro_torch.models import moe as tmoe
from repro_torch.models.bridge import params_from_numpy, params_to_numpy

torch.set_num_threads(1)
LOGIT_TOL = 1e-2
MARGIN = 2e-2
BF16_RTOL = 1.6e-2
ROUTE_TIE = 1e-2
#: gemma3-27b's smoke config (8 layers, window 16, 5:1 local:global) and
#: the same network without its window, the depth control
WINDOW_FREE = "gemma3-27b-nowindow"
#: jamba-1.5-large-398b's smoke config (8 layers: GQA at 4, mamba elsewhere,
#: MoE at the odd layers) and its two depth controls: the same network
#: without experts, and falcon-mamba-7b's smoke config deepened to 8 layers
HYBRID = "jamba-1.5-large-398b"
HYBRID_DENSE = "jamba-1.5-large-398b-noexperts"
SSM_DEEP = "falcon-mamba-7b-8layers"
#: each control: (the arch it cuts, the fields it replaces)
CONTROLS = {WINDOW_FREE: ("gemma3-27b", dict(window=None)),
            HYBRID_DENSE: (HYBRID, dict(n_experts=0)),
            SSM_DEEP: ("falcon-mamba-7b", dict(n_layers=8))}
ARCHS = ["qwen2.5-3b", "yi-6b", "mistral-nemo-12b", "qwen3-moe-30b-a3b",
         "deepseek-v2-236b", "gemma3-27b", WINDOW_FREE, HYBRID, HYBRID_DENSE,
         SSM_DEEP]
#: the archs run on the reference's routes (RouteReplay), not held to them
REPLAYED = {HYBRID}
#: logit tolerance by depth: the smoke configs' 2 layers, gemma3's 8
DEEP_LOGIT_TOL = 2e-2
HYBRID_LOGIT_TOL = 5e-2
TOL = {WINDOW_FREE: DEEP_LOGIT_TOL, "gemma3-27b": DEEP_LOGIT_TOL,
       HYBRID: HYBRID_LOGIT_TOL, HYBRID_DENSE: HYBRID_LOGIT_TOL,
       SSM_DEEP: HYBRID_LOGIT_TOL}


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def configs(arch):
    """(the reference's config, the port's) of an arch or a control."""
    base, fields = CONTROLS.get(arch, (arch, {}))
    return (dataclasses.replace(j_get_reduced(base), **fields),
            dataclasses.replace(get_reduced(base), **fields))


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) per arch, built once."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = configs(arch)
        jm = j_build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(tcfg, device="cpu")
        out[arch] = (jm, jp, tm, params_from_numpy(_to_np(jp), "cpu"))
    return out


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _close_bf16(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=BF16_RTOL,
                               atol=BF16_RTOL)


# ------------------------------------------------------------------ bridge

def test_bridge_round_trip_and_tree_parity(pair):
    """The reference's params load by a plain tree map: same keys, same
    shapes, no transposes — and the port's own init makes the same tree."""
    _, jp, tm, tp = pair["qwen2.5-3b"]
    jnp_tree = _to_np(jp)
    back = params_to_numpy(tp)
    flat_j = jax.tree_util.tree_flatten_with_path(jnp_tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(a, b)
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jnp_tree)
    assert jax.tree.map(lambda a: tuple(a.shape), params_to_numpy(own)) \
        == shapes


# ------------------------------------------------------------------ layers

def test_rmsnorm_linear_mlp_match_jax():
    rng = np.random.RandomState(0)
    x = _bf16(rng.randn(2, 5, 64))
    w, b = rng.randn(64, 48).astype(np.float32), rng.randn(48).astype(
        np.float32)
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = _t(x, torch.bfloat16)
    _close_bf16(layers.rmsnorm({"scale": _t(scale)}, xt),
                jl.rmsnorm({"scale": jnp.asarray(scale)}, xb).astype(
                    jnp.float32))
    _close_bf16(layers.linear(xt, _t(w), _t(b)),
                jl.linear(xb, jnp.asarray(w), jnp.asarray(b)).astype(
                    jnp.float32))
    mp = {"w_gate": rng.randn(64, 96).astype(np.float32) / 8,
          "w_up": rng.randn(64, 96).astype(np.float32) / 8,
          "w_down": rng.randn(96, 64).astype(np.float32) / 10}
    _close_bf16(layers.mlp({k: _t(v) for k, v in mp.items()}, xt),
                jl.mlp({k: jnp.asarray(v) for k, v in mp.items()}, xb)
                .astype(jnp.float32))


@pytest.mark.parametrize("pos", ["pos0", "pos1", "pos4"],
                         ids=["mamba-mlp", "mamba-moe", "gqa-mlp"])
def test_hybrid_layer_kinds_match_jax(pair, pos, replay):
    """Each of jamba's three layer kinds alone, with the reference's
    weights (its ``blocks`` group: mamba + MLP at pos0, mamba + MoE at
    pos1, GQA + MLP at pos4), on the same bf16 input at ``BF16_RTOL``; the
    MoE layer on the reference's routes, its aux loss within 1e-5. One
    layer holds to 1-2 bf16 ulp: the whole model's larger gap
    (``HYBRID_LOGIT_TOL``) is its depth's."""
    import repro.models.transformer as jt
    jm, jp, tm, tp = pair[HYBRID]
    kind = tm.cfg.layer_groups()[0].pattern[int(pos[3:])]
    assert (kind.attn, kind.mlp) == {"pos0": ("mamba", "mlp"),
                                     "pos1": ("mamba", "moe"),
                                     "pos4": ("gqa", "mlp")}[pos]
    rng = np.random.RandomState(4)
    x = _bf16(rng.randn(2, 9, tm.cfg.d_model))
    positions = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    layer = jax.tree.map(lambda a: a[0], jp["groups"]["blocks"][pos])
    jy, jaux, _ = jt._apply_layer(
        jm.cfg, kind, layer, jnp.asarray(x, jnp.bfloat16),
        positions=jnp.asarray(positions), positions3=None, cache=None,
        cache_len=None)
    ty, taux = transformer._apply_layer(
        tm.cfg, kind, transformer._index(tp["groups"]["blocks"][pos], 0),
        _t(x, torch.bfloat16), positions=_t(positions), cache=None,
        cache_len=None)
    replay(2, f"jamba {pos}")
    assert ty.dtype == torch.bfloat16
    want = np.asarray(jy, np.float32)
    err = np.abs(ty.float().numpy() - want).max()
    print(f"jamba {pos}: max |dy| {err:.3e} of max |y| "
          f"{np.abs(want).max():.3e}")
    _close_bf16(ty, want)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-7)


def test_embed_unembed_rope_match_jax():
    rng = np.random.RandomState(1)
    table = (rng.randn(256, 32) * 0.02).astype(np.float32)
    toks = rng.randint(0, 256, size=(2, 7)).astype(np.int32)
    tp, jp = {"embed": _t(table)}, {"embed": jnp.asarray(table)}
    emb = layers.embed(tp, _t(toks))
    _close_bf16(emb, jl.embed(jp, jnp.asarray(toks)).astype(jnp.float32))
    x = _bf16(rng.randn(2, 7, 32))
    logits = layers.unembed_logits(tp, _t(x, torch.bfloat16))
    assert logits.dtype == torch.float32            # f32 logits, never bf16
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jl.unembed_logits(
            jp, jnp.asarray(x, jnp.bfloat16))), rtol=1e-5, atol=1e-6)
    q = _bf16(rng.randn(2, 4, 7, 16))
    pos = rng.randint(0, 500, size=(2, 7)).astype(np.int32)
    _close_bf16(layers.apply_rope(_t(q, torch.bfloat16), _t(pos), 1e6),
                jl.apply_rope(jnp.asarray(q, jnp.bfloat16), jnp.asarray(pos),
                              1e6).astype(jnp.float32))


# ----------------------------------------------------------- whole models

@pytest.fixture
def routing(monkeypatch):
    """Record every MoE layer's routing in both frameworks, in call order.
    Returns ``parted(n_rows, what)``: the batch rows holding a token the
    two routers sent to different experts since the last call, after
    asserting that each part is a near-tie of the reference's router."""
    rec = {"j": [], "t": []}
    j_route, t_route = jmoe._route, tmoe._route

    def jr(w, xt, k):
        out = j_route(w, xt, k)
        jax.debug.callback(lambda i, p: rec["j"].append(
            (np.asarray(i), np.asarray(p))), out[1], out[2], ordered=True)
        return out

    def tr(w, xt, k):
        out = t_route(w, xt, k)
        rec["t"].append((out[1].numpy(), out[2].numpy()))
        return out

    monkeypatch.setattr(jmoe, "_route", jr)
    monkeypatch.setattr(tmoe, "_route", tr)

    def parted(n_rows, what):
        jax.effects_barrier()
        assert len(rec["j"]) == len(rec["t"]), what
        rows = set()
        for (ji, jp), (ti, _) in zip(rec["j"], rec["t"]):
            k = ji.shape[1]
            top = np.sort(jp, axis=1)[:, ::-1]
            for tok in np.nonzero((np.sort(ji, 1) != np.sort(ti, 1))
                                  .any(1))[0]:
                margin = top[tok, k - 1] - top[tok, k]
                print(f"{what}: token {tok} routed apart at margin "
                      f"{margin:.2e}")
                assert margin < ROUTE_TIE, (what, tok, margin)
                rows.add(int(tok) * n_rows // ji.shape[0])
        rec["j"].clear()
        rec["t"].clear()
        return rows

    return parted


class RouteReplay:
    """The reference's MoE routes, replayed in the port.

    :meth:`install` wraps both packages' ``moe._route``. The reference's
    records each call's ``idx`` and ``probs`` (an ordered
    ``jax.debug.callback``) under its layer, known by the bytes of the
    layer's f32 router weights, which the bridge hands the port unchanged.
    The port's computes its own router probabilities and takes the
    reference's ``idx`` of the same layer's call of the same rank (its
    n-th call of a layer takes the reference's n-th), in the reference's
    order of the k experts, which the grouped MoE's capacity cut ranks
    hits by; the gates are its own probabilities at those experts,
    renormalised as ``_route`` does. Keyed by layer, a remat'd layer's
    recompute in the backward takes the reference's recompute of that
    layer, whatever order the two backwards walk the layers in (XLA's
    recompute can route a near-tie otherwise than its own forward did).

    Each token the port's own top-k would have sent elsewhere is printed
    with the reference's margin between its k-th and (k+1)-th probability
    and kept in ``margins``; nothing re-seeds. :meth:`drain` asserts that
    the two packages' calls lined up one to one, in count and in rows.
    """

    def __init__(self):
        self.ref = collections.defaultdict(list)     # layer -> [(idx, probs)]
        self.used = collections.Counter()
        self.margins = []

    @staticmethod
    def _layer(w) -> bytes:
        return hashlib.sha1(np.ascontiguousarray(w, np.float32)
                            .tobytes()).digest()

    def install(self, monkeypatch):
        j_route, t_route = jmoe._route, tmoe._route

        def jr(w, xt, k):
            out = j_route(w, xt, k)
            jax.debug.callback(self._record, w, out[1], out[2], ordered=True)
            return out

        monkeypatch.setattr(jmoe, "_route", jr)
        monkeypatch.setattr(tmoe, "_route", functools.partial(
            self._replay, t_route))
        return self

    def _record(self, w, idx, probs):
        self.ref[self._layer(np.asarray(w))].append(
            (np.asarray(idx), np.asarray(probs)))

    def _replay(self, t_route, w, xt, k):
        _, own, probs = t_route(w, xt, k)
        jax.effects_barrier()
        key = self._layer(w.detach().float().numpy())
        calls, n = self.ref.get(key, []), self.used[key]
        assert n < len(calls), "the port made a MoE call the reference did not"
        self.used[key] += 1
        idx, ref_probs = calls[n]
        assert idx.shape == tuple(own.shape), (idx.shape, tuple(own.shape))
        idx_t = torch.from_numpy(idx.astype(np.int64))
        gates = torch.gather(probs, -1, idx_t)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        top = np.sort(ref_probs, axis=1)[:, ::-1]
        for tok in np.nonzero((np.sort(idx, 1) != np.sort(own.numpy(), 1))
                              .any(1))[0]:
            margin = float(top[tok, k - 1] - top[tok, k])
            print(f"the port's router would route token {tok} apart at "
                  f"margin {margin:.2e}")
            self.margins.append(margin)
        return gates, idx_t, probs

    def drain(self, what):
        """Assert every recorded call was replayed once; forget them."""
        jax.effects_barrier()
        for key, calls in self.ref.items():
            assert self.used[key] == len(calls), (what, self.used[key],
                                                  len(calls))
        assert set(self.used) <= set(self.ref), what
        self.ref.clear()
        self.used.clear()


@pytest.fixture
def replay(monkeypatch):
    """A :class:`RouteReplay` installed for the test. Returns ``parted(
    n_rows, what)`` in :func:`routing`'s form: it drains the replay and
    returns the empty set, since no row takes other experts."""
    rep = RouteReplay().install(monkeypatch)

    def parted(n_rows, what):
        rep.drain(what)
        return set()
    return parted


def _routes(request, arch):
    """The route check of ``arch``: replayed or held (``REPLAYED``)."""
    return request.getfixturevalue("replay" if arch in REPLAYED
                                   else "routing")


def _check_logits(got, want, what, skip_rows=(), tol=LOGIT_TOL):
    """Holds the rows not in ``skip_rows`` (at least one must be left)."""
    keep = [r for r in range(got.shape[0]) if r not in skip_rows]
    assert keep, f"{what}: every row parted, no logits left to compare"
    got = got.numpy().astype(np.float64)[keep]
    want = np.asarray(want, np.float64)[keep]
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max |dlogit| {err:.3e}"
    flat_j = want.reshape(-1, want.shape[-1])
    flat_t = got.reshape(-1, got.shape[-1])
    top2 = np.sort(flat_j, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > MARGIN
    assert (flat_t.argmax(-1) == flat_j.argmax(-1))[decided].all(), what
    return err


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_dense_decode_match_jax(pair, arch, request):
    """Prefill logits, then 16 teacher-forced decode steps over the dense
    slab (0-d cache_len, the one-shot generate path)."""
    routing = _routes(request, arch)
    jm, jp, tm, tp = pair[arch]
    cfg = tm.cfg
    rng = np.random.RandomState(2)
    b, s, steps, max_len = 2, 9, 16, 32
    prompt = rng.randint(2, cfg.vocab_size, size=(b, s)).astype(np.int32)
    forced = rng.randint(2, cfg.vocab_size, size=(steps, b)).astype(np.int32)
    j_decode = jax.jit(jm.decode_step)
    tol = TOL.get(arch, LOGIT_TOL)
    jl_, jstate = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, max_len)
    tl_, tstate = tm.prefill(tp, {"tokens": _t(prompt)}, max_len)
    parted = routing(b, f"{arch} prefill")
    worst = _check_logits(tl_, jl_, f"{arch} prefill", parted, tol)
    for i in range(steps):
        jl_, jstate = j_decode(jp, jnp.asarray(forced[i])[:, None], jstate,
                               jnp.asarray(s + i, jnp.int32))
        tl_, tstate = tm.decode_step(tp, _t(forced[i])[:, None], tstate,
                                     torch.tensor(s + i, dtype=torch.int32))
        what = f"{arch} dense decode step {i}"
        # a row parted in prefill attends over its other K/V from then on
        worst = max(worst, _check_logits(tl_, jl_, what,
                                         parted | routing(b, what), tol))
    print(f"{arch} prefill + dense decode: max |dlogit| {worst:.3e}")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_jax(pair, arch, request):
    """Two prompts of different lengths prefilled one at a time, cut into
    pages at shuffled block-table rows, then 16 teacher-forced decode steps
    over the paged pool with per-slot frontiers."""
    routing = _routes(request, arch)
    jm, jp, tm, tp = pair[arch]
    cfg = tm.cfg
    rng = np.random.RandomState(3)
    pt, p_max, n_pages, steps = 8, 4, 10, 16
    depth = pt * p_max
    lens = [5, 11]
    bt = np.asarray([[3, 7, 1, 9], [2, 8, 5, 4]], np.int32)
    forced = rng.randint(2, cfg.vocab_size, size=(steps, 2)).astype(np.int32)
    import repro.models.transformer as jt
    jpool = {"caches": jt.init_paged_caches(jm.cfg, 2, n_pages, pt)}
    parted = set()
    tol, worst = TOL.get(arch, LOGIT_TOL), 0.0
    tpool = {"caches": transformer.init_paged_caches(cfg, 2, n_pages, pt,
                                                     "cpu")}
    for slot, n in enumerate(lens):
        prompt = rng.randint(2, cfg.vocab_size, size=(1, n)).astype(np.int32)
        last = np.asarray([n - 1], np.int32)
        jl_, jrow = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, depth,
                               last_pos=jnp.asarray(last))
        tl_, trow = tm.prefill(tp, {"tokens": _t(prompt)}, depth,
                               last_pos=_t(last))
        what = f"{arch} paged admission {slot}"
        if routing(1, what):
            parted.add(slot)
        worst = max(worst, _check_logits(tl_, jl_, what, parted, tol))
        jpool = jm.slot_update_paged(jpool, jrow, jnp.asarray(slot),
                                     jnp.asarray(bt[slot]), pt)
        tpool = tm.slot_update_paged(tpool, trow, slot, _t(bt[slot]), pt)
    cache_len = np.asarray(lens, np.int32)
    j_decode = jax.jit(jm.decode_step)
    for i in range(steps):
        jl_, jpool = j_decode(jp, jnp.asarray(forced[i])[:, None], jpool,
                              jnp.asarray(cache_len),
                              block_tables=jnp.asarray(bt))
        tl_, tpool = tm.decode_step(tp, _t(forced[i])[:, None], tpool,
                                    _t(cache_len), block_tables=_t(bt))
        what = f"{arch} paged decode step {i}"
        worst = max(worst, _check_logits(tl_, jl_, what,
                                         parted | routing(2, what), tol))
        cache_len = cache_len + 1
    print(f"{arch} paged decode: max |dlogit| {worst:.3e}")


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_moe_loss_and_aux_match_jax(pair, arch, routing):
    """``Model.loss`` on the same routes: the LM loss within 1e-3 relative,
    the router aux loss (summed over the MoE layers) within 2e-3 relative,
    and the total ``loss + router_aux_weight * aux`` within 1e-3. The aux
    loss is the mean router probability per expert times its hit share:
    the probabilities come from hidden states that differ by bf16 ulps
    between the frameworks (measured: 3.9e-4 relative, deepseek-v2)."""
    jm, jp, tm, tp = pair[arch]
    rng = np.random.RandomState(5)
    toks = rng.randint(2, tm.cfg.vocab_size, size=(2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jtot, jd = jm.loss(jp, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels)})
    ttot, td = tm.loss(tp, {"tokens": _t(toks).int(),
                            "labels": _t(labels).int()})
    assert not routing(2, f"{arch} loss")
    assert float(td["aux"]) > 0
    np.testing.assert_allclose(float(td["aux"]), float(jd["aux"]), rtol=2e-3)
    np.testing.assert_allclose(float(td["loss"]), float(jd["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-3)
    assert float(td["tokens"]) == float(jd["tokens"])


def test_unported_families_raise():
    """Every family the reference serves is admitted on both devices: the
    hybrid (jamba) builds on the CPU and passes the gate on the card
    (checked on the device alone, so without a card; ROADMAP A9b brought
    its serving copy there). M-RoPE with its frontend (qwen2-vl) and the
    encoder-decoder (seamless) build. A family the port does not know
    still raises."""
    cfg = get_reduced("jamba-1.5-large-398b")
    assert build_model(cfg, device="cpu").cfg.name == cfg.name
    transformer.check_supported(cfg, torch.device("cuda"))
    transformer.check_supported(cfg, "cuda:0")
    for arch in ("qwen2-vl-2b", "seamless-m4t-medium"):
        assert build_model(get_reduced(arch), device="cpu").cfg.name \
            == get_reduced(arch).name
    with pytest.raises(NotImplementedError, match="is not ported"):
        transformer.check_supported(dataclasses.replace(cfg, family="rnn"),
                                    "cuda")
