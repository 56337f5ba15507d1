"""The port's training path against the reference's, on the CPU.

Weights come from the reference's ``Model.init`` through the numpy bridge,
batches from the reference's synthetic pipeline (batch 2, 16 positions;
the frontend model's 16 text tokens follow its stub patches).

* ``Model.loss`` and its gradients against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` (through ``_cast_params_for_compute``, remat on
  in both) for six families: dense GQA, Mamba-1, MoE with GQA, MoE with
  MLA, M-RoPE + frontend stub, enc-dec. The total loss within rtol 2e-4;
  every gradient leaf within 5e-2 of its largest value and 4e-2 in
  relative L2 norm. Measured on the CPU: losses 3.1e-6 to 7.0e-5 apart
  (relative); the worst leaf 3.5e-2 of its largest value (deepseek-v2's
  ``ln2`` scale) and 2.8e-2 in L2 (seamless' encoder ``wk``). Both come
  from bf16 roundings that differ between the frameworks (the gradient
  of every bf16 compute copy is itself bf16). MoE routes are recorded in
  both frameworks and must agree (the test reports a part; a part voids
  the comparison, and none occurs at these seeds).
* jamba-1.5-large-398b's smoke config (8 layers: 7 mamba, GQA at layer
  4, MoE at the odd layers) on the reference's routes
  (``test_torch_model.RouteReplay``, keyed by layer: the recompute of a
  remat'd layer in the backward takes the reference's recompute of that
  layer, which XLA can route otherwise than its forward at a near-tie;
  measured: tokens 16 and 23 of the second MoE layer), and gemma3-27b's
  (8 layers, window 16), each beside its depth controls at 8 layers, the
  controls held at the same tolerances: jamba without experts and
  falcon-mamba-7b's smoke deepened to 8 layers (``HYBRID_TOL``: loss rtol
  4e-4, each gradient leaf within 0.4 of its largest value and 0.3 in
  L2), gemma3 without its window (``DEEP_TOL``: 4e-4, 0.1, 0.08).
  Measured (loss; worst leaf by max share; by L2): jamba 1.75e-4, 0.297
  (layer 1's ``dt_proj``), 0.217; without experts 8.1e-5,
  0.207, 0.102; falcon at 8 layers 8.1e-5, 0.068, 0.068 (at its 2:
  3.1e-6, 0.019, 0.017); gemma3 1.2e-5, 0.049, 0.037; its control
  1.4e-4, 0.037, 0.025. The gap grows with the depth of bf16 backward
  roundings, and most with mamba and MLP layers interleaved: one jamba
  layer of each kind alone holds its input and parameter gradients to
  ``LAYER_GRAD_TOL = 2e-2`` (measured at worst 1.47e-2 and 1.31e-2 in
  L2), so the stack's gap is its depth's, not a fault of a layer.
* Remat on equals remat off bit for bit within the port (loss and every
  gradient): the recomputed forward repeats the same operations (jamba's
  MoE routes too).
* Two microbatches equal one: the loss within rtol 1e-6 (f32 sums in
  another order) and each gradient leaf within 1e-2 of its largest value,
  the bf16 rounding of each microbatch's compute-copy gradient before
  the f32 accumulation. Measured: losses equal, gradients 3.7e-3.
* Three train steps (AdamW, f32 moments) in both packages: the losses
  within rtol 2e-4 each step; the params on average within 2e-4 and each
  within 2.2 x the summed lr. An AdamW update moves an element by about
  lr whatever its gradient's size, so where bf16 noise flips the sign of
  a small gradient the two packages' updates part by up to 2 lr a step.
  Measured: losses 3.7e-5 apart; params 6.9e-5 on average, at most
  1.2e-2 against a summed lr of 7.5e-3. int8 moments are held against
  the reference in ``test_torch_optimizer.py`` on equal gradients: in a
  training run the second moment's block absmax scale flushes small
  entries to 0 while the first moment keeps them, and ``m / (0 + eps)``
  makes the second update explode at the elements that sit on that
  rounding edge, which bf16 noise picks differently in each package
  (qwen2.5-3b's smoke config, lr 3e-3: the third step's gradient norm
  reads 16.6 in the reference and 172.6 in the port, from 2.1 for both
  with f32 moments).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.data.pipeline import DataConfig, SyntheticPipeline
from repro.models import build_model as j_build_model
from repro.models import moe as jmoe
from repro.train import optimizer as jopt
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import _cast_params_for_compute as j_cast
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import TrainConfig, make_train_step, value_and_grad
from test_torch_model import (HYBRID, HYBRID_DENSE, REPLAYED, SSM_DEEP,
                              WINDOW_FREE, RouteReplay, configs)

torch.set_num_threads(1)
ARCHS = ["qwen2.5-3b", "falcon-mamba-7b", "qwen3-moe-30b-a3b",
         "deepseek-v2-236b", "qwen2-vl-2b", "seamless-m4t-medium", HYBRID,
         HYBRID_DENSE, SSM_DEEP, "gemma3-27b", WINDOW_FREE]
LOSS_RTOL = 2e-4
GRAD_MAX_TOL = 5e-2
GRAD_L2_TOL = 4e-2
#: (loss rtol, grad max share, grad L2 share) by depth: the smoke configs'
#: 2 layers above; gemma3's 8 attention layers and its window-free
#: control; jamba's 8 (7 mamba) and its two controls
DEEP_TOL = (4e-4, 1e-1, 8e-2)
HYBRID_TOL = (4e-4, 4e-1, 3e-1)
TOL = {"gemma3-27b": DEEP_TOL, WINDOW_FREE: DEEP_TOL, HYBRID: HYBRID_TOL,
       HYBRID_DENSE: HYBRID_TOL, SSM_DEEP: HYBRID_TOL}
#: one layer's VJP: each input and parameter gradient within this share of
#: its largest value and in relative L2 norm
LAYER_GRAD_TOL = 2e-2


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, batch=2, seq=16, seed=0):
    jcfg, tcfg = configs(arch)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    data = SyntheticPipeline(DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=seq + jcfg.frontend_len,
        global_batch=batch, seed=seed, frontend_len=jcfg.frontend_len,
        d_model=jcfg.d_model, encdec=jcfg.family == "encdec"))
    return jm, jp, build_model(tcfg, device="cpu"), data


@functools.lru_cache(maxsize=1)
def _hybrid_params():
    """The reference's jamba smoke weights (seed 0), made once."""
    return j_build_model(configs(HYBRID)[0]).init(jax.random.PRNGKey(0))


def _batch(np_batch):
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items()})


@pytest.fixture
def routes(monkeypatch):
    """Record every MoE layer's routes in both frameworks; ``parted()``
    returns the tokens the two routers sent to different experts."""
    rec = {"j": [], "t": []}
    j_route, t_route = jmoe._route, tmoe._route

    def jr(w, xt, k):
        out = j_route(w, xt, k)
        jax.debug.callback(lambda i: rec["j"].append(np.asarray(i)), out[1],
                           ordered=True)
        return out

    def tr(w, xt, k):
        out = t_route(w, xt, k)
        rec["t"].append(out[1].detach().numpy())
        return out

    monkeypatch.setattr(jmoe, "_route", jr)
    monkeypatch.setattr(tmoe, "_route", tr)

    def parted():
        jax.effects_barrier()
        assert len(rec["j"]) == len(rec["t"])
        return [int(t) for ji, ti in zip(rec["j"], rec["t"])
                for t in np.nonzero((np.sort(ji, 1) != np.sort(ti, 1))
                                    .any(1))[0]]
    return parted


def _compare_grads(got, want, max_tol=GRAD_MAX_TOL, l2_tol=GRAD_L2_TOL):
    """Each leaf within ``max_tol`` of its largest value and ``l2_tol`` in
    relative L2 norm. Returns the worst of each share."""
    flat_g = jax.tree_util.tree_flatten_with_path(params_to_numpy(got))[0]
    flat_w = jax.tree_util.tree_flatten_with_path(_to_np(want))[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    worst = [0.0, 0.0]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        name = jax.tree_util.keystr(path)
        assert g.dtype == w.dtype == np.float32, name
        w64 = w.astype(np.float64)
        err = np.abs(g - w64)
        share = (err.max() / max(np.abs(w64).max(), 1e-30),
                 np.linalg.norm(err) / max(np.linalg.norm(w64), 1e-30))
        worst = [max(a, b) for a, b in zip(worst, share)]
        assert share[0] <= max_tol, (name, share)
        assert share[1] <= l2_tol, (name, share)
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_the_reference(arch, request, monkeypatch):
    if arch in REPLAYED:
        replay = RouteReplay().install(monkeypatch)
    else:
        routes = request.getfixturevalue("routes")
    loss_rtol, max_tol, l2_tol = TOL.get(arch, (LOSS_RTOL, GRAD_MAX_TOL,
                                                GRAD_L2_TOL))
    jm, jp, tm, data = _setup(arch)
    jb, tb = _batch(data.batch_at(0))

    def loss_fn(p):
        return jm.loss(j_cast(p), jb, remat=True)

    (jl, jmet), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    tl, tmet, tg = value_and_grad(tm, params_from_numpy(_to_np(jp), "cpu"),
                                  tb, remat=True)
    if arch in REPLAYED:
        replay.drain(f"{arch} loss and gradients")
    else:
        parts = routes()
        assert not parts, f"{arch}: routes parted at tokens {parts}"
    rel = abs(float(tl) - float(jl)) / abs(float(jl))
    assert rel <= loss_rtol, rel
    assert float(tmet["tokens"]) == float(jmet["tokens"])
    np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]),
                               rtol=1e-3, atol=1e-6)
    worst = _compare_grads(tg, jg, max_tol, l2_tol)
    print(f"{arch}: loss {rel:.2e} apart (relative); gradients at worst "
          f"{worst[0]:.2e} of a leaf's largest value, {worst[1]:.2e} in L2")


@pytest.mark.parametrize("pos", ["pos0", "pos1", "pos4"],
                         ids=["mamba-mlp", "mamba-moe", "gqa-mlp"])
def test_hybrid_layer_gradients_equal_the_reference(pos, monkeypatch):
    """One jamba layer of each kind (its ``blocks`` group: mamba + MLP,
    mamba + MoE on the reference's routes, GQA + MLP), the reference's
    weights through the compute cast, 2 x 16 bf16 inputs and a bf16
    cotangent: the input gradient and every parameter gradient within
    ``LAYER_GRAD_TOL`` of its largest value and in relative L2 norm.
    Measured: at worst 1.47e-2 and 1.31e-2 (the mamba + MoE layer's
    ``dt_bias`` and ``x_proj``). A layer's backward holds to bf16 noise,
    so the whole stack's larger gap (``HYBRID_TOL``) is its depth's."""
    import repro.models.transformer as jt
    from repro_torch.models import transformer
    from repro_torch.train.loop import _cast_params_for_compute as t_cast
    replay = RouteReplay().install(monkeypatch)
    jcfg, tcfg = configs(HYBRID)
    kind = tcfg.layer_groups()[0].pattern[int(pos[3:])]
    jp = jax.tree.map(lambda a: a[0],
                      _hybrid_params()["groups"]["blocks"][pos])
    rng = np.random.RandomState(4)
    x, ct = (np.asarray(jnp.asarray(rng.randn(2, 16, tcfg.d_model),
                                    jnp.bfloat16).astype(jnp.float32))
             for _ in range(2))
    positions = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))

    def j_layer(p, xx):
        return jt._apply_layer(jcfg, kind, j_cast(p), xx,
                               positions=jnp.asarray(positions),
                               positions3=None, cache=None,
                               cache_len=None)[0]

    _, vjp = jax.vjp(j_layer, jp, jnp.asarray(x, jnp.bfloat16))
    jgp, jgx = vjp(jnp.asarray(ct, jnp.bfloat16))
    tp = topt.tree_map(lambda a: a.requires_grad_(True),
                       params_from_numpy(_to_np(jp), "cpu"))
    xt = torch.tensor(x, dtype=torch.bfloat16, requires_grad=True)
    y, _ = transformer._apply_layer(tcfg, kind, t_cast(tp), xt,
                                    positions=torch.tensor(positions),
                                    cache=None, cache_len=None)
    y.backward(torch.tensor(ct, dtype=torch.bfloat16))
    replay.drain(f"jamba {pos}")
    gx, want = xt.grad.double().numpy(), np.asarray(jgx, np.float64)
    assert np.abs(gx - want).max() <= LAYER_GRAD_TOL * np.abs(want).max()
    worst = _compare_grads(topt.tree_map(lambda a: a.grad, tp), jgp,
                           LAYER_GRAD_TOL, LAYER_GRAD_TOL)
    print(f"jamba {pos}: gradients at worst {worst[0]:.2e} of a leaf's "
          f"largest value, {worst[1]:.2e} in L2")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "falcon-mamba-7b",
                                  "qwen3-moe-30b-a3b", "seamless-m4t-medium",
                                  HYBRID])
def test_remat_is_bit_for_bit_within_the_port(arch):
    _, jp, tm, data = _setup(arch)
    _, tb = _batch(data.batch_at(1))
    params = params_from_numpy(_to_np(jp), "cpu")
    on = value_and_grad(tm, params, tb, remat=True)
    off = value_and_grad(tm, params, tb, remat=False)
    assert torch.equal(on[0], off[0])
    for a, b in zip(topt.tree_leaves(on[2]), topt.tree_leaves(off[2])):
        assert torch.equal(a, b)


def test_two_microbatches_equal_one(monkeypatch):
    _, jp, tm, data = _setup("qwen2.5-3b", batch=4)
    _, tb = _batch(data.batch_at(2))
    opt = topt.OptConfig(peak_lr=3e-3, warmup_steps=1)
    seen = []

    def capture(p, g, s, cfg, update=topt.adamw_update):
        seen.append(g)                  # the averaged gradients
        return update(p, g, s, cfg)

    monkeypatch.setattr(topt, "adamw_update", capture)
    out = {}
    for n in (1, 2):
        params = params_from_numpy(_to_np(jp), "cpu")
        step = make_train_step(tm, TrainConfig(opt=opt, n_microbatches=n))
        _, _, metrics = step(params, topt.init_opt_state(params, opt), tb)
        out[n] = (metrics["total_loss"], seen.pop())
    np.testing.assert_allclose(float(out[2][0]), float(out[1][0]), rtol=1e-6)
    for a, b in zip(topt.tree_leaves(out[2][1]), topt.tree_leaves(out[1][1])):
        assert (a - b).abs().max() <= 1e-2 * b.abs().max()


def test_three_train_steps_equal_the_reference():
    jm, jp, tm, data = _setup("qwen2.5-3b", batch=4)
    kw = dict(peak_lr=3e-3, warmup_steps=2, decay_steps=100)
    j_step = jax.jit(j_make_train_step(jm, JTrainConfig(
        opt=jopt.OptConfig(**kw))))
    t_step = make_train_step(tm, TrainConfig(opt=topt.OptConfig(**kw)))
    js = jopt.init_opt_state(jp, jopt.OptConfig(**kw))
    tp = params_from_numpy(_to_np(jp), "cpu")
    ts = topt.init_opt_state(tp, topt.OptConfig(**kw))
    lr_sum = 0.0
    for i in range(3):
        jb, tb = _batch(data.batch_at(i))
        jp, js, jmet = j_step(jp, js, jb)
        tp, ts, tmet = t_step(tp, ts, tb)
        np.testing.assert_allclose(float(tmet["total_loss"]),
                                   float(jmet["total_loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                                   rtol=2e-7)
        lr_sum += float(jmet["lr"])
    assert int(ts["step"]) == 3
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
        jax.tree.leaves(params_to_numpy(tp)), jax.tree.leaves(_to_np(jp)))])
    assert diff.max() <= 2.2 * lr_sum and diff.mean() <= 2e-4


def test_cast_for_compute_follows_the_reference_rule():
    """The compute copy casts exactly the leaves the reference casts:
    f32 leaves of 2-D and above, but not the names in
    ``_F32_PARAM_NAMES`` (mamba's ``a_log`` and ``dt_bias`` stay f32;
    its stacked ``ssm_d``, being 2-D, does not)."""
    from repro_torch.train.loop import _cast_params_for_compute
    for arch in ("falcon-mamba-7b", "qwen3-moe-30b-a3b"):
        jp = j_build_model(j_get_reduced(arch)).init(jax.random.PRNGKey(0))
        want = jax.tree_util.tree_flatten_with_path(j_cast(jp))[0]
        got = _cast_params_for_compute(params_from_numpy(_to_np(jp), "cpu"))
        got = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in got] == [p for p, _ in want]
        names = [(jax.tree_util.keystr(p), str(g.dtype).removeprefix(
            "torch."), str(w.dtype)) for (p, g), (_, w) in zip(got, want)]
        assert all(g == w for _, g, w in names), names
        assert ("['groups']['blocks']['pos0']['mamba']['ssm_d']", "bfloat16",
                "bfloat16") in names or arch != "falcon-mamba-7b"
