"""Training on more than one rank: the port's ``distributed/`` and its
sharded train steps on a gloo world of 2, against the reference and the
port's single-process step.

One spawn of two ranks (``launch.mesh.spawn``, ``torch.set_num_threads(1)``
in each) runs ``tests/torch_dist_ranks.py``, which imports only
``repro_torch``; the reference is computed here, in the test process, on the
same numpy inputs. The counterpart of ``tests/dist_checks.py:94-210``.

Tolerances:

* ``compressed_psum_mean`` and ``compressed_grad_sync`` against the
  reference run under ``jax.vmap(..., axis_name="pod")``: the int8 codes
  equal, the means and residuals within ``PSUM_RTOL`` = 1e-6 of the
  tensor's absmax (measured: 0, bit for bit; the reference's division by
  the scale is not turned into a reciprocal multiply outside ``jit``).
* The sharded step at 1x2 and 2x1 against the port's single-process step
  and the reference's: the loss within ``LOSS_RTOL`` = 2e-4 (the port's
  loss tolerance against the reference, ``test_torch_train.py``;
  measured 0 against the port's step, 6.9e-6 against the reference's);
  the params after the step within ``test_torch_train``'s rule (the
  largest difference at most 2.2 x the summed learning rates, the mean at
  most ``PARAM_MEAN_TOL`` = 2e-4): each rank's bf16 gradient of its half
  of the batch, averaged in f32, against one bf16 gradient of the whole
  can flip the sign of Adam's first update where a gradient is near 0
  (measured at 2x1: largest 1.5e-3, one such flip at lr 1.5e-3, mean
  9.4e-7; at 1x2 largest 3e-8; with int8 moments over two steps largest
  8.7e-5).
* qwen3-moe's REDUCED aux loss at ``data`` 2 against the single-process
  one on the whole batch: ``AUX_RTOL`` = 1e-5 (f32 means of equal halves
  averaged; measured 0).
* Save at 1x2, restore at 2x1: every leaf bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.data.pipeline import DataConfig, SyntheticPipeline
from repro.distributed import collectives as jcol
from repro.models import build_model as j_build_model
from repro.train import optimizer as jopt
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import TrainConfig, make_train_step

import torch_dist_ranks

PSUM_RTOL = 1e-6
LOSS_RTOL = 2e-4
PARAM_MEAN_TOL = 2e-4
AUX_RTOL = 1e-5
OPT = {"peak_lr": 3e-3, "warmup_steps": 2, "decay_steps": 100}
ARCHS = ("qwen2.5-3b", "qwen3-moe-30b-a3b")
ROUNDS = 16


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    out = {"opt": OPT, "rounds": ROUNDS,
           "psum_g": rng.standard_normal((2, 64)).astype(np.float32)}
    for arch in ARCHS:
        cfg = j_get_reduced(arch)
        out[f"{arch}/params"] = _to_np(
            j_build_model(cfg).init(jax.random.PRNGKey(0)))
        out[f"{arch}/batch"] = SyntheticPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
            seed=0)).batch_at(0)
    return out


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Both ranks' results (the one spawn of this file)."""
    out = tmp_path_factory.mktemp("ranks")
    path = os.path.join(out, "inputs.pt")
    torch.save(inputs, path)
    mesh_lib.spawn(torch_dist_ranks.main, 2, torch.device("cpu"),
                   args=(path, str(out)))
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


def _single(arch, inputs, steps, quantized=False):
    """The port's single-process steps: losses, aux and params."""
    model = build_model(get_reduced(arch), device="cpu")
    tcfg = TrainConfig(opt=topt.OptConfig(**OPT,
                                          quantized_moments=quantized))
    params = params_from_numpy(inputs[f"{arch}/params"], "cpu")
    state = topt.init_opt_state(params, tcfg.opt)
    step = make_train_step(model, tcfg)
    batch = {k: torch.from_numpy(v) for k, v in
             inputs[f"{arch}/batch"].items()}
    losses = []
    for _ in range(steps):
        params, state, m = step(params, state, batch)
        losses.append(float(m["total_loss"]))
    return losses, float(m["aux"]), params_to_numpy(params)


def _reference(arch, inputs):
    cfg = j_get_reduced(arch)
    step = jax.jit(j_make_train_step(j_build_model(cfg), JTrainConfig(
        opt=jopt.OptConfig(**OPT))))
    params = jax.tree.map(jnp.asarray, inputs[f"{arch}/params"])
    state = jopt.init_opt_state(params, jopt.OptConfig(**OPT))
    batch = {k: jnp.asarray(v) for k, v in inputs[f"{arch}/batch"].items()}
    params, _, m = step(params, state, batch)
    return float(m["total_loss"]), _to_np(params)


def _params_close(got, want, lr_sum):
    diff = np.concatenate([np.abs(np.asarray(a) - np.asarray(b)).ravel()
                           for a, b in zip(jax.tree.leaves(got),
                                           jax.tree.leaves(want))])
    assert diff.max() <= 2.2 * lr_sum and diff.mean() <= PARAM_MEAN_TOL


def _lr(step):
    return float(topt.lr_schedule(topt.OptConfig(**OPT), torch.tensor(step)))


def test_compressed_psum_mean_equals_the_reference(ranks, inputs):
    g = inputs["psum_g"]
    body = jax.vmap(lambda x, e: jcol.compressed_psum_mean(x, e, "pod", 2),
                    axis_name="pod")
    mean, err = body(jnp.asarray(g), jnp.zeros_like(jnp.asarray(g)))
    tol = PSUM_RTOL * np.abs(g).max()
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["psum"]["mean"],
                                   np.asarray(mean)[r], rtol=0, atol=tol)
        np.testing.assert_allclose(ranks[r]["psum"]["err"],
                                   np.asarray(err)[r], rtol=0, atol=tol)
    # error feedback: the residual is at most half a step, and the means
    # of repeated rounds of one gradient converge on the true mean
    scale = np.abs(g).max() / 127.0
    assert np.abs(ranks[0]["psum"]["err"]).max() <= scale * 0.51
    drift = np.abs(ranks[0]["psum"]["rounds"].mean(0) - g.mean(0)).max()
    assert drift <= scale * 0.15, drift
    e = jnp.zeros_like(jnp.asarray(g))
    for i in range(ROUNDS):
        out, e = body(jnp.asarray(g), e)
        np.testing.assert_allclose(ranks[1]["psum"]["rounds"][i],
                                   np.asarray(out)[1], rtol=0, atol=tol)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_sharded_step_equals_one_device(ranks, inputs, shape):
    arch = "qwen2.5-3b"
    got = ranks[0][f"step{shape}"]
    assert ranks[1][f"step{shape}"]["losses"] == got["losses"]
    one_loss, _, one_params = _single(arch, inputs, 1)
    ref_loss, ref_params = _reference(arch, inputs)
    np.testing.assert_allclose(got["losses"][0], one_loss[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"][0], ref_loss, rtol=LOSS_RTOL)
    _params_close(got["params"], one_params, _lr(1))
    _params_close(got["params"], ref_params, _lr(1))
    # wq keeps the rule's placement: split on data and on model
    assert got["wq_spec"] == (None, "data", "model")
    d, m = shape
    assert got["wq_shape"] == (2, 64 // d, 64 // m)


def test_sharded_step_with_int8_moments(ranks, inputs):
    """Two steps at 1x2 with int8 moments (wq's 32-wide shards keep whole
    moments) against the single-process steps."""
    got = ranks[0]["step_int8"]
    one_loss, _, one_params = _single("qwen2.5-3b", inputs, 2,
                                      quantized=True)
    np.testing.assert_allclose(got["losses"], one_loss, rtol=LOSS_RTOL)
    _params_close(got["params"], one_params, _lr(1) + _lr(2))


def test_moe_aux_averages_over_the_data_ranks(ranks, inputs):
    arch = "qwen3-moe-30b-a3b"
    one_loss, one_aux, one_params = _single(arch, inputs, 1)
    assert ranks[0]["moe_aux"] == ranks[1]["moe_aux"]
    np.testing.assert_allclose(ranks[0]["moe_aux"], one_aux, rtol=AUX_RTOL)
    got = ranks[0]["moe_step"]
    np.testing.assert_allclose(got["aux"], one_aux, rtol=AUX_RTOL)
    np.testing.assert_allclose(got["losses"][0], one_loss[0], rtol=LOSS_RTOL)
    _params_close(got["params"], one_params, _lr(1))


def test_compressed_step_equals_the_reference_sync(ranks, inputs):
    per_pod = [ranks[r]["compressed"]["grads"] for r in range(2)]
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), *per_pod)
    zeros = jax.tree.map(jnp.zeros_like, stacked)
    sync = jax.vmap(lambda g, e: jcol.compressed_grad_sync(g, e, "pod", 2),
                    axis_name="pod")
    mean, err = sync(stacked, zeros)
    for r in range(2):
        got = ranks[r]["compressed"]
        for name, want in (("synced", mean), ("err", err)):
            for a, b in zip(jax.tree.leaves(got[name]),
                            jax.tree.leaves(want)):
                tol = PSUM_RTOL * max(np.abs(a).max(), 1e-30)
                np.testing.assert_allclose(a, np.asarray(b)[r], rtol=0,
                                           atol=tol)
        for a, b in zip(jax.tree.leaves(got["err_step"]),
                        jax.tree.leaves(got["err"])):
            np.testing.assert_array_equal(a, b)
    assert ranks[0]["compressed"]["loss"] == ranks[1]["compressed"]["loss"]
    one_loss, _, _ = _single("qwen2.5-3b", inputs, 1)
    np.testing.assert_allclose(ranks[0]["compressed"]["loss"], one_loss[0],
                               rtol=LOSS_RTOL)
    assert all(np.isfinite(p).all()
               for p in jax.tree.leaves(ranks[0]["compressed"]["params"]))


def test_save_at_1x2_restore_at_2x1(ranks):
    for r in range(2):
        got = ranks[r]["reshard"]
        assert got["step"] == 1 and all(got["equal"]), got
        assert got["wq_shape"] == (2, 32, 64)
        assert got["whole_a"] > got["whole_b"]


def test_elastic_restart_drill_on_two_ranks(ranks):
    got = ranks[0]["elastic"]
    assert got["ok"] and got["restored_step"] == 30
    assert got["mesh_a"] == {"data": 1, "model": 2}
    assert got["mesh_b"] == {"data": 2, "model": 1}
    assert ranks[1]["elastic"]["phase2"] == got["phase2"]
