"""The port's AdamW and int8 moment codec against the reference's, on the
CPU.

* ``lr_schedule``: within 1 f32 ulp of the reference's (rtol 2e-7; warmup,
  peak, cosine decay and its floor). Measured: equal at every step tried.
* The int8 codec (``_quantize`` / ``_dequantize``): bit for bit, codes and
  scales, over ragged last dims, 0-D and 1-D leaves and all-zero blocks.
* ``adamw_update``: three steps from one state on a tree of 0-D, 1-D, 2-D
  and 3-D leaves, plain and with int8 moments: params and f32 moments
  within rtol = atol = 1e-6 (f32 rounding where the two frameworks order
  a sum differently: the global norm's), the step and the lr exactly
  (rtol 2e-7), int8 codes equal but for at most 0.1% flipped by one
  (a moment on a rounding edge), scales within 1e-6. Measured: the lr
  equal at every step tried; the norms 1 ulp apart (229.39854 against
  229.39856); params (values up to ~4) 1.2e-7 apart plain, 2.4e-7
  quantized (1-2 ulp); moments 9.3e-10, scales 7.3e-12; no int8 code
  flipped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.models.bridge import (opt_state_from_numpy,
                                       opt_state_to_numpy, params_from_numpy,
                                       params_to_numpy)
from repro_torch.train import optimizer as topt

SHAPES = [(), (1,), (7,), (256,), (3, 300), (2, 5, 256), (4, 513)]


def _codec_input(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x = np.asarray(x * np.float32(10.0 ** (seed % 5 - 2)))
    if x.ndim >= 1 and x.shape[-1] > QB:
        x[..., :QB] = 0.0                       # one all-zero block
    return x


QB = jopt.QBLOCK


def test_block_size_is_the_reference_s():
    assert topt.QBLOCK == jopt.QBLOCK


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 5000,
                                  9999, 10000, 20000])
def test_lr_schedule_equals_the_reference(step):
    cfg = topt.OptConfig(peak_lr=3e-3, warmup_steps=10, decay_steps=100)
    jcfg = jopt.OptConfig(peak_lr=3e-3, warmup_steps=10, decay_steps=100)
    got = topt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = jopt.lr_schedule(jcfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_int8_codec_is_bit_for_bit_the_reference_s(shape):
    for seed in range(3):
        x = _codec_input(shape, seed)
        q, s = topt._quantize(torch.from_numpy(x))
        jq, js = jopt._quantize(jnp.asarray(x))
        assert q.dtype == torch.int8 and tuple(q.shape) == shape
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = topt._dequantize(q, s, shape)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jopt._dequantize(jq, js, shape)))


def _tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(3, 300), "stack": {"w3": f(2, 4, 260), "bias": f(7)},
            "gain": np.asarray(rng.standard_normal(), np.float32)}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_three_adamw_steps_equal_the_reference(quantized):
    kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10,
              quantized_moments=quantized)
    cfg, jcfg = topt.OptConfig(**kw), jopt.OptConfig(**kw)
    params = _tree(0)
    jp = _jtree(params)
    js = jopt.init_opt_state(jp, jcfg)
    tp = params_from_numpy(params, "cpu")
    ts = topt.init_opt_state(tp, cfg)
    init = opt_state_to_numpy(ts)
    jinit = jax.tree.map(np.asarray, js)
    for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(jinit)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for step in range(3):
        grads = _tree(step + 1)
        grads["stack"]["w3"] *= 5.0                 # clipping engages
        jp, js, jm = jopt.adamw_update(jp, _jtree(grads), js, jcfg)
        tp, ts, tm = topt.adamw_update(tp, params_from_numpy(grads, "cpu"),
                                       ts, cfg)
        np.testing.assert_allclose(tm["lr"].numpy(), np.asarray(jm["lr"]),
                                   rtol=2e-7)
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    got, want = opt_state_to_numpy(ts), jax.tree.map(np.asarray, js)
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(got[name]),
                        jax.tree.leaves(want[name])):
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dtype == np.int8:
                flipped = np.abs(a.astype(int) - b.astype(int))
                assert flipped.max() <= 1 and flipped.mean() <= 1e-3
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_state_crosses_the_bridge_with_int8_moments():
    cfg = jopt.OptConfig(quantized_moments=True)
    js = jopt.init_opt_state(_jtree(_tree(0)), cfg)
    js = jopt.adamw_update(_jtree(_tree(0)), _jtree(_tree(1)), js, cfg)[1]
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert isinstance(ts["m"]["w"], topt.QTensor)
    assert ts["m"]["w"].q.dtype == torch.int8
    back = opt_state_to_numpy(ts)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            jax.tree.map(np.asarray, js))):
        np.testing.assert_array_equal(a, b)


def test_global_norm_and_no_decay_below_2d():
    tree = _tree(3)
    np.testing.assert_allclose(
        topt.global_norm(params_from_numpy(tree, "cpu")).numpy(),
        np.asarray(jopt.global_norm(_jtree(tree))), rtol=1e-6)
    cfg = topt.OptConfig(peak_lr=1.0, warmup_steps=0, weight_decay=0.5)
    p = params_from_numpy(tree, "cpu")
    zero = params_from_numpy(jax.tree.map(np.zeros_like, tree), "cpu")
    p, _, _ = topt.adamw_update(p, zero, topt.init_opt_state(p, cfg), cfg)
    np.testing.assert_array_equal(p["stack"]["bias"].numpy(),
                                  tree["stack"]["bias"])
    np.testing.assert_array_equal(p["gain"].numpy(), tree["gain"])
    np.testing.assert_allclose(p["w"].numpy(), tree["w"] * 0.5, rtol=1e-6)
