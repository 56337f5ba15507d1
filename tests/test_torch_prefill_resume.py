"""The port's resumed prefill and row moves against the JAX package.

A resumed prefill (``Model.prefill(prefix_len, prefix_state)``) runs a
prompt's tail over K/V an earlier call cached: the prefix-share suffix and
the chunked-prefill chunk. On the ``qwen2.5-3b`` smoke config, with the
reference's ``Model.init`` weights through the numpy bridge, a tail
prefilled at ``prefix_len = 8`` over the prefix read back from a paged
pool (``gather_row_paged``) gives f32 logits within ``LOGIT_TOL = 1e-2``
of the reference's (the cross-package tolerance of
``test_torch_model.py``), and its greedy token equals the port's own
whole-prompt prefill's.

The row moves only move bits, so they are held EXACTLY: ``slot_update``,
``gather_row`` and ``gather_row_paged`` on the same bf16 / f32 arrays give
the reference's arrays bit for bit, recurrent rows included. The gathers
refuse recurrent state, as the reference's do.

The ``cuda``-marked case holds the flash kernel at the resumed prefill's
shapes (Sq < Skv at ``q_offset > 0``) against its plain version, bf16 at
atol = rtol = 2e-2 (``chip_smoke.py``'s kernel tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import build_model as j_build_model
from repro.models import transformer as j_tr
from repro_torch.configs import get_reduced
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import build_model, transformer
from repro_torch.models.bridge import params_from_numpy

torch.set_num_threads(1)
LOGIT_TOL = 1e-2
PT, P_MAX = 8, 4                  # 8-token pages, 32-token depth
DEPTH = PT * P_MAX


@pytest.fixture(scope="module")
def qwen():
    jm = j_build_model(j_get_reduced("qwen2.5-3b"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_reduced("qwen2.5-3b"), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _random_tree(tree, seed):
    """Fill every leaf of a port cache tree with seeded values that bf16
    holds exactly; returns (port tree, the same values as a jax tree)."""
    gen = torch.Generator().manual_seed(seed)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        return torch.randn(t.shape, generator=gen).to(t.dtype)

    port = fill(tree)
    return port, _to_jax(port)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    dtype = jnp.bfloat16 if tree.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(tree.float().numpy()).astype(dtype)


def _f32(leaf):
    if torch.is_tensor(leaf):
        return leaf.float().numpy()
    return np.asarray(leaf.astype(jnp.float32))


def _assert_trees_equal(got, want):
    """Every leaf of ``got`` equals ``want``'s bit for bit (either tree may
    hold tensors or jax arrays)."""
    assert isinstance(got, dict) == isinstance(want, dict)
    if not isinstance(got, dict):
        a, b = _f32(got), _f32(want)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        return
    assert got.keys() == want.keys()
    for k in got:
        _assert_trees_equal(got[k], want[k])


def _paged_pool(model, n_pages, seed):
    caches = transformer.init_paged_caches(model.cfg, 3, n_pages, PT, "cpu")
    return _random_tree(caches, seed)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "falcon-mamba-7b"])
def test_slot_update_and_gather_row_equal_the_reference(arch):
    """Dense slab: write a row at slot 1, read it back; every leaf (K/V,
    or falcon's conv tail and state) equals the reference's bit for bit.
    The gather refuses falcon's recurrent rows in both packages."""
    jm = j_build_model(j_get_reduced(arch))
    tm = build_model(get_reduced(arch), device="cpu")
    pool, j_pool = _random_tree(
        transformer.init_caches(tm.cfg, 3, DEPTH, "cpu"), 1)
    row, j_row = _random_tree(
        transformer.init_caches(tm.cfg, 1, DEPTH, "cpu"), 2)
    got = tm.slot_update({"caches": pool}, {"caches": row}, 1)
    want = jm.slot_update({"caches": j_pool}, {"caches": j_row},
                          jnp.asarray(1, jnp.int32))
    _assert_trees_equal(got["caches"], want["caches"])
    if arch == "falcon-mamba-7b":
        with pytest.raises(NotImplementedError, match="attention-only"):
            tm.gather_row(got, 1)
        with pytest.raises(NotImplementedError, match="attention-only"):
            jm.gather_row(want, jnp.asarray(1, jnp.int32))
        return
    back = tm.gather_row(got, 1)
    _assert_trees_equal(back["caches"], jm.gather_row(
        want, jnp.asarray(1, jnp.int32))["caches"])
    _assert_trees_equal(back["caches"], row)
    # a copy, as the reference's functional arrays are: writing it leaves
    # the pool alone
    leaf = back["caches"]["blocks"]["pos0"]["k"]
    leaf.zero_()
    assert got["caches"]["blocks"]["pos0"]["k"][:, 1].abs().sum() > 0


@pytest.mark.parametrize("block_row", [[3, 7, 0, 0], [5, 2, 9, 1],
                                       [0, 0, 0, 0]])
def test_gather_row_paged_and_page_cut_equal_the_reference(qwen, block_row):
    """Paged pool: the gather through a block row (null entries read page
    0) equals the reference's bit for bit, and cutting a dense row into the
    pages it maps and gathering them back is the identity."""
    jm, _, tm, _ = qwen
    pages, j_pages = _paged_pool(tm, 11, 3)
    row = torch.tensor(block_row, dtype=torch.int32)
    got = tm.gather_row_paged({"caches": pages}, row, PT)
    want = jm.gather_row_paged({"caches": j_pages}, jnp.asarray(row.numpy()),
                               PT)
    _assert_trees_equal(got["caches"], want["caches"])
    if len(set(block_row)) < len(block_row):
        return      # which duplicate write lands on page 0 is unspecified
    dense, j_dense = _random_tree(
        transformer.init_caches(tm.cfg, 1, DEPTH, "cpu"), 4)
    cut = tm.slot_update_paged({"caches": pages}, {"caches": dense}, 0,
                               row, PT)
    j_cut = jm.slot_update_paged({"caches": j_pages}, {"caches": j_dense},
                                 jnp.asarray(0, jnp.int32),
                                 jnp.asarray(row.numpy()), PT)
    _assert_trees_equal(cut["caches"], j_cut["caches"])
    _assert_trees_equal(tm.gather_row_paged(cut, row, PT)["caches"], dense)


def test_gather_row_paged_refuses_recurrent_state():
    jm = j_build_model(j_get_reduced("falcon-mamba-7b"))
    tm = build_model(get_reduced("falcon-mamba-7b"), device="cpu")
    caches = transformer.init_paged_caches(tm.cfg, 3, 5, PT, "cpu")
    row = torch.zeros((P_MAX,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="attention-only"):
        tm.gather_row_paged({"caches": caches}, row, PT)
    with pytest.raises(NotImplementedError, match="attention-only"):
        jm.gather_row_paged(
            {"caches": j_tr.init_paged_caches(jm.cfg, 3, 5, PT)},
            jnp.zeros((P_MAX,), jnp.int32), PT)
    params = {"tok": None}
    with pytest.raises(NotImplementedError, match="attention-only"):
        tm.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                   DEPTH, prefix_len=4)


def test_resumed_prefill_over_gathered_pages_matches_jax(qwen):
    """Prefill 8 tokens, cut them into pages, gather them back and prefill
    the 6-token tail at prefix_len = 8: logits within LOGIT_TOL of the
    reference's same sequence of calls, and the same greedy token as the
    port's whole-prompt prefill."""
    jm, jp, tm, tp = qwen
    cfg = tm.cfg
    prompt = np.random.RandomState(5).randint(
        2, cfg.vocab_size, size=14).astype(np.int32)
    head, tail = prompt[:8], prompt[8:]
    block_row = np.asarray([4, 2, 0, 0], np.int32)
    read_row = np.asarray([4, 0, 0, 0], np.int32)     # the one full page

    caches = transformer.init_paged_caches(cfg, 1, 6, PT, "cpu")
    _, row = tm.prefill(tp, {"tokens": torch.as_tensor(head[None])}, DEPTH)
    pool = tm.slot_update_paged({"caches": caches}, row, 0,
                                torch.as_tensor(block_row), PT)
    prefix = tm.gather_row_paged(pool, torch.as_tensor(read_row), PT)
    got, state = tm.prefill(tp, {"tokens": torch.as_tensor(tail[None])},
                            DEPTH, prefix_len=8, prefix_state=prefix)
    assert state["caches"] is prefix["caches"]      # the tail's K/V landed

    j_pool = {"caches": j_tr.init_paged_caches(jm.cfg, 1, 6, PT)}
    _, j_row = jm.prefill(jp, {"tokens": jnp.asarray(head[None])}, DEPTH)
    j_pool = jm.slot_update_paged(j_pool, j_row, jnp.asarray(0, jnp.int32),
                                  jnp.asarray(block_row), PT)
    j_prefix = jm.gather_row_paged(j_pool, jnp.asarray(read_row), PT)
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(tail[None])}, DEPTH,
                         prefix_len=8, prefix_state=j_prefix)
    err = np.abs(got.numpy() - np.asarray(want, np.float32)).max()
    assert err <= LOGIT_TOL, err

    whole, _ = tm.prefill(tp, {"tokens": torch.as_tensor(prompt[None])},
                          DEPTH)
    vocab = cfg.vocab_size
    assert int(got[0, -1, :vocab].argmax()) == int(whole[0, -1, :vocab]
                                                   .argmax())
    assert float((got - whole).abs().max()) <= LOGIT_TOL


# --------------------------------------------------------- on the card

#: (B, Hq, Hkv, Sq, Skv, q_offset): a prefix-share suffix and a prefill
#: chunk over a slot's whole depth, as the serving streams give them
RESUMED_FLASH = {"suffix": (1, 16, 2, 256, 576, 256),
                 "chunk": (1, 16, 2, 128, 576, 384),
                 "ragged-tail": (1, 16, 2, 37, 576, 300)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RESUMED_FLASH))
def test_flash_at_a_resumed_offset_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, hq, hkv, sq, skv, off = RESUMED_FLASH[case]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(h, s):
        return torch.randn((b, h, s, 128), generator=g,
                           device=dev).to(torch.bfloat16)

    q, k, v = rnd(hq, sq), rnd(hkv, skv), rnd(hkv, skv)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(
        got.float(), ref.attention_ref(q, k, v, causal=True,
                                       q_offset=off).float(),
        atol=2e-2, rtol=2e-2)
