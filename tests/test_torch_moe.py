"""The port's MoE block against the JAX package, on the CPU.

Weights come from the reference's ``init_moe`` (and ``Model.init``) through
the numpy bridge; activations are numpy-seeded bf16, as the block sees
them after the layer's norm. Tolerances:

* the plain version (``impl="dense"``, f32 experts) against the
  reference's ``moe_block(impl="dense")`` on both ``REDUCED`` configs
  (deepseek-v2's with its shared expert): bf16 outputs within atol = rtol
  = 1.6e-2, 1-2 bf16 ulp (the frameworks round bf16 at different places;
  ``test_torch_model.py``'s layer tolerance); the aux loss within 1e-5
  relative (f32 means of the same routing);
* the grouped version (bf16 operands, f32 accumulation, f32 GEMM
  outputs, as the reference's ``ragged_dot``; one grouped GEMM a
  projection over offsets computed on the device), at a prefill's and at
  a decode step's token counts, against the reference's
  ``moe_block(impl="ep")`` under a one-device mesh with a ``model`` axis,
  which runs ``_moe_ep_inner`` at one shard: within ``EP_TOL = 1.2e-2``
  (atol = rtol). Measured on the CPU over four input seeds: qwen3-moe
  reads 0 (bit for bit) at both token counts; deepseek-v2 up to 1.12e-2
  (7.95e-3 on this file's inputs), one bf16 ulp of outputs up to 4.5 from
  its shared expert's bf16 SwiGLU (the frameworks' SiLU roundings). Before
  the grouped GEMM wrote f32 it was held at the bf16 1.6e-2. Against the
  port's plain version at 3e-2 (bf16 operand rounding against f32
  experts); its grouped GEMM returns f32 and equals one f32 matmul per
  expert of the bf16-rounded operands, bit for bit;
* the routed expert ids of the port's router equal the reference's; where
  they part, the assertion reports the reference's top-k margin there.

The ``cuda`` tests hold the grouped version to the plain one on the card at
the same 3e-2 (bf16 operands against f32 experts), and the grouped_gemm
kernel to its plain version (``F.grouped_mm`` over f32-widened operands)
at ``GEMM_REL_TOL`` = 1e-4 relative to the output's largest value (the
two sum the same exact f32 products in another order: 1.5e-5 measured at
qwen3-moe's widths, NVIDIA H100 80GB HBM3), each call under the sync
guard and one launch: qwen3-moe's widths, both regimes' edges (m 63 / 64
/ 65; 767 / 768 / 769 at 16 experts), K and N off the tiles, 64-row
admission tiles, jamba's 16 experts x 128 rows at K 8192; and bit for
bit, that two calls agree and that a row's output does not move with
the other rows of its call (permuted inside each expert; alone at a
decode step). On the CPU, the wrapper's checks: bf16 operands,
contiguous, ``w (E, K, N)`` against ``xs (m, K)``, K and N multiples of
8, an ``(E,)`` int32 ``offs`` on ``xs``'s device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.distributed.sharding import make_mesh, use_mesh
from repro.models import build_model as j_build_model
from repro.models import moe as jmoe
from repro_torch.configs import get_reduced
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_gemm import (check_inputs, grouped_gemm,
                                              grouped_gemm_plain)
from repro_torch.models import build_model, moe
from repro_torch.models.api import _is_matrix
from repro_torch.models.bridge import params_from_numpy, params_to_numpy

torch.set_num_threads(1)
GEMM_REL_TOL = 1e-4
BF16_TOL = 1.6e-2
EP_TOL = 1.2e-2
GROUPED_TOL = 3e-2
ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v2-236b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def block(request):
    """(port cfg, reference cfg, reference params, port params, x bf16 as
    f32 numpy) for one arch's MoE block."""
    arch = request.param
    jcfg, tcfg = j_get_reduced(arch), get_reduced(arch)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(3))
    rng = np.random.RandomState(4)
    x = np.asarray(jnp.asarray(rng.randn(3, 7, jcfg.d_model), jnp.float32)
                   .astype(jnp.bfloat16).astype(jnp.float32))
    return tcfg, jcfg, jp, params_from_numpy(_np_tree(jp), "cpu"), x


def _xt(x):
    return torch.from_numpy(np.array(x)).to(torch.bfloat16)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_routing_matches_jax(block):
    """The same top-k expert ids for every token; a part reports the
    reference's margin between its k-th and (k+1)-th probability."""
    tcfg, jcfg, jp, tp, x = block
    xt = x.reshape(-1, x.shape[-1])
    jg, jidx, jprobs = jmoe._route(jp["router"], jnp.asarray(xt, jnp.bfloat16),
                                   jcfg.top_k)
    tg, tidx, tprobs = moe._route(tp["router"], _xt(xt), tcfg.top_k)
    jidx = np.asarray(jidx)
    parted = np.nonzero((np.sort(jidx, 1) != np.sort(tidx.numpy(), 1))
                        .any(1))[0]
    top = np.sort(np.asarray(jprobs), 1)[:, ::-1]
    margins = top[parted, jcfg.top_k - 1] - top[parted, jcfg.top_k]
    assert parted.size == 0, f"tokens {parted} parted at margins {margins}"
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


def test_plain_block_matches_jax(block):
    tcfg, jcfg, jp, tp, x = block
    jy, jaux = jmoe.moe_block(jp, jnp.asarray(x, jnp.bfloat16), cfg=jcfg,
                              impl="dense")
    ty, taux = moe.moe_block(tp, _xt(x), cfg=tcfg, impl="dense")
    assert ty.dtype == torch.bfloat16
    _close(ty, jy.astype(jnp.float32), BF16_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("tokens", [7, 1], ids=["prefill", "decode"])
def test_grouped_block_matches_jax_ep(block, tokens):
    """``tokens`` a row: a prompt's, or a decode step's one."""
    tcfg, jcfg, jp, tp, x = block
    x = x[:, -tokens:]
    with use_mesh(make_mesh((1,), ("model",))):
        jy, jaux = jmoe.moe_block(jp, jnp.asarray(x, jnp.bfloat16), cfg=jcfg,
                                  impl="ep")
    ty, taux = moe.moe_block(tp, _xt(x), cfg=tcfg, impl="grouped")
    _close(ty, jy.astype(jnp.float32), EP_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    plain, _ = moe.moe_block(tp, _xt(x), cfg=tcfg, impl="dense")
    _close(ty, plain.float().numpy(), GROUPED_TOL)


def test_grouped_products_equal_one_matmul_per_expert(block):
    """The offsets are the per-expert counts' running sum, and the grouped
    GEMM over them computes each expert's run of sorted hits as one f32
    matmul of the bf16-rounded operands, returned in f32 as the
    reference's ``ragged_dot`` (bit for bit on the CPU), experts with no
    hit (the first, the last and one between) included."""
    tcfg, _, _, tp, _ = block
    e = tcfg.n_experts
    rng = np.random.RandomState(7)
    hit = [g for g in range(1, e - 1) if g != e // 2]
    sel_e = torch.from_numpy(np.sort(rng.choice(hit, 20))).long()
    offs = moe._offsets(sel_e, e)
    assert offs.dtype == torch.int32
    assert offs.tolist() == torch.cumsum(
        torch.bincount(sel_e, minlength=e), 0).tolist()
    xs = torch.from_numpy(rng.randn(20, tcfg.d_model)).to(torch.bfloat16)
    w = tp["we_gate"]
    want = torch.cat([rows.float() @ w[g].to(torch.bfloat16).float()
                      for g, rows in enumerate(torch.split(
                          xs, torch.bincount(sel_e, minlength=e).tolist()))])
    got = moe._grouped(xs, w, offs)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_auto_runs_dense_on_the_cpu_and_unknown_impl_raises(block):
    tcfg, _, _, tp, x = block
    auto, _ = moe.moe_block(tp, _xt(x), cfg=tcfg)
    dense, _ = moe.moe_block(tp, _xt(x), cfg=tcfg, impl="dense")
    assert torch.equal(auto, dense)
    with pytest.raises(ValueError, match="impl"):
        moe.moe_block(tp, _xt(x), cfg=tcfg, impl="ep")


def test_capacity_below_one_drops_hits_as_the_reference():
    """At capacity_factor < 1 one shard keeps the first ``cap`` sorted hits
    and the rest contribute zero, as the reference's EP path does."""
    import dataclasses
    jcfg = dataclasses.replace(j_get_reduced("qwen3-moe-30b-a3b"),
                               capacity_factor=0.5)
    tcfg = dataclasses.replace(get_reduced("qwen3-moe-30b-a3b"),
                               capacity_factor=0.5)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(5))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    x = np.asarray(jnp.asarray(np.random.RandomState(6).randn(2, 6, 64),
                               jnp.bfloat16).astype(jnp.float32))
    with use_mesh(make_mesh((1,), ("model",))):
        jy, _ = jmoe.moe_block(jp, jnp.asarray(x, jnp.bfloat16), cfg=jcfg,
                               impl="ep")
    ty, _ = moe.moe_block(tp, _xt(x), cfg=tcfg, impl="grouped")
    _close(ty, jy.astype(jnp.float32), BF16_TOL)
    full, _ = moe.moe_block(tp, _xt(x), cfg=get_reduced("qwen3-moe-30b-a3b"),
                            impl="grouped")
    assert not torch.equal(ty, full)


# ------------------------------------------------------------ model level

@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_loads_the_reference_params(arch):
    """The reference's ``Model.init`` weights load by a plain tree map (same
    keys, same shapes, no conversion), and the port's own init makes the
    same tree."""
    jm = j_build_model(j_get_reduced(arch))
    jp = _np_tree(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(get_reduced(arch), device="cpu")
    back = params_to_numpy(params_from_numpy(jp, "cpu"))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(a, b)
    own = params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    assert jax.tree.map(lambda a: (a.shape, a.dtype), own) \
        == jax.tree.map(lambda a: (a.shape, a.dtype), jp)


def test_prepare_keeps_the_router_f32_and_experts_per_path():
    """The serving copy: routed experts bf16 where the grouped MoE runs
    them (the card), f32 for the CPU's plain version; the router f32 in
    every case; shared experts and attention matrices bf16."""
    tm = build_model(get_reduced("deepseek-v2-236b"), device="cpu")
    prep = tm.prepare(tm.init(torch.Generator().manual_seed(0)))
    blk = next(layer for group in prep["groups"].values()
               for layer in group.values() if "moe" in layer)
    for name in ("we_gate", "we_up", "we_down", "router"):
        assert blk["moe"][name].dtype == torch.float32, name
    assert blk["moe"]["shared"]["w_gate"].dtype == torch.bfloat16
    assert blk["attn"]["wkv_b"].dtype == torch.bfloat16
    assert blk["attn"]["kv_norm"]["scale"].dtype == torch.float32
    for name in ("we_gate", "we_up", "we_down"):
        assert _is_matrix(name, grouped_moe=True)
        assert not _is_matrix(name, grouped_moe=False)
    assert not _is_matrix("router", grouped_moe=True)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_matches_plain_on_the_card(arch):
    """The grouped version (bf16 experts, one grouped GEMM a projection)
    against the plain one (f32 experts) on the card, at 3e-2, at a
    prefill's and a decode step's token counts, with no device->host
    read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_reduced(arch)
    g = torch.Generator(device="cuda").manual_seed(0)
    p = moe.init_moe(cfg, g)
    p = {k: (v[0] if torch.is_tensor(v) else {n: t[0] for n, t in v.items()})
         for k, v in p.items()}
    x = torch.randn((4, 16, cfg.d_model), generator=g,
                    device="cuda").to(torch.bfloat16)
    for rows in (x, x[:, -1:]):
        plain, aux = moe.moe_block(p, rows, cfg=cfg, impl="dense")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, got_aux = moe.moe_block(p, rows, cfg=cfg, impl="grouped")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.testing.assert_close(got.float(), plain.float(),
                                   atol=GROUPED_TOL, rtol=GROUPED_TOL)
        torch.testing.assert_close(got_aux, aux)


# ------------------------------------------------------------ grouped_gemm

def _grouped_case(m, e, k, n, seed, device="cpu"):
    """Hits sorted by expert (some experts empty), bf16 rows and weights,
    the offsets ending each expert's run."""
    rng = np.random.RandomState(seed)
    sel_e = torch.from_numpy(np.sort(rng.randint(0, e, m))).long()
    offs = moe._offsets(sel_e, e)
    xs = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    w = torch.from_numpy((rng.randn(e, k, n) / np.sqrt(k)).astype(np.float32))
    return (xs.to(torch.bfloat16).to(device), w.to(torch.bfloat16).to(device),
            offs.to(device))


def test_grouped_gemm_checks_its_operands():
    """Before any launch: bf16 operands, contiguous, w (E, K, N) against
    xs (m, K), K and N positive multiples of 8, an (E,) contiguous int32
    offs on xs's device; the output is (m, N). On the CPU the wrapper and
    ``ops.grouped_matmul`` return the plain version, in f32."""
    xs, w, offs = _grouped_case(12, 3, 16, 24, 0)
    assert check_inputs(xs, w, offs) == (12, 24)
    for bad, err in (((xs.float(), w, offs), TypeError),
                     ((xs, w.float(), offs), TypeError),
                     ((xs, w[:, :8], offs), ValueError),
                     ((xs[:, :12], w[:, :12], offs), ValueError),
                     ((xs, w[..., :20], offs), ValueError),
                     ((xs, w.transpose(1, 2).contiguous().transpose(1, 2),
                       offs), ValueError),
                     ((xs, w, offs.long()), TypeError),
                     ((xs, w, offs[:2]), TypeError),
                     ((xs[None], w, offs), ValueError)):
        with pytest.raises(err):
            check_inputs(*bad)
    plain = grouped_gemm_plain(xs, w, offs)
    assert plain.dtype == torch.float32 and plain.shape == (12, 24)
    assert torch.equal(grouped_gemm(xs, w, offs), plain)
    assert torch.equal(ops.grouped_matmul(xs, w, offs), plain)


def _kernel_once(xs, w, offs, config=None):
    """One grouped_gemm call on the card under the sync guard (no
    device->host read), which must launch the kernel once."""
    before = grouped_gemm.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = grouped_gemm(xs, w, offs, config=config)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert grouped_gemm.launches == before + 1
    assert got.dtype == torch.float32
    return got


def _assert_matches_plain(got, xs, w, offs):
    want = grouped_gemm_plain(xs, w, offs)
    end = int(offs[-1])
    err = (got[:end] - want[:end]).abs().max().item()
    assert err <= GEMM_REL_TOL * want[:end].abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("m,e,k,n", [(8192, 128, 2048, 768), (32, 128, 2048,
                                                               768),
                                     (8192, 128, 768, 2048), (37, 16, 64, 40),
                                     (5, 3, 16, 8),
                                     # the decode regime's edge (m <= 64)
                                     (63, 16, 2048, 768), (64, 16, 2048, 768),
                                     (65, 16, 2048, 768),
                                     # 128-row admission tiles from m >= 48 E
                                     (767, 16, 512, 256), (768, 16, 512, 256),
                                     (769, 16, 512, 256),
                                     # K and N off the 64-deep, 64- and
                                     # 128-wide tiles
                                     (20, 8, 72, 40), (300, 8, 72, 40),
                                     (1000, 4, 136, 136), (40, 4, 136, 200),
                                     # 64-row admission tiles (deepseek-v2's
                                     # 38 rows an expert)
                                     (2000, 64, 1024, 512)])
def test_grouped_gemm_matches_plain_on_the_card(m, e, k, n):
    """The kernel (f32 out) against its plain version at qwen3-moe's widths
    (a 1024-token admission's 8192 hits and a decode step's 32; the down
    projection), 64-row admission tiles, both regimes' edges and ragged
    K and N, within GEMM_REL_TOL of the output's largest value, with no
    device->host read; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xs, w, offs = _grouped_case(m, e, k, n, 1, "cuda")
    _assert_matches_plain(_kernel_once(xs, w, offs), xs, w, offs)


@pytest.mark.cuda
def test_grouped_gemm_jamba_family_on_the_card():
    """jamba-1.5-large's experts (16, K 8192) with 128 rows each (N cut
    from 24576 to 4096 to keep the plain version's f32 copy small)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(2)
    xs = torch.randn((2048, 8192), generator=g, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn((16, 8192, 4096), generator=g, device="cuda")
         / 90.5).to(torch.bfloat16)
    offs = torch.arange(128, 2049, 128, dtype=torch.int32, device="cuda")
    _assert_matches_plain(_kernel_once(xs, w, offs), xs, w, offs)


@pytest.mark.cuda
@pytest.mark.parametrize("m,e", [(32, 128), (8192, 128), (1000, 16)])
def test_grouped_gemm_bits_repeat_and_do_not_depend_on_other_rows(m, e):
    """Two calls give the same bits; within one regime a row's output is
    the same whatever rows share its call: the rows permuted inside each
    expert (so each lands elsewhere in its tile), and in the decode regime
    each row alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xs, w, offs = _grouped_case(m, e, 2048, 768, 3, "cuda")
    got = _kernel_once(xs, w, offs)
    assert torch.equal(got, _kernel_once(xs, w, offs))
    starts = [0] + offs.tolist()[:-1]
    perm = torch.cat([torch.arange(a, b).flip(0)
                      for a, b in zip(starts, offs.tolist())]).cuda()
    moved = _kernel_once(xs[perm].contiguous(), w, offs)
    assert torch.equal(moved, got[perm])
    if m <= 64:
        for i in (0, m // 2, m - 1):
            g = int(np.searchsorted(offs.cpu().numpy(), i, side="right"))
            one = (torch.arange(e, device="cuda") >= g).to(torch.int32)
            alone = _kernel_once(xs[i:i + 1].contiguous(), w, one)
            assert torch.equal(alone[0], got[i])


@pytest.mark.cuda
@pytest.mark.parametrize("m,e,k,n", [(8192, 128, 2048, 768),
                                     (6144, 160, 5120, 1536),
                                     (32, 128, 2048, 768), (300, 8, 72, 40)])
def test_grouped_gemm_tile_shapes_agree_bit_for_bit(m, e, k, n):
    """Every tile shape of the kernel, forced, gives the whole call the same
    bits as launch_config's pick (each output element is summed over K in
    the same order whatever the tile): qwen3-moe's and deepseek-v2's
    admissions, a decode step, ragged K and N."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.grouped_gemm import TILES
    xs, w, offs = _grouped_case(m, e, k, n, 4, "cuda")
    picked = _kernel_once(xs, w, offs)
    _assert_matches_plain(picked, xs, w, offs)
    for config in TILES:
        assert torch.equal(_kernel_once(xs, w, offs, config), picked), config
