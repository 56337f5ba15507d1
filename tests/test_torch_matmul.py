"""The port's matmul path against the JAX package, on the CPU; the kernel
against its plain version on the card.

Same numpy inputs (bf16 cases round the same f32 values in both packages)
go through JAX's oracle ``repro.kernels.ref.matmul_ref``, JAX's Pallas
``matmul3d`` in interpret mode, and the port's ``matmul_ref`` /
``ops.matmul``. Tolerances are ``tests/test_kernels.py``'s ``_tol``: f32
2e-4, bf16 2e-2 (summation order only; bf16 products are exact in f32).
The selective-scan oracle is held to JAX's at 1e-5 in f32. The ``h100``
target's plans are checked as planning: they fit one block's 232448 B of
shared memory, are four distinct tiles, and plan no more HBM traffic as the
scratchpad fraction grows. The ``cuda`` tests run the kernel on the card
(bf16: atol = rtol = 2e-2; f32: 2e-4 at the small shapes).
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiling as jtiling
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.matmul3d import matmul3d as jmatmul3d
from repro_torch.core import planner, tiling
from repro_torch.core.hw_profiles import H100_SXM
from repro_torch.core.target import get_target, use_target
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.matmul3d import (BARRIER_BYTES, MAX_REG_BLOCK,
                                          N_BUFFERS, SMEM_BYTES, TC_K, TC_M,
                                          TC_N, check_plan, kernel_blocks,
                                          matmul3d, smem_bytes)

torch.set_num_threads(1)
FRACTIONS = (0.125, 0.25, 0.5, 0.75)
M_SWEEP = 8192
SWEEP_SHAPES = [(128, 128, 128), (256, 384, 512), (512, 128, 256),
                (128, 512, 128)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
H100_TILES = {
    2: [(64, 32, 32), (128, 32, 64), (128, 32, 128), (128, 64, 128)],
    4: [(32, 32, 32), (64, 32, 64), (128, 32, 64), (128, 32, 128)],
}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" \
        else dict(rtol=2e-4, atol=2e-4)


def _inputs(m, k, n, name, seed=0):
    rs = np.random.RandomState(seed)
    a = rs.randn(m, k).astype(np.float32)
    b = rs.randn(k, n).astype(np.float32)
    jd, td = DTYPES[name]
    return ((jnp.asarray(a).astype(jd), jnp.asarray(b).astype(jd)),
            (torch.from_numpy(a).to(td), torch.from_numpy(b).to(td)))


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32), np.float64)


# ------------------------------------------------------- matmul vs JAX

@pytest.mark.parametrize("m,k,n", SWEEP_SHAPES)
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_matmul_matches_jax(m, k, n, name):
    (ja, jb), (ta, tb) = _inputs(m, k, n, name)
    plan = jtiling.MatmulPlan(bm=128, bk=128, bn=128)
    want = jref.matmul_ref(ja, jb, jnp.float32)
    pallas = jmatmul3d(ja, jb, plan=plan, out_dtype=jnp.float32,
                       interpret=True)
    got_ref = ref.matmul_ref(ta, tb, torch.float32)
    got_ops = ops.matmul(ta, tb, plan=tiling.MatmulPlan(128, 128, 128),
                         out_dtype=torch.float32, impl="ref")
    for got in (got_ref, got_ops):
        assert got.dtype == torch.float32 and got.shape == (m, n)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
        np.testing.assert_allclose(_np(got), _np(pallas), **_tol(name))


def test_matmul_ref_default_out_dtype_is_input_dtype():
    (ja, jb), (ta, tb) = _inputs(64, 96, 32, "bf16", seed=1)
    got = ref.matmul_ref(ta, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(jref.matmul_ref(ja, jb)),
                               **_tol("bf16"))


def test_matmul_pads_and_crops_like_jax():
    """(200, 300) @ (300, 100) with plan (128, 128, 128): the reference's
    pad-and-crop case through both packages' ops.matmul."""
    (ja, jb), (ta, tb) = _inputs(200, 300, 100, "f32", seed=2)
    want = jops.matmul(ja, jb, plan=jtiling.MatmulPlan(128, 128, 128),
                       impl="pallas")
    got = ops.matmul(ta, tb, plan=tiling.MatmulPlan(128, 128, 128),
                     impl="ref")
    assert got.shape == (200, 100)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(200, 300, 100), (37, 45, 19),
                                   (96, 32, 300)])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_kernel_route_plans_pads_and_crops_on_cpu(m, k, n, name):
    """``impl="kernel"`` under the h100 target: the plan, the clamp to an
    unaligned problem (blocks such as 192 or 37 rows), the padding and the
    crop all run on the CPU; the wrapper then takes its plain version."""
    (ja, jb), (ta, tb) = _inputs(m, k, n, name, seed=3)
    with use_target("h100"):
        plan = planner.matmul_kernel_plan(m, k, n, in_bytes=ta.element_size())
        check_plan(plan, ta.element_size())
        got = ops.matmul(ta, tb, out_dtype=torch.float32, impl="kernel")
    assert got.shape == (m, n)
    np.testing.assert_allclose(_np(got),
                               _np(jref.matmul_ref(ja, jb, jnp.float32)),
                               **_tol(name))


# ---------------------------------------------------- selective scan vs JAX

def _scan_inputs(b, length, di, ds, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, length, di).astype(np.float32) * 0.1
    dt = np.log1p(np.exp(rs.randn(b, length, di))).astype(np.float32) * 0.1
    a = -np.exp(rs.randn(di, ds).astype(np.float32) * 0.1)
    bb = rs.randn(b, length, ds).astype(np.float32) * 0.1
    c = rs.randn(b, length, ds).astype(np.float32) * 0.1
    d = np.ones((di,), np.float32)
    return x, dt, a, bb, c, d


@pytest.mark.parametrize("length,di,ds", [(64, 128, 16), (33, 64, 8)])
def test_selective_scan_ref_matches_jax(length, di, ds):
    args = _scan_inputs(2, length, di, ds, seed=4)
    want = jref.selective_scan_ref(*(jnp.asarray(t) for t in args))
    got = ref.selective_scan_ref(*(torch.from_numpy(t) for t in args))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_selective_scan_state_carry_matches_jax():
    """Split scan (prefix with ``return_state``, rest from ``h0``) against
    the reference's, and against the port's full scan."""
    x, dt, a, bb, c, d = _scan_inputs(2, 48, 64, 16, seed=5)
    half = 20
    parts = []
    for lib, conv in ((jref, jnp.asarray), (ref, torch.from_numpy)):
        y1, h = lib.selective_scan_ref(
            conv(x[:, :half]), conv(dt[:, :half]), conv(a),
            conv(bb[:, :half]), conv(c[:, :half]), conv(d),
            return_state=True)
        y2 = lib.selective_scan_ref(
            conv(x[:, half:]), conv(dt[:, half:]), conv(a),
            conv(bb[:, half:]), conv(c[:, half:]), conv(d), h0=h)
        parts.append((_np(y1), _np(h), _np(y2)))
    for got, want in zip(parts[1], parts[0]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    full = ref.selective_scan_ref(*(torch.from_numpy(t)
                                    for t in (x, dt, a, bb, c, d)))
    np.testing.assert_allclose(
        np.concatenate([parts[1][0], parts[1][2]], axis=1), _np(full),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ h100 target

@pytest.mark.parametrize("in_bytes", [2, 4])
def test_h100_sweep_plans_fit_are_distinct_and_cut_traffic(in_bytes):
    target = get_target("h100")
    assert target.kind == "gpu" and target.scratchpad_bytes == 232448
    plans = [tiling.plan_matmul(M_SWEEP, M_SWEEP, M_SWEEP, in_bytes=in_bytes,
                                partition=target.partition(fraction=f))
             for f in FRACTIONS]
    tiles = [(p.bm, p.bk, p.bn) for p in plans]
    assert tiles == H100_TILES[in_bytes]
    assert len(set(tiles)) == len(FRACTIONS)
    for frac, plan in zip(FRACTIONS, plans):
        part = target.partition(fraction=frac)
        assert part.fits(plan.streamed_bytes(in_bytes), plan.resident_bytes())
        assert plan.vmem_bytes(in_bytes) <= 232448
        assert smem_bytes(plan, in_bytes) <= plan.vmem_bytes(in_bytes)
        check_plan(plan, in_bytes)
    traffic = [p.hbm_traffic_bytes(M_SWEEP, M_SWEEP, M_SWEEP, in_bytes)
               for p in plans]
    assert traffic == sorted(traffic, reverse=True)
    assert traffic[0] > traffic[-1]


def test_h100_alignment_is_the_coarsest_that_keeps_the_sweep():
    """At alignment 64 the 0.125 plan no longer fits its budget."""
    part = dataclasses.replace(get_target("h100").partition(fraction=0.125),
                               align=64)
    plan = tiling.plan_matmul(M_SWEEP, M_SWEEP, M_SWEEP, partition=part)
    assert not part.fits(plan.streamed_bytes(2), plan.resident_bytes())


def test_h100_profile_escape_hatch_and_paper_rule():
    a = tiling.plan_matmul(4096, 4096, 4096, profile=H100_SXM)
    b = tiling.plan_matmul(4096, 4096, 4096,
                           partition=get_target("h100").partition(
                               fraction=0.75))
    assert a == b
    assert [tiling.mempool_tile_size(mib * 2**20) for mib in (1, 2, 4, 8)] \
        == [256, 384, 544, 800]


def test_default_target_is_still_tpu_v5e():
    assert get_target().name == "tpu-v5e"
    with use_target("h100") as t:
        assert get_target() is t
    assert get_target().name == "tpu-v5e"


# ----------------------------------------------------- the kernel's limits

def test_tpu_plans_are_refused_never_clamped():
    """A kernel request planned from tpu-v5e raises with the target and
    the bytes, before any device work (CPU tensors with
    ``impl="kernel"``; meta tensors for the wrapper itself)."""
    _, (ta, tb) = _inputs(256, 256, 256, "bf16", seed=6)
    with pytest.raises(ValueError, match=r"tpu-v5e.*134217728 B.*232448 B"):
        ops.matmul(ta, tb, impl="kernel")
    plan = tiling.plan_matmul(M_SWEEP, M_SWEEP, M_SWEEP,
                              partition=get_target("tpu-v5e").partition())
    assert plan.bm >= 1024
    with pytest.raises(ValueError, match=r"tpu-v5e\): its working set is "
                                         r"\d+ B.*232448 B"):
        ops.matmul(ta, tb, plan=plan, impl="kernel")
    meta = torch.empty((M_SWEEP, M_SWEEP), dtype=torch.bfloat16,
                       device="meta")
    with pytest.raises(ValueError, match="232448 B"):
        matmul3d(meta, meta, plan=plan)


def test_wrapper_checks_what_the_kernel_takes():
    meta = torch.empty((256, 256), dtype=torch.float32, device="meta")
    ok = tiling.MatmulPlan(64, 32, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        matmul3d(meta, meta, plan=ok)
    for n_buffers in (1, 3):
        with pytest.raises(ValueError, match="takes 2 buffers"):
            matmul3d(meta, meta,
                     plan=tiling.MatmulPlan(64, 32, 64, n_buffers=n_buffers))
    with pytest.raises(TypeError, match="two f32 or two bf16"):
        matmul3d(meta, meta.to(torch.bfloat16), plan=ok)
    with pytest.raises(TypeError, match="writes f32 or bf16"):
        matmul3d(meta, meta, plan=ok, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="pad first"):
        matmul3d(meta[:200], meta, plan=ok)


def test_kernel_limits_match_the_cuda_source():
    text = (build.CSRC / "matmul3d.cu").read_text()

    consts = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                 re.M):
        consts[name] = eval(expr, {}, dict(consts))   # integer constants

    def const(name):
        return consts[name]

    assert const("TDIM") * const("MAX_T") == const("MAX_REG_BLOCK") \
        == MAX_REG_BLOCK == 128
    assert const("N_BUFFERS") == N_BUFFERS == 2
    assert const("MAX_SMEM") == SMEM_BYTES == 232448
    assert (const("TC_M"), const("TC_N"), const("TC_K")) \
        == (TC_M, TC_N, TC_K) == (64, 32, 32)
    assert const("BARRIER_BYTES") == BARRIER_BYTES == 32


@pytest.mark.parametrize("source", ["matmul3d.cu", "flash_attention.cu"])
def test_kernel_sources_stay_on_the_tensor_cores(source):
    """Both rebuilt kernels issue wgmma fed by TMA loads paced by mbarriers
    (through the shared header, which must hold the instructions), so a
    later edit cannot quietly drop the tensor cores."""
    text = (build.CSRC / source).read_text()
    header = (build.CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in text
    assert re.search(r"hopper::Wgmma<\w+>::(template )?(ss|rs)", text)
    assert re.search(r"hopper::tma_load_[24]d\(", text)
    assert "hopper::mbar_wait(" in text and "hopper::mbar_expect_tx(" in text
    for instr in ("wgmma.mma_async.sync.aligned", "cp.async.bulk.tensor",
                  "mbarrier.try_wait.parity", "wgmma.fence.sync.aligned"):
        assert instr in header
    assert "hopper.cuh" in [p.name for p in build._sources(source[:-3])]


@pytest.mark.parametrize("m,k,n,plan,blocks", [
    (37, 45, 19, (32, 32, 19), (64, 32, 32)),
    (96, 32, 300, (96, 32, 288), (128, 32, 288)),
    (200, 300, 100, (128, 128, 128), (128, 128, 128)),
    (8192, 8192, 8192, (128, 64, 128), (128, 64, 128)),
])
def test_bf16_blocks_round_up_to_the_tensor_core_grain(m, k, n, plan, blocks):
    """A bf16 plan clamped to a small problem is rounded up to
    64 rows, 32 columns and 32 deep; f32 keeps the clamped blocks. The
    wrapper refuses operands not padded to the rounded blocks and takes
    padded ones (here on the CPU: its plain version, against the oracle)."""
    p = tiling.MatmulPlan(*plan)
    clamped = (min(p.bm, m), min(p.bk, k), min(p.bn, n))
    assert kernel_blocks(p, m, k, n, 2) == blocks
    assert kernel_blocks(p, m, k, n, 4) == clamped
    check_plan(p, 2)
    assert smem_bytes(p, 2) <= SMEM_BYTES
    if m > 1024:
        return
    _, (ta, tb) = _inputs(m, k, n, "bf16", seed=8)
    if blocks != clamped:
        with pytest.raises(ValueError, match="pad first"):
            matmul3d(ta, tb, plan=p, out_dtype=torch.float32)
    bm, bk, bn = blocks
    ap = torch.zeros((-(-m // bm) * bm, -(-k // bk) * bk), dtype=ta.dtype)
    bp = torch.zeros((ap.shape[1], -(-n // bn) * bn), dtype=tb.dtype)
    ap[:m, :k], bp[:k, :n] = ta, tb
    got = matmul3d(ap, bp, plan=p, out_dtype=torch.float32)[:m, :n]
    torch.testing.assert_close(got, ref.matmul_ref(ta, tb, torch.float32),
                               **_tol("bf16"))


@pytest.mark.parametrize("tile", H100_TILES[2])
def test_bf16_sweep_plans_claim_the_plans_ring(tile):
    """The capacity law stays the kernel's own: a bf16 sweep plan's launch
    claims its two buffers of A and B tiles and the mbarriers, no more."""
    plan = tiling.MatmulPlan(*tile)
    assert kernel_blocks(plan, M_SWEEP, M_SWEEP, M_SWEEP, 2) == tile
    assert smem_bytes(plan, 2) == 2 * plan.streamed_bytes(2) + BARRIER_BYTES


# --------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SWEEP_SHAPES + [(200, 300, 100),
                                                  (37, 45, 19),
                                                  (96, 32, 300)])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_matmul3d_kernel_matches_plain_on_card(m, k, n, name):
    dev = _cuda()
    _, (ta, tb) = _inputs(m, k, n, name, seed=7)
    ta, tb = ta.to(dev), tb.to(dev)
    with use_target("h100"):
        before = matmul3d.launches
        got = ops.matmul(ta, tb, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert matmul3d.launches == before + 1
    want = ref.matmul_ref(ta, tb, torch.float32)
    torch.testing.assert_close(got, want, **_tol(name))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", H100_TILES[2] + [(192, 32, 192),
                                                  (256, 64, 128),
                                                  (64, 64, 96)])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_matmul3d_bf16_plans_match_plain_on_card(tile, out):
    """Every h100 bf16 sweep plan (C in registers), two plans whose C tile
    lives in shared memory, and a 96-wide one, at 768 x 512 x (768 or
    576)."""
    dev = _cuda()
    _, (ta, tb) = _inputs(768, 512, 768 if tile[2] != 192 else 576, "bf16",
                          seed=9)
    ta, tb = ta.to(dev), tb.to(dev)
    out_dtype = torch.float32 if out == "f32" else torch.bfloat16
    plan = tiling.MatmulPlan(*tile)
    before = matmul3d.launches
    got = matmul3d(ta, tb, plan=plan, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert matmul3d.launches == before + 1
    torch.testing.assert_close(got.float(), ref.matmul_ref(
        ta, tb, out_dtype).float(), **_tol("bf16"))
