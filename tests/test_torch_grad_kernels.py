"""The kernels' autograd Functions (``FlashAttention``, ``GroupedGemm``,
``MambaScan``) and the card's ``dot_f32`` Function.

On the CPU each Function is handed its kernel's plain forward and passes
``torch.autograd.gradcheck`` in f64 at tiny shapes (gradcheck's own
tolerances: atol 1e-5, rtol 1e-3 against central differences of eps
1e-6), with GQA, causal / windowed / offset masks, an expert without rows
and rows past the last offset, and a scan over several states. The ops
layer takes a Function only under autograd; a CPU grouped GEMM under
autograd takes its Function too (``F.grouped_mm`` has no CPU backward),
and a carried-state scan under autograd is refused.

``cuda``-marked cases (skipped without a card) run each Function with the
kernel forward at small shapes and hold its output and gradients against
autograd through the plain version within 2e-2 of each gradient's largest
value (bf16 operands); the kernels' launch counts rise by one a forward
and the plain scan is never called in the forward. This file imports no
JAX, so the card's cases can run where JAX is absent.
"""

import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.tiling import ScanChunkPlan
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention,
                                                 flash_attention_plain,
                                                 flash_attention_plain_vjp)
from repro_torch.kernels.grouped_gemm import (GroupedGemm, grouped_gemm,
                                              grouped_gemm_plain,
                                              grouped_gemm_plain_vjp)
from repro_torch.kernels.mamba_scan import (MambaScan, mamba_scan,
                                            mamba_scan_plain,
                                            mamba_scan_plain_vjp)
from repro_torch.models import layers

CARD_TOL = 2e-2


def _f64(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, dtype=torch.float64)
            * scale).requires_grad_()


@pytest.mark.parametrize("case", [
    dict(causal=True, window=None, q_offset=0, sq=5, skv=5),
    dict(causal=True, window=3, q_offset=2, sq=4, skv=7),
    dict(causal=False, window=None, q_offset=0, sq=3, skv=6),
], ids=["causal", "window-offset", "cross"])
def test_flash_function_gradcheck_with_the_plain_forward(case):
    gen = torch.Generator().manual_seed(0)
    q = _f64(gen, 1, 4, case["sq"], 8)
    k = _f64(gen, 1, 2, case["skv"], 8)
    v = _f64(gen, 1, 2, case["skv"], 6)                      # Dv != D
    calls = flash_attention_plain_vjp.calls

    def fn(q, k, v):
        return FlashAttention.apply(q, k, v, case["causal"], case["window"],
                                    0.3, case["q_offset"],
                                    flash_attention_plain)

    assert torch.autograd.gradcheck(fn, (q, k, v))
    assert flash_attention_plain_vjp.calls > calls


def test_grouped_function_gradcheck_with_the_plain_forward():
    gen = torch.Generator().manual_seed(1)
    xs, w = _f64(gen, 10, 8), _f64(gen, 3, 8, 6)
    offs = torch.tensor([3, 3, 9], dtype=torch.int32)  # expert 1 empty, row 9 out

    def fn(xs, w):
        return GroupedGemm.apply(xs, w, offs, grouped_gemm_plain)

    assert torch.autograd.gradcheck(fn, (xs, w))
    dxs, dw = grouped_gemm_plain_vjp(xs, w, offs, torch.ones(10, 6,
                                                             dtype=torch.float64))
    assert not dxs[9].any() and not dw[1].any()


def test_mamba_function_gradcheck_with_the_plain_forward():
    gen = torch.Generator().manual_seed(2)
    x = _f64(gen, 2, 5, 3)
    dt = F.softplus(torch.randn(2, 5, 3, generator=gen,
                                dtype=torch.float64)).requires_grad_()
    a = (-torch.rand(3, 4, generator=gen, dtype=torch.float64) - 0.5
         ).requires_grad_()
    b, c, d = _f64(gen, 2, 5, 4), _f64(gen, 2, 5, 4), _f64(gen, 3)
    calls = mamba_scan_plain_vjp.calls

    def fn(*t):
        return MambaScan.apply(*t, mamba_scan_plain)

    assert torch.autograd.gradcheck(fn, (x, dt, a, b, c, d))
    assert mamba_scan_plain_vjp.calls > calls


def test_cpu_grouped_matmul_under_autograd_takes_its_function():
    """A CPU grouped GEMM under autograd differentiates through
    ``GroupedGemm`` (no ``F.grouped_mm`` backward): its gradients equal the
    per-expert products' (f32 sums of bf16 operands, rtol 1e-5)."""
    gen = torch.Generator().manual_seed(3)
    xs = torch.randn(12, 16, generator=gen).bfloat16().requires_grad_()
    w = torch.randn(4, 16, 8, generator=gen).bfloat16().requires_grad_()
    offs = torch.tensor([2, 7, 7, 12], dtype=torch.int32)
    g = torch.randn(12, 8, generator=gen)
    calls = grouped_gemm_plain_vjp.calls
    out = ops.grouped_matmul(xs, w, offs)
    dxs, dw = torch.autograd.grad(out, (xs, w), g)
    assert grouped_gemm_plain_vjp.calls == calls + 1
    xf, wf = xs.detach().float().requires_grad_(), \
        w.detach().float().requires_grad_()
    want = torch.cat([xf[lo:hi] @ wf[e] for e, lo, hi in
                      ((0, 0, 2), (1, 2, 7), (3, 7, 12))])
    torch.testing.assert_close(out, want.detach(), rtol=1e-5, atol=1e-5)
    wx, ww = torch.autograd.grad(want, (xf, wf), g)
    torch.testing.assert_close(dxs.float(), wx.bfloat16().float())
    torch.testing.assert_close(dw.float(), ww.bfloat16().float())


def test_a_carried_state_in_place_under_autograd_is_refused():
    x = torch.randn(1, 4, 3, requires_grad=True)
    a, d = -torch.ones(3, 2), torch.ones(3)
    bc = torch.randn(1, 4, 2)
    h0 = torch.zeros(1, 3, 2)
    with pytest.raises(ValueError, match="state_in_place"):
        ops.selective_scan(x, x.abs(), a, bc, bc, d, h0=h0,
                           return_state=True, state_in_place=True)
    with torch.no_grad():               # serving: in place, no graph
        ops.selective_scan(x, x.abs(), a, bc, bc, d, h0=h0,
                           return_state=True, state_in_place=True)


# ------------------------------------------------------------------- card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close_grads(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        err = (a.float() - b.float()).abs().max().item()
        top = b.float().abs().max().item()
        assert err <= CARD_TOL * max(top, 1e-6), (what, i, err, top)


def _bf16(gen, dev, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale
            ).bfloat16().requires_grad_()


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(128, 128), (192, 128), (64, 64)])
def test_flash_function_kernel_forward_on_card(dims):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(4)
    d, dv = dims
    q = _bf16(gen, dev, 2, 8, 128, d)
    k, v = _bf16(gen, dev, 2, 2, 128, d), _bf16(gen, dev, 2, 2, 128, dv)
    g = torch.randn(2, 8, 128, dv, generator=gen, device=dev).bfloat16()
    before = flash_attention.launches
    out = ops.attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    got = torch.autograd.grad(out, (q, k, v), g)
    want_out = flash_attention_plain(q, k, v, causal=True)
    want = torch.autograd.grad(want_out, (q, k, v), g)
    _close_grads([out], [want_out], "out")
    _close_grads(got, want, "dq, dk, dv")


@pytest.mark.cuda
def test_grouped_function_kernel_forward_on_card():
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    xs = _bf16(gen, dev, 256, 128)
    w = _bf16(gen, dev, 8, 128, 64, scale=0.1)
    offs = torch.tensor([16, 16, 80, 100, 180, 200, 240, 250],
                        dtype=torch.int32, device=dev)
    g = torch.randn(256, 64, generator=gen, device=dev)
    before = grouped_gemm.launches
    out = ops.grouped_matmul(xs, w, offs)
    assert grouped_gemm.launches == before + 1
    got = torch.autograd.grad(out, (xs, w), g)
    xf = xs.detach().float().requires_grad_()
    wf = w.detach().float().requires_grad_()
    want_out = torch.zeros(256, 64, device=dev)
    bounds = [0] + offs.tolist()
    for e in range(8):
        lo, hi = bounds[e], bounds[e + 1]
        want_out[lo:hi] = xf[lo:hi] @ wf[e]
    want = torch.autograd.grad(want_out, (xf, wf), g)
    # rows at or past offs[E-1] (250) are not computed, and get no gradient
    _close_grads([out[:250]], [want_out[:250]], "out")
    _close_grads(got, want, "dxs, dw")
    assert not got[0][250:].any()


@pytest.mark.cuda
def test_mamba_function_kernel_forward_on_card():
    from repro_torch.core.target import use_target
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(6)
    x = _bf16(gen, dev, 1, 128, 256)
    dt = F.softplus(torch.randn(1, 128, 256, generator=gen, device=dev)
                    - 3).requires_grad_()
    a = (-torch.rand(256, 16, generator=gen, device=dev) - 0.5
         ).requires_grad_()
    b, c = _bf16(gen, dev, 1, 128, 16), _bf16(gen, dev, 1, 128, 16)
    d = torch.ones(256, device=dev, requires_grad=True)
    g = torch.randn(1, 128, 256, generator=gen, device=dev).bfloat16()
    before, plain = mamba_scan.launches, mamba_scan_plain.calls
    with use_target("h100"):
        y = ops.selective_scan(x, dt, a, b, c, d, plan=ScanChunkPlan(64))
    assert mamba_scan.launches == before + 1
    assert mamba_scan_plain.calls == plain
    got = torch.autograd.grad(y, (x, dt, a, b, c, d), g)
    want_y = ref.selective_scan_ref(x, dt, a, b, c, d)
    want = torch.autograd.grad(want_y, (x, dt, a, b, c, d), g)
    _close_grads([y], [want_y], "y")
    _close_grads(got, want, "dx, ddt, da, db, dc, dd")


@pytest.mark.cuda
def test_dot_f32_function_on_card():
    """The card's f32-output GEMM under autograd: forward bit for bit the
    serving GEMM, dx and dw within 2e-2 of the f32 products' largest
    value (the cotangent is rounded to bf16)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(7)
    x = _bf16(gen, dev, 4, 32, 256)
    w = _bf16(gen, dev, 256, 384, scale=0.05)
    out = layers.dot_f32(x, w)
    with torch.no_grad():
        assert torch.equal(out, layers.dot_f32(x, w))
    g = torch.randn(out.shape, generator=gen, device=dev)
    got = torch.autograd.grad(out, (x, w), g)
    xf = x.detach().float().requires_grad_()
    wf = w.detach().float().requires_grad_()
    want = torch.autograd.grad(xf @ wf, (xf, wf), g)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    _close_grads(got, want, "dx, dw")
