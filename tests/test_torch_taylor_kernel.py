"""The Taylor squaring's kernels T1 (forward) and T2 (backward) and the
dispatch of ``ops.stencil.TaylorSquaringStep`` between them and the plain
stencils.

On the CPU, float32 and bfloat16 fields run the plain stencils and leave
the kernels' launch counters where they were.  On the card (the ``cuda``
marker; skipped without one), T1 equals the plain forward bit for bit and
T2 the plain VJP within 1e-6 of the gradient's largest element, each
launch counted once, at the main path's shape, unbatched, ragged, with
dimensions of 2 and with two leading axes; the D-sharded step on two
virtual shards of the card equals the unsharded one.

Imports only torch and the port, so it runs on a GPU host without JAX:

    python -m pytest tests/test_torch_taylor_kernel.py -q
"""

import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu_torch.kernels import taylor_square as ts
from ir_sgmcmc_tpu_torch.ops import stencil as st
from ir_sgmcmc_tpu_torch.selftest import TAYLOR_SHAPES

# the selftest's shapes (the main paths' 2 and 8 chain rows at 128³,
# unbatched, ragged, each of D, H, W at 2, two leading axes) and one more
# ragged one
CARD_SHAPES = list(TAYLOR_SHAPES) + [(2, 3, 5, 6, 11)]
CPU_SHAPES = [(3, 7, 9, 10), (2, 3, 5, 6, 11), (2, 2, 3, 4, 4, 4)]


def _inputs(shape, device="cpu", dtype=torch.float32, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    d = torch.randn(shape, generator=gen, device=device) * 0.7
    g = torch.randn(shape, generator=gen, device=device)
    return d.to(dtype), g.to(dtype)


def _step(d, g):
    """``TaylorSquaringStep`` forward and its VJP for ``g``, and how far
    each of T1's and T2's launch counters moved."""
    before = (ts.T1.launches, ts.T2.launches)
    x = d.clone().requires_grad_(True)
    out = st.TaylorSquaringStep.apply(x)
    (grad,) = torch.autograd.grad(out, x, g)
    return out.detach(), grad, (ts.T1.launches - before[0], ts.T2.launches - before[1])


@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_cpu_float32_runs_the_plain_stencils(shape):
    """A CPU float32 field takes the plain forward and VJP, bit for bit, and
    launches neither kernel."""
    d, g = _inputs(shape)
    out, grad, moved = _step(d, g)
    assert moved == (0, 0)
    assert torch.equal(out, st._taylor_squaring_impl(d))
    assert torch.equal(grad, st._taylor_squaring_vjp_impl(d, g))


@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_bfloat16_runs_the_plain_stencils(shape):
    """A bfloat16 field takes the plain stencils in bfloat16, bit for bit,
    and launches neither kernel (bfloat16 has no kernel mode)."""
    d, g = _inputs(shape, dtype=torch.bfloat16)
    out, grad, moved = _step(d, g)
    assert moved == (0, 0)
    assert out.dtype == grad.dtype == torch.bfloat16
    assert torch.equal(out, st._taylor_squaring_impl(d))
    assert torch.equal(grad, st._taylor_squaring_vjp_impl(d, g))


@pytest.mark.parametrize("shape", [(3, 2, 2, 2), (2, 3, 5, 6, 7), (1, 3, 2, 9, 4)])
def test_plain_vjp_is_the_forward_s_vjp(shape):
    """The Jacobian-free VJP that T2 computes is the VJP of the forward:
    against autograd through the plain forward in float64, dimensions of 2
    (both edge folds at one plane) included."""
    d, g = (t.double() for t in _inputs(shape, seed=1))
    x = d.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(st._taylor_squaring_impl(x), x, g)
    torch.testing.assert_close(st._taylor_squaring_vjp_impl(d, g), ref, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("shape,dtype,match", [
    ((3, 8, 8), torch.float32, r"3, D, H, W"), ((2, 4, 8, 8, 8), torch.float32, r"3, D, H, W"),
    ((1, 3, 1, 8, 8), torch.float32, "at least 2"), ((1, 3, 8, 8, 1), torch.float32, "at least 2"),
    ((1, 3, 4, 4, 4), torch.float32, "CUDA"), ((1, 3, 4, 4, 4), torch.float64, "CUDA")])
def test_wrappers_reject_bad_fields(shape, dtype, match):
    """Before any launch: the channel axis must hold 3 and D, H, W at least
    2 (the forward difference needs two planes), then the field must be on
    the card."""
    before = (ts.T1.launches, ts.T2.launches)
    d = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        ts.taylor_square_fwd_cuda(d)
    with pytest.raises(ValueError, match=match):
        ts.taylor_square_bwd_cuda(d, d)
    assert (ts.T1.launches, ts.T2.launches) == before


# ---- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_the_plain_stencils(cuda, shape):
    """Through ``TaylorSquaringStep`` on the card: T1 and T2 launched once
    each, T1 equal to the plain forward bit for bit, T2 within 1e-6 of the
    gradient's largest element of the plain VJP (both on the card)."""
    d, g = _inputs(shape, cuda)
    out, grad, moved = _step(d, g)
    assert moved == (1, 1)
    assert torch.equal(out, st._taylor_squaring_impl(d))
    ref = st._taylor_squaring_vjp_impl(d, g)
    assert float((grad - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.cuda
def test_bfloat16_on_the_card_runs_the_plain_stencils(cuda):
    """``compute_dtype: "bfloat16"`` fields keep the plain stencils on the
    card: no launch, the plain results."""
    d, g = _inputs((2, 3, 8, 12, 40), cuda, torch.bfloat16)
    out, grad, moved = _step(d, g)
    assert moved == (0, 0)
    assert torch.equal(out, st._taylor_squaring_impl(d))
    assert torch.equal(grad, st._taylor_squaring_vjp_impl(d, g))


@pytest.mark.cuda
def test_kernels_are_deterministic_and_take_strided_operands(cuda):
    """Two launches agree bitwise; a transposed (non-contiguous) field is
    made contiguous first and gives the same result."""
    d, g = _inputs((2, 3, 17, 24, 40), cuda)
    assert torch.equal(ts.taylor_square_fwd_cuda(d), ts.taylor_square_fwd_cuda(d))
    assert torch.equal(ts.taylor_square_bwd_cuda(d, g), ts.taylor_square_bwd_cuda(d, g))
    dt = d.transpose(0, 1).contiguous().transpose(0, 1)
    assert not dt.is_contiguous()
    assert torch.equal(ts.taylor_square_fwd_cuda(dt), ts.taylor_square_fwd_cuda(d))


@pytest.mark.cuda
def test_kernel_names_fall_under_no_kind(cuda):
    """The profiler's names of T1's and T2's device kernels match no pattern
    of the trace's kinds (``scripts/trace_summary.py``): they count as
    neither PyTorch's plain kernels nor B1-B7."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from ir_sgmcmc_tpu_torch.scripts.trace_summary import KINDS

    d, g = _inputs((2, 3, 16, 24, 40), cuda)
    ts.taylor_square_bwd_cuda(d, g)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            ts.taylor_square_fwd_cuda(d)
            ts.taylor_square_bwd_cuda(d, g)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    assert any("taylor_sq_fwd_kernel" in n for n in names), names
    assert any("taylor_sq_bwd_kernel" in n for n in names), names
    for n in names:
        assert not any(pat in n for pat, _ in KINDS), n


@pytest.mark.cuda
def test_sharded_squaring_on_virtual_shards_matches_unsharded(cuda):
    """``parallel.halo.taylor_squaring_slabs`` on 2 virtual shards of the
    card (each slab but the last closed on its neighbour's first plane, T1
    and T2 once per slab) against the unsharded kernel step: the forward
    bit for bit, the gradient within 1e-6 of its largest element (the halo
    plane's share is added in another order)."""
    from ir_sgmcmc_tpu_torch.parallel import gather, make_mesh, taylor_squaring_sharded

    d, g = _inputs((2, 3, 16, 24, 40), cuda, seed=3)
    mesh = make_mesh(2, axes=("space",), devices=[cuda, cuda])
    before = (ts.T1.launches, ts.T2.launches)
    x = d.clone().requires_grad_(True)
    out = gather(taylor_squaring_sharded(x, mesh))
    (grad,) = torch.autograd.grad(out, x, g)
    assert (ts.T1.launches - before[0], ts.T2.launches - before[1]) == (2, 2)
    ref, ref_grad, _ = _step(d, g)
    assert torch.equal(out.detach(), ref)
    assert float((grad - ref_grad).abs().max()) <= 1e-6 * float(ref_grad.abs().max())
