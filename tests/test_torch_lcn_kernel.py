"""The residual map's kernels L1 (forward) and L2 (backward) and the dispatch
of ``GMM.residual_map`` between them and the plain stencils.

On the CPU, float32 and bfloat16 operands and radii without a kernel run
the plain stencils and leave the kernels' launch counters where they were;
``LCNResidual``'s plain backward, the oracle of L2, equals autograd through
the plain forward bit for bit in float32 and passes ``gradcheck`` in
float64.  On the card (the ``cuda`` marker; skipped without one), L1 equals
the plain forward bit for bit and L2 the plain VJP within 1e-6 of the
gradient's largest element, one launch each, at the selftest's shapes (the
pair cells' 8 rows at 128³, one fixed image shared by 2 rows at 256³,
unbatched, ragged, dims of 2 and 1, radius 1 and 2).

Imports only torch and the port, so it runs on a GPU host without JAX:

    python -m pytest tests/test_torch_lcn_kernel.py -q
"""

from types import SimpleNamespace

import pytest
import torch
from torch.utils.checkpoint import checkpoint

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu_torch.kernels import lcn_residual as lr
from ir_sgmcmc_tpu_torch.models import GMM
from ir_sgmcmc_tpu_torch.selftest import LCN_SHAPES, lcn_operands

# (moving shape, one shared fixed image, radius): batched, unbatched, ragged,
# dims of 2 and 1, two leading axes
CPU_SHAPES = [((2, 5, 6, 7), False, 1), ((3, 4, 5, 6), True, 2), ((6, 7, 9), False, 1),
              ((1, 2, 9, 4), True, 1), ((2, 3, 2, 5), False, 2), ((2, 1, 4, 4), False, 1),
              ((2, 2, 3, 4, 5), True, 1)]


def _inputs(shape, shared, device="cpu", dtype=torch.float32, seed=0):
    f, w, g = lcn_operands(torch.Generator(device=device).manual_seed(seed), shape, shared)
    return f.to(dtype), w.to(dtype), g.to(dtype)


def _launches():
    return lr.L1.launches, lr.L2.launches


def _residual_map(f, w, g, radius):
    """``GMM.residual_map`` and its VJP for ``g`` with respect to the moving
    image, and how far L1's and L2's launch counters moved."""
    before = _launches()
    x = w.clone().requires_grad_(True)
    out = GMM(4, radius).residual_map(f, x)
    (grad,) = torch.autograd.grad(out, x, g)
    after = _launches()
    return out.detach(), grad, (after[0] - before[0], after[1] - before[1])


def _plain(f, w, g, radius):
    """The plain forward and autograd's VJP through it."""
    x = w.clone().requires_grad_(True)
    out = lr.lcn_residual_plain(f, x, radius)
    (grad,) = torch.autograd.grad(out, x, g)
    return out.detach(), grad


@pytest.mark.parametrize("shape,shared,radius", CPU_SHAPES)
def test_cpu_float32_runs_the_plain_stencils(shape, shared, radius):
    """A CPU float32 residual map takes the plain stencils and autograd
    through them, bit for bit, and launches neither kernel."""
    f, w, g = _inputs(shape, shared)
    out, grad, moved = _residual_map(f, w, g, radius)
    ref, ref_grad = _plain(f, w, g, radius)
    assert moved == (0, 0)
    assert torch.equal(out, ref)
    assert torch.equal(grad, ref_grad)


@pytest.mark.parametrize("shape,shared,radius", CPU_SHAPES[:3])
def test_bfloat16_runs_the_plain_stencils(shape, shared, radius):
    """A bfloat16 residual map keeps the plain stencils in bfloat16, bit for
    bit, and launches neither kernel (bfloat16 has no kernel mode)."""
    f, w, g = _inputs(shape, shared, dtype=torch.bfloat16)
    out, grad, moved = _residual_map(f, w, g, radius)
    ref, ref_grad = _plain(f, w, g, radius)
    assert moved == (0, 0)
    assert out.dtype == grad.dtype == torch.bfloat16
    assert torch.equal(out, ref)
    assert torch.equal(grad, ref_grad)


def test_dispatch_follows_device_dtype_and_radius():
    """The kernels take float32 operands on the card at a radius they were
    built for (1 and 2), and nothing else: a radius of 3, a bfloat16 side or
    a CPU tensor keeps the plain stencils (as ``GMM(4, 3)`` does here)."""
    card = SimpleNamespace(is_cuda=True, dtype=torch.float32)
    assert lr.on_kernels(card, card, 1) and lr.on_kernels(card, card, 2)
    assert not lr.on_kernels(card, card, 3)
    assert not lr.on_kernels(card, SimpleNamespace(is_cuda=True, dtype=torch.bfloat16), 1)
    assert not lr.on_kernels(SimpleNamespace(is_cuda=True, dtype=torch.bfloat16), card, 1)
    f, w, g = _inputs((2, 7, 8, 9), False)
    assert not lr.on_kernels(f, w, 1)
    out, grad, moved = _residual_map(f, w, g, 3)
    assert moved == (0, 0)
    ref, ref_grad = _plain(f, w, g, 3)
    assert torch.equal(out, ref) and torch.equal(grad, ref_grad)


@pytest.mark.parametrize("shape,shared,radius", CPU_SHAPES)
def test_plain_vjp_is_autograd_s_to_the_bit(shape, shared, radius):
    """``LCNResidual`` on the CPU (its plain forward and the plain VJP that
    L2 follows) against the plain forward and autograd through it, in
    float32: equal bit for bit, so the plain VJP adds in autograd's order."""
    f, w, g = _inputs(shape, shared, seed=1)
    before = _launches()
    x = w.clone().requires_grad_(True)
    out = lr.LCNResidual.apply(f, x, radius)
    (grad,) = torch.autograd.grad(out, x, g)
    assert _launches() == before
    ref, ref_grad = _plain(f, w, g, radius)
    assert torch.equal(out.detach(), ref)
    assert torch.equal(grad, ref_grad)
    dm, s = lr.lcn_parts(w, radius)
    assert torch.equal(lr.lcn_residual_vjp_plain(dm, s, g, radius), ref_grad)


@pytest.mark.parametrize("shape,radius", [((2, 3, 4, 5), 1), ((1, 2, 3, 6), 2), ((3, 3, 4), 1)])
def test_function_gradcheck_float64(shape, radius):
    """The plain backward of ``LCNResidual`` is the forward's derivative:
    ``gradcheck`` in float64 (no flat region: a var near 0 makes the finite
    differences meaningless)."""
    gen = torch.Generator().manual_seed(2)
    f = torch.randn(shape, generator=gen, dtype=torch.float64)
    w = torch.randn(shape, generator=gen, dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x: lr.LCNResidual.apply(f, x, radius), (w,))


def test_function_under_checkpoint_on_the_cpu():
    """Under non-reentrant ``torch.utils.checkpoint`` (the remat VI step's),
    which drops the saved ``dm`` and ``s`` and recomputes them, the
    gradient equals the unchecked one."""
    f, w, g = _inputs((2, 6, 7, 8), False, seed=3)
    x = w.clone().requires_grad_(True)
    out = checkpoint(lambda t: lr.LCNResidual.apply(f, t, 1), x, use_reentrant=False)
    (grad,) = torch.autograd.grad(out, x, g)
    _, ref_grad = _plain(f, w, g, 1)
    assert torch.equal(grad, ref_grad)


@pytest.mark.parametrize("fixed_shape,warped_shape,radius,match", [
    ((4, 5), (2, 4, 5), 1, "of one size"), ((2, 4, 5, 6), (2, 4, 5, 7), 1, "of one size"),
    ((3, 4, 5, 6), (2, 4, 5, 6), 1, "one \\(D, H, W\\) image"),
    ((2, 4, 5, 6), (2, 4, 5, 6), 3, "radius 3"), ((4, 5, 6), (2, 4, 5, 6), 1, "CUDA")])
def test_forward_wrapper_rejects_bad_operands(fixed_shape, warped_shape, radius, match):
    """Before any launch: volumes of one size, a fixed image per row or one
    for all, a built radius, then float32 operands on the card."""
    before = _launches()
    with pytest.raises(ValueError, match=match):
        lr.lcn_residual_fwd_cuda(torch.zeros(fixed_shape), torch.zeros(warped_shape), radius)
    assert _launches() == before


@pytest.mark.parametrize("radius,dtype,match", [(3, torch.float32, "radius 3"),
                                                (1, torch.float32, "CUDA"),
                                                (1, torch.float64, "CUDA")])
def test_backward_wrapper_rejects_bad_operands(radius, dtype, match):
    before = _launches()
    t = torch.zeros((2, 4, 5, 6), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        lr.lcn_residual_bwd_cuda(t, t, t, radius)
    assert _launches() == before


def test_fixed_image_takes_no_gradient():
    """``LCNResidual`` refuses a fixed image that requires a gradient: the
    fixed image is data, and the kernels return none for it."""
    f, w, _ = _inputs((2, 4, 5, 6), False)
    with pytest.raises(ValueError, match="fixed"):
        lr.LCNResidual.apply(f.requires_grad_(True), w, 1)


# ---- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _within(grad, ref):
    return float((grad - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,shared,radius", LCN_SHAPES)
def test_kernels_match_the_plain_stencils(cuda, shape, shared, radius):
    """Through ``GMM.residual_map`` on the card: L1 and L2 launched once
    each, L1 equal to the plain forward bit for bit, L2 to autograd's VJP
    through it within 1e-6 of the gradient's largest element (both on the
    card)."""
    f, w, g = _inputs(shape, shared, cuda)
    out, grad, moved = _residual_map(f, w, g, radius)
    assert moved == (1, 1)
    ref, ref_grad = _plain(f, w, g, radius)
    assert torch.equal(out, ref)
    assert _within(grad, ref_grad)


@pytest.mark.cuda
def test_kernels_are_deterministic_and_take_strided_operands(cuda):
    """Two launches agree bitwise; transposed (non-contiguous) operands are
    made contiguous first and give the same results; without ``stats`` L1
    writes the residual alone."""
    f, w, g = _inputs((2, 17, 24, 40), False, cuda)
    res, dm, s = lr.lcn_residual_fwd_cuda(f, w, 1)
    again = lr.lcn_residual_fwd_cuda(f, w, 1)
    assert all(torch.equal(a, b) for a, b in zip((res, dm, s), again))
    assert torch.equal(lr.lcn_residual_bwd_cuda(dm, s, g, 1), lr.lcn_residual_bwd_cuda(dm, s, g, 1))
    wt = w.transpose(0, 1).contiguous().transpose(0, 1)
    assert not wt.is_contiguous()
    assert torch.equal(lr.lcn_residual_fwd_cuda(f, wt, 1)[0], res)
    alone = lr.lcn_residual_fwd_cuda(f, w, 1, stats=False)
    assert torch.equal(alone[0], res) and alone[1] is None and alone[2] is None


@pytest.mark.cuda
def test_no_grad_residual_map_launches_l1_alone(cuda):
    """Without a gradient to feed (the trainer's outputs), the residual map
    launches L1 once, saves nothing, and gives the plain result."""
    f, w, _ = _inputs((2, 16, 24, 40), True, cuda)
    before = _launches()
    with torch.no_grad():
        out = GMM(4, 1).residual_map(f, w)
    assert (lr.L1.launches - before[0], lr.L2.launches - before[1]) == (1, 0)
    assert torch.equal(out, lr.lcn_residual_plain(f, w, 1))


@pytest.mark.cuda
def test_plain_paths_on_the_card(cuda):
    """bfloat16 operands and a radius without a kernel keep the plain
    stencils on the card: no launch, the plain results."""
    for dtype, radius in ((torch.bfloat16, 1), (torch.float32, 3)):
        f, w, g = _inputs((2, 8, 12, 40), False, cuda, dtype)
        out, grad, moved = _residual_map(f, w, g, radius)
        assert moved == (0, 0)
        ref, ref_grad = _plain(f, w, g, radius)
        assert torch.equal(out, ref) and torch.equal(grad, ref_grad)


@pytest.mark.cuda
def test_fixed_requiring_a_gradient_raises_on_the_card(cuda):
    f, w, _ = _inputs((2, 8, 12, 40), False, cuda)
    with pytest.raises(ValueError, match="fixed"):
        GMM(4, 1).residual_map(f.requires_grad_(True), w)


@pytest.mark.cuda
def test_checkpointed_gradient_equals_the_unchecked_one(cuda):
    """Under non-reentrant ``torch.utils.checkpoint`` (``make_vi_step(remat=
    True)``) the saved ``dm`` and ``s`` are dropped and L1 reruns in the
    backward: L1 twice, L2 once, the gradient equal to the unchecked one."""
    f, w, g = _inputs((1, 32, 40, 48), True, cuda, seed=4)
    _, ref_grad, _ = _residual_map(f, w, g, 1)
    before = _launches()
    x = w.clone().requires_grad_(True)
    out = checkpoint(lambda t: GMM(4, 1).residual_map(f, t), x, use_reentrant=False)
    (grad,) = torch.autograd.grad(out, x, g)
    assert (lr.L1.launches - before[0], lr.L2.launches - before[1]) == (2, 1)
    assert torch.equal(grad, ref_grad)


@pytest.mark.cuda
def test_kernel_names_fall_under_no_kind(cuda):
    """The profiler's names of L1's and L2's device kernels match no pattern
    of the trace's kinds (``scripts/trace_summary.py``): they count as
    neither PyTorch's plain kernels nor B1-B7."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from ir_sgmcmc_tpu_torch.scripts.trace_summary import KINDS

    f, w, g = _inputs((2, 16, 24, 40), False, cuda)
    _, dm, s = lr.lcn_residual_fwd_cuda(f, w, 1)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            lr.lcn_residual_fwd_cuda(f, w, 1)
            lr.lcn_residual_bwd_cuda(dm, s, g, 1)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    assert any("lcn_fwd_kernel" in n for n in names), names
    assert any("lcn_bwd_kernel" in n for n in names), names
    for n in names:
        assert not any(pat in n for pat, _ in KINDS), n
