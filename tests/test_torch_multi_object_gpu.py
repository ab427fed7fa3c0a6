"""On the card: the deterministic bilinear upsample, bitwise repeats of the
multi-object joint step, and K2 (the grouped flagship kernel) on the
multi-object children's fused fit.

Imports no JAX, so it runs where the card is:
``python3 -m pytest --noconftest -q tests/test_torch_multi_object_gpu.py``.
Without a card its tests skip."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from awesome_tpu_torch.core import grids as TG
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.fit.prior_fit import FitConfig, fit_multi_object_priors
from awesome_tpu_torch.fit.trainer import (
    JointTrainConfig,
    make_multi_object_train_step,
    multi_object_train_init,
)
from awesome_tpu_torch.nn.conv import upsample_bilinear_2x
from awesome_tpu_torch.nn.multi_prior import MultiPriorModule
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)
from awesome_tpu_torch.nn.seg import UNet
from awesome_tpu_torch.nn.wrapper import WrapperModule
from awesome_tpu_torch.ops import flagship as TP
from torch_one_thread import one_torch_thread  # noqa: F401

HIST_RTOL = 2e-4  # the fit tolerance of tests/test_fused_fit.py
# tests/test_torch_kernel_gpu.py's tolerances of the kernel against its
# plain version
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 5e-4, 1e-6


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run: skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _bench(shape, device):
    return t_factory(channels=2, hidden_units=32, flow_n_flows=12,
                     flow_output_fn="tanh", spatial_shape=shape,
                     convex_net_hidden_units=130, convex_net_hidden_layers=2,
                     device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 30, 40, 64), (2, 7, 5, 512),
                                   (1, 1, 3, 2)])
def test_upsample_matches_interpolate_and_repeats(cuda_device, shape):
    """The stencil upsample against ``F.interpolate`` (bilinear, half-pixel
    centres) forward and backward at fp32 tolerance; two backward passes
    bitwise equal."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen).to(cuda_device)
    g = torch.randn((shape[0], 2 * shape[1], 2 * shape[2], shape[3]),
                    generator=gen).to(cuda_device)

    def run(fn):
        xx = x.clone().requires_grad_(True)
        y = fn(xx)
        gx, = torch.autograd.grad(y, xx, g)
        return y, gx

    y, gx = run(upsample_bilinear_2x)
    y2, gx2 = run(upsample_bilinear_2x)
    ref, gref = run(lambda t: F.interpolate(
        t.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1))
    assert torch.equal(y, y2) and torch.equal(gx, gx2)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gx, gref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_multi_object_step_repeats_bitwise(cuda_device):
    """Two multi-object joint steps from one state (full-width UNet(4, 2),
    two bench-model children per frame, 64x64, batch 2, one slot active on
    one frame) are bitwise equal in every leaf: with only the settings of
    the package's import (the default a user gets), and with
    ``torch.use_deterministic_algorithms(True)`` (a nondeterministic op
    raises), where they equal the default's too."""
    h = w = 64
    wrapper = WrapperModule(
        segmentation_module=UNet(in_chn=4, out_chn=2, device=cuda_device),
        prior_module=MultiPriorModule(_bench((h, w), cuda_device), 2),
        input_mode="image", prior_arg_mode="param_clean_grid",
        seg_stateful=True)
    cfg = JointTrainConfig()
    state = multi_object_train_init(wrapper, torch.Generator().manual_seed(1),
                                    3, cfg)
    state = state._replace(active=torch.tensor(
        [[True, False], [True, True], [True, False]], device=cuda_device))
    gen = torch.Generator().manual_seed(2)
    batch = {
        "image": torch.rand((2, h, w, 3), generator=gen),
        "features": torch.rand((2, h, w, 1), generator=gen),
        "target_obj": (torch.rand((2, h, w, 2), generator=gen) > 0.2)
        .float(),
        "labeled": torch.rand((2, h, w), generator=gen) < 0.3,
    }
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    batch["grid"] = TG.flatten_grid(TG.pixel_grid((h, w), device=cuda_device))
    batch["index"] = torch.tensor([1, 2], device=cuda_device)
    step = make_multi_object_train_step(wrapper, cfg)
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        runs = [step(state, batch), step(state, batch)]
        torch.use_deterministic_algorithms(True)
        runs += [step(state, batch), step(state, batch)]
    finally:
        torch.use_deterministic_algorithms(det)
    (a, ma) = runs[0]
    assert torch.isfinite(ma["loss"])
    pa = TT.tree_flatten_with_path(a)
    for i, (b, mb) in enumerate(runs[1:], 1):
        assert torch.equal(ma["loss"], mb["loss"]), i
        pb = TT.tree_flatten_with_path(b)
        assert [p for p, _ in pa] == [p for p, _ in pb]
        for (path, x), (_, y) in zip(pa, pb):
            assert (x is None and y is None) or torch.equal(x, y), (i, path)
    # the inactive slot of frame 2 did not move
    for new, old in zip(TT.tree_leaves(a.prior_params),
                        TT.tree_leaves(state.prior_params)):
        assert torch.equal(new[2, 1], old[2, 1])


def _disk_children(model, device, t=8, k=2, h=64, w=64):
    """The children's fit inputs at the smoke's G = t x k: perturbed
    children (T, K, ...), the pixel grid, a disk per slot as its targets
    (T, K, N, 1) with fg = 0."""
    n = h * w
    gen = torch.Generator().manual_seed(3)
    children = TT.stack_trees([TT.stack_trees([
        TT.tree_map(lambda a: a + 0.05 * torch.randn(
            a.shape, generator=gen).to(a.device), model.init(gen))
        for _ in range(k)]) for _ in range(t)])
    pts = TG.flatten_grid(TG.pixel_grid((h, w), device=device))
    yy, xx = np.mgrid[0:h, 0:w]
    tgt = np.ones((t, k, n, 1), np.float32)
    for i in range(t):
        for j in range(k):
            fg = ((yy - 20 - 20 * j) ** 2 + (xx - 20 - 2 * i) ** 2) < 100
            tgt[i, j, :, 0] = 1.0 - fg.ravel()
    return children, pts, torch.tensor(tgt, device=device)


@pytest.mark.gpu
def test_k2_multi_object_fit_matches_plain(cuda_device):
    """The children's fused fit at G = 16 (8 frames x 2 slots at 64x64,
    the smoke's shape) with the active slots as ``valid_mask``: one K2
    launch a step, the inactive slots bitwise as they were, and the
    active slots' loss history within the fit tolerance of the plain
    (autograd) route's on the card. (K2 alone at G = 16 against its plain
    version: ``tests/test_torch_kernel_gpu.py``.)"""
    t, k = 8, 2
    model = _bench((64, 64), cuda_device)
    children, pts, tgt = _disk_children(model, cuda_device, t, k)
    valid = torch.zeros((t, k), dtype=torch.bool, device=cuda_device)
    valid[:, 0] = True
    valid[3, 1] = True
    cfg = FitConfig(num_steps=10, lr=1e-3, weight_mode="equal",
                    nan_guard_grads=False)
    before = TP.flagship_loss_grad_cuda.launches
    fused, aux = fit_multi_object_priors(
        model, children, pts, tgt, dataclasses.replace(cfg, fused=True),
        valid_mask=valid)
    assert TP.flagship_loss_grad_cuda.launches - before == 10
    _, paux = fit_multi_object_priors(model, children, pts, tgt, cfg,
                                      valid_mask=valid)
    for new, old in zip(TT.tree_leaves(fused), TT.tree_leaves(children)):
        assert torch.equal(new[~valid], old[~valid])
    np.testing.assert_allclose(aux["loss_hist"][valid].cpu().numpy(),
                               paux["loss_hist"][valid].cpu().numpy(),
                               rtol=HIST_RTOL)


@pytest.mark.gpu
def test_k2_disk_inputs_against_float64(cuda_device):
    """K2 at G = 16 on the children's fit inputs (8 frames x 2 slots of
    64x64 disks, weights 1/N), where the kernel and the plain version
    differ in a few hidden-weight grads by more than the element-wise
    tolerance of ``tests/test_torch_kernel_gpu.py``. Both are held
    against a float64 run of the plain version: the loss at its
    tolerance, and the kernel's largest grad error no more than twice the
    plain float32 version's. Prints each element past the element-wise
    tolerance with the float64 value and which side it is nearer
    (``pytest -s``)."""
    t, k = 8, 2
    g = t * k
    model = _bench((64, 64), cuda_device)
    children, pts, tgt = _disk_children(model, cuda_device, t, k)
    n = pts.shape[0]
    spec = TP.FlagshipSpec.of(model)
    flat = TP.pack_flat(TP.pack_flagship(model, TT.tree_map(
        lambda a: a.reshape((g,) + a.shape[2:]), children)), g).contiguous()
    tgt = tgt.reshape(g, n).contiguous()
    wts = torch.full((g, n), 1.0 / n, device=cuda_device)
    loss, grads = TP.FlagshipLossGrad(spec, True, g, None).flat(
        flat, pts.contiguous(), tgt, wts)
    packed = TP.unpack_flat(spec, flat)
    ref_loss, ref = TP.flagship_loss_grad_plain(spec, packed, pts, tgt, wts)
    loss64, ref64 = TP.flagship_loss_grad_plain(
        spec, {f: v.double() for f, v in packed.items()}, pts.double(),
        tgt.double(), wts.double())
    kern, plain = grads.double().cpu(), TP.pack_flat(ref, g).double().cpu()
    f64 = TP.pack_flat(ref64, g).cpu()
    np.testing.assert_allclose(loss.cpu().numpy(), loss64.cpu().numpy(),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(ref_loss.cpu().numpy(), loss64.cpu().numpy(),
                               rtol=LOSS_RTOL)
    kerr, perr = (kern - f64).abs(), (plain - f64).abs()
    off = spec.offsets()[0]
    past = (kern - plain).abs() > GRAD_ATOL + GRAD_RTOL * plain.abs()
    for gi, col in torch.nonzero(past).tolist():
        field = max((f for f in off if off[f] <= col), key=off.get)
        side = "kernel" if kerr[gi, col] < perr[gi, col] else "plain"
        print(f"img {gi} col {col} ({field}) kernel {kern[gi, col]:.6e} "
              f"plain {plain[gi, col]:.6e} f64 {f64[gi, col]:.6e} "
              f"nearer: {side}")
    print(f"past the element-wise tolerance: {int(past.sum())} of "
          f"{past.numel()}; float64 nearer the kernel in "
          f"{int((past & (kerr < perr)).sum())}; max |kernel - f64| "
          f"{float(kerr.max()):.3e}, max |plain - f64| {float(perr.max()):.3e}")
    assert float(kerr.max()) <= 2.0 * float(perr.max())
