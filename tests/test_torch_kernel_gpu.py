"""The CUDA kernels (flagship loss+grad, ICNN forward and backward) against
their plain PyTorch versions, on the card.

Imports no JAX, so it runs where the card is:
``python3 -m pytest --noconftest -q tests/test_torch_kernel_gpu.py``.
Without a card its tests skip."""
import numpy as np
import pytest
import torch

from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)
from awesome_tpu_torch.ops import flagship as TP

LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 5e-4, 1e-6


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run: skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _flagship_inputs(device, width, layers, seed, g=2, n=4097,
                     per_image=False):
    """The bench model's flow with an ICNN of ``width`` x ``layers``, G
    perturbed param rows, points (N, 2) or (G, N, 2), targets, weights."""
    tm = t_factory(channels=2, hidden_units=32, flow_n_flows=12,
                   flow_output_fn="tanh", spatial_shape=(64, 64),
                   convex_net_hidden_units=width,
                   convex_net_hidden_layers=layers, device=device)
    spec = TP.FlagshipSpec.of(tm)
    gen = torch.Generator().manual_seed(seed)
    packs = [TP.pack_flagship(tm, TT.tree_map(
        lambda a: a + 0.05 * torch.randn(a.shape, generator=gen).to(a.device),
        tm.init(gen))) for _ in range(g)]
    stacked = {k: torch.stack([p[k] for p in packs]) for k in packs[0]}
    flat = TP.pack_flat(stacked, g).contiguous()
    x = torch.rand((g, n, 2) if per_image else (n, 2),
                   generator=gen).to(device)
    tgt = (torch.rand((g, n), generator=gen) > 0.5).float().to(device)
    wts = torch.full((g, n), 1.0 / n, device=device)
    return spec, stacked, flat, x, tgt, wts


def _assert_fp32_close(loss, grads, ref_loss, ref, g):
    np.testing.assert_allclose(loss.cpu().numpy(), ref_loss.cpu().numpy(),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(grads.cpu().numpy(),
                               TP.pack_flat(ref, g).cpu().numpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("width,layers,tp", [(130, 2, 64), (130, 3, 32),
                                             (50, 2, 64), (150, 2, 32)])
def test_cuda_kernel_matches_plain(cuda_device, width, layers, tp):
    """The CUDA kernel against the plain version on the card (ragged N,
    G = 2); two launches are bitwise equal. The bench-width ICNN (130) at
    two layers takes 64-point chunks; a third layer, or width 150, no
    longer fits them in shared memory and takes the 32-point
    instantiation. Width 50 is a narrow ICNN."""
    spec, stacked, flat, x, tgt, wts = _flagship_inputs(cuda_device, width,
                                                        layers, 0)
    assert TP.launch_shape(spec, x.shape[0], 2, None, x.device).tp == tp
    f = TP.FlagshipLossGrad(spec, True, 2, None)
    loss, grads = f.flat(flat, x, tgt, wts)
    loss2, grads2 = f.flat(flat, x, tgt, wts)
    assert torch.equal(loss, loss2) and torch.equal(grads, grads2)
    ref_loss, ref = TP.flagship_loss_grad_plain(spec, stacked, x, tgt, wts)
    _assert_fp32_close(loss, grads, ref_loss, ref, 2)


def _nrel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _assert_bf16_within_gap(spec, stacked, flat, x, tgt, wts, g):
    """The bf16 build against the plain bf16 version: two launches bitwise
    equal; the loss and every packed leaf within a tenth of the plain
    version's bf16-vs-FP32 gap, by (norm-)relative error."""
    f = TP.FlagshipLossGrad(spec, True, g, None, use_bf16=True)
    loss, grads = f.flat(flat, x, tgt, wts)
    loss2, grads2 = f.flat(flat, x, tgt, wts)
    assert torch.equal(loss, loss2) and torch.equal(grads, grads2)
    ref_loss, ref = TP.flagship_loss_grad_plain(spec, stacked, x, tgt, wts,
                                                use_bf16=True)
    f32_loss, f32 = TP.flagship_loss_grad_plain(spec, stacked, x, tgt, wts)
    gap = _nrel(ref_loss, f32_loss)
    assert gap > 0.0 and _nrel(loss, ref_loss) <= 0.1 * gap
    got = TP.unpack_flat(spec, grads)
    for name in TP.PACKED_FIELDS:
        gap = _nrel(ref[name], f32[name])
        assert gap > 0.0, name
        assert _nrel(got[name], ref[name]) <= 0.1 * gap, name


@pytest.mark.gpu
@pytest.mark.parametrize("width,layers,tp", [(130, 2, 64), (130, 3, 32),
                                             (50, 2, 64), (150, 2, 32),
                                             (150, 1, 64)])
def test_cuda_bf16_kernel_matches_plain(cuda_device, width, layers, tp):
    """The bf16 build against the plain bf16 version (ragged N, G = 2) at
    both tile instantiations and the tensor-core products' edges: width 50
    and 150 are no multiple of 16 (padded rows, columns and depth), and
    width 150 at 64-point tiles takes a second pass of rows (144 a pass;
    160 at 32-point tiles)."""
    spec, stacked, flat, x, tgt, wts = _flagship_inputs(
        cuda_device, width, layers, width + layers + 2)
    assert TP.launch_shape(spec, x.shape[0], 2, None, x.device,
                           use_bf16=True).tp == tp
    _assert_bf16_within_gap(spec, stacked, flat, x, tgt, wts, 2)


@pytest.mark.gpu
def test_cuda_bf16_per_image_points_match_plain(cuda_device):
    """The bf16 build with a point set per image (G = 8, the batched bf16
    fit's launch) against the plain bf16 version, by the gap rule."""
    spec, stacked, flat, x, tgt, wts = _flagship_inputs(
        cuda_device, 130, 2, 136, g=8, per_image=True)
    _assert_bf16_within_gap(spec, stacked, flat, x, tgt, wts, 8)


@pytest.mark.gpu
def test_cuda_per_image_points_match_plain(cuda_device):
    """Per-image points (G, N, 2) against the plain version (ragged N, G =
    3); the shared-point launch is bitwise equal to a per-image launch
    with the same points repeated for every image."""
    spec, stacked, flat, x, tgt, wts = _flagship_inputs(
        cuda_device, 130, 2, 135, g=3, per_image=True)
    f = TP.FlagshipLossGrad(spec, True, 3, None)
    loss, grads = f.flat(flat, x, tgt, wts)
    ref_loss, ref = TP.flagship_loss_grad_plain(spec, stacked, x, tgt, wts)
    _assert_fp32_close(loss, grads, ref_loss, ref, 3)
    shared = x[1].contiguous()
    loss_s, grads_s = f.flat(flat, shared, tgt, wts)
    loss_r, grads_r = f.flat(flat, shared.expand(3, -1, -1).contiguous(),
                             tgt, wts)
    assert torch.equal(loss_s, loss_r) and torch.equal(grads_s, grads_r)


@pytest.mark.gpu
def test_fused_fit_on_card_launches_once_per_step(cuda_device):
    """The fused fit on the card goes through the kernel once per step and
    follows the same fit run on the CPU (plain version)."""
    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.fit.prior_fit import FitConfig, make_fit_fn

    h = w = 24
    yy, xx = np.mgrid[0:h, 0:w]
    fg = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2) <= (h / 3) ** 2
    target = torch.tensor(1.0 - fg.astype(np.float32)).reshape(-1, 1)
    cfg = FitConfig(num_steps=6, lr=1e-3, fused=True, nan_guard_grads=False)
    hist = {}
    for dev in ("cpu", cuda_device):
        model = t_factory(channels=2, hidden_units=8, flow_n_flows=4,
                          flow_output_fn="tanh", spatial_shape=(h, w),
                          convex_net_hidden_units=16,
                          convex_net_hidden_layers=2, device=dev)
        params = model.init(torch.Generator().manual_seed(3))
        pts = G.flatten_grid(G.pixel_grid((h, w), device=dev))
        before = TP.flagship_loss_grad_cuda.launches
        _, aux = make_fit_fn(model, cfg)(params, pts, target.to(dev))
        torch.cuda.synchronize()
        launched = TP.flagship_loss_grad_cuda.launches - before
        assert launched == (cfg.num_steps if dev != "cpu" else 0)
        hist[dev] = aux["loss_hist"].cpu().numpy()
    np.testing.assert_allclose(hist[cuda_device], hist["cpu"], rtol=2e-4)


# (width, layers, in_features) of the ICNNs the fused ICNN kernels serve:
# the runner default and how-to, the flagship's ICNN, the convex teaser,
# the space-time teaser, the multi-object children; then two at the
# kernels' tile edges: K5's backward-data product (W + C rows) takes a
# second pass of 144 rows at W = 143, C = 2, and its weight grads (W + C +
# 1 columns) a second tile of 136 columns at W = 134, C = 3
ICNN_CONFIGS = [(130, 1, 2), (130, 2, 2), (150, 1, 2), (50, 1, 3),
                (64, 1, 2), (143, 1, 2), (134, 1, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("width,layers,c", ICNN_CONFIGS)
def test_icnn_kernels_match_plain(cuda_device, width, layers, c):
    """K4 and K5 against the plain versions on the card: a ragged N, G = 3
    with shared and with per-image points; y at rtol 1e-5 (atol 1e-6 of
    max|y|, since y crosses 0), dx and weight grads at rtol 5e-4, atol
    1e-6 of the largest grad (the kernels sum in another order); two K5
    launches are bitwise equal."""
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.ops import mlp as M

    base = ConvexNextNet(n_hidden=width, in_features=c,
                         n_hidden_layers=layers, device=cuda_device)
    spec = M.IcnnSpec.of(base)
    gen = torch.Generator().manual_seed(width + layers)
    g, n = 3, 4097
    stacked = TT.stack_trees([
        TT.tree_map(lambda a: a + 0.05 * torch.randn(
            a.shape, generator=gen).to(a.device), base.init(gen))
        for _ in range(g)])
    flat = M.pack_rows(M.flat_weights(stacked), g)
    gy = torch.randn((g, n), generator=gen).to(cuda_device)
    for x in (torch.rand((n, c), generator=gen).to(cuda_device),
              torch.rand((g, n, c), generator=gen).to(cuda_device)):
        y = M.icnn_forward_cuda(spec, flat, x)
        dp, dx = M.icnn_backward_cuda(spec, flat, x, gy)
        dp2, dx2 = M.icnn_backward_cuda(spec, flat, x, gy)
        assert torch.equal(dp, dp2) and torch.equal(dx, dx2)
        ref_y = M.icnn_forward_plain(stacked, x)[..., 0]
        ref_tree, ref_dx = M.icnn_backward_plain(stacked, x, gy[..., None])
        ref_dp = M.pack_rows(M.flat_weights(ref_tree), g)
        ya, ry = y.cpu().numpy(), ref_y.cpu().numpy()
        np.testing.assert_allclose(ya, ry, rtol=1e-5,
                                   atol=1e-6 * np.abs(ry).max())
        for got, ref in ((dp, ref_dp), (dx, ref_dx)):
            got, ref = got.cpu().numpy(), ref.cpu().numpy()
            np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL,
                                       atol=1e-6 * np.abs(ref).max())


@pytest.mark.gpu
def test_batched_convex_fit_launches_once_per_step(cuda_device):
    """A batched fit of 3 images with FullyFusedConvexNextNet makes one K4
    and one K5 launch per step for the whole batch (plus one K4 for the
    gate's scores), and follows the same fit run on the CPU."""
    from awesome_tpu_torch.core import grids as G
    from awesome_tpu_torch.fit.prior_fit import FitConfig, fit_priors_batched
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.ops import mlp as M

    h = w = 20
    b = 3
    yy, xx = np.mgrid[0:h, 0:w]
    targets = torch.tensor(np.stack([
        (1.0 - (((yy - 8 - i) ** 2 + (xx - 9) ** 2) <= 25).astype(
            np.float32)).reshape(-1, 1) for i in range(b)]))
    cfg = FitConfig(num_steps=8, lr=2e-3, optimizer="adam", fg_weight=0.4,
                    gate_threshold=0.5)
    hist = {}
    for dev in ("cpu", cuda_device):
        model = M.FullyFusedConvexNextNet(ConvexNextNet(n_hidden=24,
                                                        device=dev))
        stacked = TT.stack_trees([model.init(torch.Generator().manual_seed(i))
                                  for i in range(b)])
        pts = G.flatten_grid(G.pixel_grid((h, w), device=dev))
        f0 = M.icnn_forward_cuda.launches
        b0 = M.icnn_backward_cuda.launches
        _, aux = fit_priors_batched(model, stacked, pts, targets.to(dev), cfg)
        torch.cuda.synchronize()
        on_card = dev != "cpu"
        assert M.icnn_forward_cuda.launches - f0 == (9 if on_card else 0)
        assert M.icnn_backward_cuda.launches - b0 == (8 if on_card else 0)
        hist[dev] = aux["loss_hist"].cpu().numpy()
    np.testing.assert_allclose(hist[cuda_device], hist["cpu"], rtol=2e-4)
