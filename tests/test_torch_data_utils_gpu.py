"""On the card: the single-image fused fit (one K1 launch per step,
bitwise equal to ``make_fused_fit_fn``), ``PriorCache`` keeping its leaves
on the card through extract/apply and a save/load round trip, and
``DeviceTimer`` waiting for a queued kernel.

Imports no JAX, so it runs where the card is:
``python3 -m pytest --noconftest -q tests/test_torch_data_utils_gpu.py``.
Without a card its tests skip."""
import pytest
import torch

from awesome_tpu_torch.core import grids as G
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.data.awesome_dataset import PriorCache
from awesome_tpu_torch.fit.fused_fit import fit_prior_fused, make_fused_fit_fn
from awesome_tpu_torch.fit.prior_fit import FitConfig
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.nn.path_connected import real_nvp_path_connected_net
from awesome_tpu_torch.ops.flagship import flagship_loss_grad_cuda
from awesome_tpu_torch.utils.timer import DeviceTimer, Timer


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run: skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
def test_fit_prior_fused_on_k1(cuda_device):
    h = w = 64
    model = real_nvp_path_connected_net(
        channels=2, hidden_units=32, flow_n_flows=12, flow_output_fn="tanh",
        spatial_shape=(h, w), convex_net_hidden_units=130,
        convex_net_hidden_layers=2, device=cuda_device)
    pts = G.flatten_grid(G.pixel_grid((h, w), device=cuda_device))
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    fg = ((yy - 30) ** 2 + (xx - 34) ** 2) <= 200
    target = (1.0 - fg.float()).reshape(-1, 1).to(cuda_device)
    params = model.init(torch.Generator().manual_seed(5))
    cfg = FitConfig(num_steps=30, lr=1e-3)
    before = flagship_loss_grad_cuda.launches
    fitted, aux = fit_prior_fused(model, params, pts, target, cfg)
    torch.cuda.synchronize()
    assert flagship_loss_grad_cuda.launches - before == 30
    ref, ref_aux = make_fused_fit_fn(model, cfg)(params, pts, target)
    assert torch.equal(aux["loss_hist"], ref_aux["loss_hist"])
    same = TT.tree_map(torch.equal, fitted, ref)
    assert all(TT.tree_leaves(same))
    hist = aux["loss_hist"].cpu()
    assert torch.isfinite(hist).all() and hist[-1] < hist[0]


@pytest.mark.gpu
def test_prior_cache_stays_on_the_card(cuda_device, tmp_path):
    cache = PriorCache(ConvexNextNet(n_hidden=16, device=cuda_device), 5,
                       key=1)
    one = cache.extract_prior(3)
    assert all(leaf.is_cuda for leaf in TT.tree_leaves(one))
    cache.apply_prior(0, TT.tree_map(lambda t: t * 2.0, one))
    state = cache.get_state()
    assert all(leaf.is_cuda for leaf in TT.tree_leaves(state))
    twice = TT.tree_map(lambda a, b: torch.equal(a, 2.0 * b),
                        cache.extract_prior(0), one)
    assert all(TT.tree_leaves(twice))
    path = str(tmp_path / "cache")
    cache.save(path)
    other = PriorCache(ConvexNextNet(n_hidden=16, device=cuda_device), 5,
                       key=2)
    other.load(path)
    same = TT.tree_map(lambda a, b: a.is_cuda and torch.equal(a, b),
                       other.get_state(), state)
    assert all(TT.tree_leaves(same))


@pytest.mark.gpu
def test_device_timer_waits_for_a_queued_kernel(cuda_device):
    x = torch.randn(4096, 4096, device=cuda_device)
    torch.cuda.synchronize()

    def work():
        y = x
        for _ in range(20):
            y = (y @ x) * 1e-3
        return y

    stream = torch.cuda.current_stream()
    with Timer():
        work()
    busy = not stream.query()  # a plain timer stops at the enqueue
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with DeviceTimer() as t:
        start.record()
        y = work()
        end.record()
        t.wait_for({"y": y})
    assert end.query() and stream.query()
    assert busy
    assert 1e3 * t.elapsed >= start.elapsed_time(end)
