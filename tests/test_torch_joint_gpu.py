"""On the card: the joint step's prior grads from one fused flagship
loss+grad launch (K2) for the batch, at the FBMS joint cell's size (2
frames of 480x640, the bench prior: flow 32 x 12 with tanh, ICNN 130 x
2, and the full-width ``UNet(4, 1)``). One step adds exactly one to
``flagship_loss_grad_cuda.launches``; its prior grads agree with the
autograd route's (a step built with an explicit copy of the default loss)
by the benchmark's ``grad_gap`` measure (each leaf's norm gap over the
larger of its and the median leaf's norm, leaves under a thousandth of
the median left out) within its limit 6e-4, and so does each leaf's
difference; the seg grads and the loss as well.

Imports no JAX, so it runs where the card is:
``python3 -m pytest --noconftest -q tests/test_torch_joint_gpu.py``.
Without a card its tests skip."""
import numpy as np
import pytest
import torch

from awesome_tpu_torch.core import grids as TG
from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.fit import optim
from awesome_tpu_torch.fit import trainer as TR
from awesome_tpu_torch.nn import seg as TS
from awesome_tpu_torch.nn import wrapper as TW
from awesome_tpu_torch.nn.path_connected import real_nvp_path_connected_net
from awesome_tpu_torch.ops.flagship import flagship_loss_grad_cuda
from torch_one_thread import one_torch_thread  # noqa: F401

H, W, B, FRAMES = 480, 640, 2, 4
GRAD_GAP = 6e-4


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run: skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _norm_gaps(got, ref):
    """Per leaf kept: (norm gap, difference norm), each over the larger of
    the leaf's and the median leaf's reference norm."""
    ref_n = [float(torch.linalg.vector_norm(r)) for r in ref]
    med = float(np.median(ref_n))
    return [(abs(float(torch.linalg.vector_norm(g)) - r) / max(r, med),
             float(torch.linalg.vector_norm(g - x)) / max(r, med))
            for g, x, r in zip(got, ref, ref_n) if r >= 1e-3 * med]


def _step(monkeypatch, wrapper, cfg, state, batch, loss_fn=None):
    seen = {}
    for name in ("adam_update", "adamax_update"):
        def keep(params, grads, *args, _name=name,
                 _real=getattr(optim, name), **kwargs):
            seen[_name] = grads
            return _real(params, grads, *args, **kwargs)

        monkeypatch.setattr(optim, name, keep)
    _, metrics = TR.make_joint_train_step(wrapper, cfg, loss_fn)(state,
                                                                 batch)
    torch.cuda.synchronize()
    monkeypatch.undo()
    return (T.tree_leaves(seen["adam_update"]),
            T.tree_leaves(seen["adamax_update"]), metrics)


@pytest.mark.gpu
def test_joint_step_prior_grads_on_one_k2_launch(cuda_device, monkeypatch):
    dev = cuda_device
    prior = real_nvp_path_connected_net(
        channels=2, hidden_units=32, flow_n_flows=12, flow_output_fn="tanh",
        spatial_shape=(H, W), convex_net_hidden_units=130,
        convex_net_hidden_layers=2, device=dev)
    wrapper = TW.WrapperModule(
        segmentation_module=TS.UNet(in_chn=4, out_chn=1, device=dev),
        prior_module=prior, input_mode="image",
        prior_arg_mode="param_clean_grid", seg_stateful=True)
    cfg = TR.JointTrainConfig()
    g = torch.Generator().manual_seed(0)
    state = TR.joint_train_init(wrapper, g, FRAMES, cfg)
    # away from the flow's zero last layers, so every leaf has a grad
    state = state._replace(prior_params=T.tree_map(
        lambda p: p + 0.01 * torch.randn(p.shape, generator=g).to(dev),
        state.prior_params))
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    fg = (((yy - H / 2) / (H / 4)) ** 2 + ((xx - W / 2) / (W / 5)) ** 2) < 1
    batch = {"image": torch.rand((B, H, W, 3), generator=g).to(dev),
             "features": torch.rand((B, H, W, 1), generator=g).to(dev),
             "grid": TG.flatten_grid(TG.pixel_grid((H, W), device=dev)),
             "target": (~fg).float()[None, :, :, None].expand(
                 B, H, W, 1).contiguous(),
             "index": torch.tensor([1, 3], device=dev),
             "weight": torch.ones(B, device=dev)}
    before = flagship_loss_grad_cuda.launches
    seg_k, prior_k, met_k = _step(monkeypatch, wrapper, cfg, state, batch)
    assert flagship_loss_grad_cuda.launches - before == 1
    seg_a, prior_a, met_a = _step(monkeypatch, wrapper, cfg, state, batch,
                                  loss_fn=TR._default_loss_fn(cfg, True))
    assert flagship_loss_grad_cuda.launches - before == 1
    loss_k, loss_a = float(met_k["loss"]), float(met_a["loss"])
    prior_gaps = _norm_gaps(prior_k, prior_a)
    seg_gaps = _norm_gaps(seg_k, seg_a)
    print(f"loss {loss_k!r} / {loss_a!r}; prior leaves kept "
          f"{len(prior_gaps)} of {len(prior_a)}: worst norm gap "
          f"{max(p[0] for p in prior_gaps):.3e}, worst difference "
          f"{max(p[1] for p in prior_gaps):.3e}; seg worst norm gap "
          f"{max(p[0] for p in seg_gaps):.3e}, worst difference "
          f"{max(p[1] for p in seg_gaps):.3e}")
    assert abs(loss_k - loss_a) <= 1e-6 * abs(loss_a)
    assert len(prior_gaps) == len(prior_a)
    assert all(gap <= GRAD_GAP and diff <= GRAD_GAP
               for gap, diff in prior_gaps + seg_gaps)
