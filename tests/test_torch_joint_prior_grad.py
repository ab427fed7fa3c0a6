"""The joint step's prior grads from one fused flagship loss+grad call for
the batch (``fit/trainer.py:make_joint_train_step``; on the CPU the
kernel's plain version) against the autograd route, which a step built
with an explicit copy of the default loss keeps. A small
``PathConnectedNet`` (RealNVP with tanh s/t, ``ConvexNextNet``) and the
full-width ``UNet(4, 1)`` on 3 frames of 32x32, one step from the same
state (the priors drawn away from the flow's zero last layers, so every
leaf has a grad): the prior grads per leaf within 1e-5 of the leaf's
largest element, the seg grads and the loss terms bitwise (the seg's
graph is the same on both routes); without weights and
with a padded (weight-0) sample, the penalty clipped (scale below 1) and
not (scale 1), on a shared (N, 2) and a per-frame (B, N, 2) grid. The
grads are read where the optimizers get them. Which steps take the
kernel: the default loss on a flagship prior without a mesh, no other."""
import pytest
import torch

from awesome_tpu_torch.core import grids as TG
from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.fit import optim
from awesome_tpu_torch.fit import trainer as TR
from awesome_tpu_torch.nn import seg as TS
from awesome_tpu_torch.nn import wrapper as TW
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.nn.path_connected import real_nvp_path_connected_net
from awesome_tpu_torch.ops import flagship
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
H = W = 32
FRAMES = 4
INDEX = [0, 2, 3]
LEAF_RTOL = 1e-5


def _prior():
    return real_nvp_path_connected_net(
        channels=2, hidden_units=8, flow_n_flows=2, flow_output_fn="tanh",
        spatial_shape=(H, W), convex_net_hidden_units=8,
        convex_net_hidden_layers=1, device=CPU)


def _wrapper(prior):
    return TW.WrapperModule(
        segmentation_module=TS.UNet(in_chn=4, out_chn=1, device=CPU),
        prior_module=prior, input_mode="image",
        prior_arg_mode="param_clean_grid", seg_stateful=True)


def _state(wrapper, cfg):
    state = TR.joint_train_init(wrapper, torch.Generator().manual_seed(0),
                                FRAMES, cfg)
    g = torch.Generator().manual_seed(2)
    return state._replace(prior_params=T.tree_map(
        lambda p: p + 0.1 * torch.randn(p.shape, generator=g),
        state.prior_params))


def _batch(weighted: bool, per_frame_grid: bool):
    g = torch.Generator().manual_seed(1)
    b = len(INDEX)
    grid = TG.flatten_grid(TG.pixel_grid((H, W), device=CPU))
    if per_frame_grid:  # each frame's points shifted by its own offset
        grid = grid[None] + 0.05 * torch.rand((b, 1, 2), generator=g)
    batch = {"image": torch.rand((b, H, W, 3), generator=g),
             "features": torch.rand((b, H, W, 1), generator=g),
             "grid": grid,
             "target": (torch.rand((b, H, W, 1), generator=g) > 0.5).float(),
             "index": torch.tensor(INDEX)}
    if weighted:
        batch["weight"] = torch.tensor([1.0, 0.0, 1.0])
    return batch


def _step(monkeypatch, wrapper, cfg, state, batch, loss_fn=None):
    """One step: (seg grads, prior grads, metrics, fused calls made)."""
    seen = {"fused": 0}
    real_plain = flagship.flagship_loss_grad_plain

    def counted(*args, **kwargs):
        seen["fused"] += 1
        return real_plain(*args, **kwargs)

    monkeypatch.setattr(flagship, "flagship_loss_grad_plain", counted)
    for name in ("adam_update", "adamax_update"):
        def keep(params, grads, *args, _name=name,
                 _real=getattr(optim, name), **kwargs):
            seen[_name] = grads
            return _real(params, grads, *args, **kwargs)

        monkeypatch.setattr(optim, name, keep)
    _, metrics = TR.make_joint_train_step(wrapper, cfg, loss_fn)(state,
                                                                 batch)
    monkeypatch.undo()
    return seen["adam_update"], seen["adamax_update"], metrics, \
        seen["fused"]


def _assert_leaves_close(got, ref):
    for a, b in zip(T.tree_leaves(got), T.tree_leaves(ref)):
        assert a.shape == b.shape
        top = float(b.abs().max())
        assert top > 0.0
        assert float((a - b).abs().max()) <= LEAF_RTOL * top, \
            (float((a - b).abs().max()), top)


@pytest.mark.parametrize("per_frame_grid", [False, True],
                         ids=["shared_grid", "per_frame_grid"])
@pytest.mark.parametrize("beta, clipped", [(100.0, True), (0.01, False)],
                         ids=["clipped", "unclipped"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["no_weight", "padded_sample"])
def test_fused_prior_grads_match_autograd(monkeypatch, weighted, beta,
                                          clipped, per_frame_grid):
    wrapper = _wrapper(_prior())
    cfg = TR.JointTrainConfig(lr=1e-3, prior_lr=1e-3, beta=beta)
    state = _state(wrapper, cfg)
    batch = _batch(weighted, per_frame_grid)
    seg_k, prior_k, met_k, fused_k = _step(monkeypatch, wrapper, cfg, state,
                                           batch)
    seg_a, prior_a, met_a, fused_a = _step(
        monkeypatch, wrapper, cfg, state, batch,
        loss_fn=TR._default_loss_fn(cfg, True))
    assert (fused_k, fused_a) == (1, 0)
    for k in met_a:
        assert torch.equal(met_k[k], met_a[k]), k
    # the case is what it says: a clipped penalty equals the seg loss
    frac = float(met_k["penalty_loss_frac"])
    assert abs(frac - 0.5) < 1e-5 if clipped else frac < 0.4
    _assert_leaves_close(prior_k, prior_a)
    assert all(torch.equal(a, b) for a, b in zip(T.tree_leaves(seg_k),
                                                  T.tree_leaves(seg_a)))
    if weighted:  # the padded sample's row gets no grad
        assert all(not bool(g[1].any()) for g in T.tree_leaves(prior_k))


def test_joint_step_with_the_fused_prior_grads_trains():
    """Two epochs on the fused route: the loss falls and every trained
    prior row moves."""
    wrapper = _wrapper(_prior())
    cfg = TR.JointTrainConfig(lr=1e-3, prior_lr=1e-3)
    state = _state(wrapper, cfg)
    g = torch.Generator().manual_seed(3)
    data = {"image": torch.rand((FRAMES, H, W, 3), generator=g),
            "features": torch.rand((FRAMES, H, W, 1), generator=g),
            "grid": TG.flatten_grid(TG.pixel_grid((H, W), device=CPU)),
            "target": (torch.rand((FRAMES, H, W, 1), generator=g)
                       > 0.5).float()}
    epoch = TR.make_joint_epoch_fn(wrapper, cfg)
    idx = torch.tensor([[0, 1], [2, 3]])
    wgt = torch.ones((2, 2))
    new, m1 = epoch(state, data, idx, wgt)
    new, m2 = epoch(new, data, idx, wgt)
    assert float(m2["loss"].sum()) < float(m1["loss"].sum())
    for a, b in zip(T.tree_leaves(new.prior_params),
                    T.tree_leaves(state.prior_params)):
        assert all(not torch.equal(a[i], b[i]) for i in range(FRAMES))


@pytest.mark.parametrize("case", ["default", "custom_loss", "mesh",
                                  "convex_prior", "no_prior"])
def test_which_steps_take_the_fused_prior_grads(case):
    prior = {"convex_prior": ConvexNextNet(n_hidden=8, n_hidden_layers=1,
                                           device=CPU),
             "no_prior": None}.get(case, _prior())
    wrapper = _wrapper(prior)
    loss_fn = TR._default_loss_fn(TR.JointTrainConfig(), True) \
        if case == "custom_loss" else None
    mesh = object() if case == "mesh" else None
    k2 = TR._prior_grad_kernel(wrapper, loss_fn, mesh)
    assert (k2 is not None) == (case == "default")
    if k2 is not None:
        assert k2.use_sigmoid == wrapper.use_prior_sigmoid
        assert not k2.use_bf16
