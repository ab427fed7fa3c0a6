"""The plain reference against the port's plain path, at tiny sizes on the
CPU, on weights drawn as the benchmark draws them."""
import pytest
import torch

from portbench import harness, inputs, spec
from portbench.drivers import common
from portbench.reference import fit as rfit
from portbench.reference import layout
from portbench.reference import prior as rprior
from portbench.reference import unet as runet

FBMS = spec.config("fbms_pc")
HOWTO = spec.config("howto_convex")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(cfg, count, seed=3):
    return layout.draw(layout.prior(cfg), inputs.generator(seed, "cpu"),
                       count, "cpu")


@pytest.mark.parametrize("cfg", [FBMS, HOWTO], ids=["fbms_pc", "howto"])
def test_layout_is_the_ports(cfg):
    from awesome_tpu_torch.core import tree as T

    port = common.port_prior(cfg, 12, 16, "cpu").init(0)
    ours = layout.select(_params(cfg, 1), 0)
    a = dict(T.tree_flatten_with_path(port))
    b = dict(T.tree_flatten_with_path(ours))
    assert a.keys() == b.keys()
    assert all(a[k].shape == b[k].shape for k in a)


def test_unet_layout_is_the_ports():
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.nn.seg import UNet

    params, state = UNet(4, 1, device="cpu").init(0)
    ours = layout.select(layout.draw(layout.unet(FBMS),
                                     inputs.generator(1, "cpu"), 1, "cpu"), 0)
    for port, mine in ((params, ours),
                       (state, layout.unet_state(FBMS, "cpu"))):
        a = dict(T.tree_flatten_with_path(port))
        b = dict(T.tree_flatten_with_path(mine))
        assert a.keys() == b.keys()
        assert all(a[k].shape == b[k].shape for k in a)


@pytest.mark.parametrize("cfg", [FBMS, HOWTO], ids=["fbms_pc", "howto"])
def test_prior_forward(cfg):
    h, w = 12, 16
    p = layout.select(_params(cfg, 1), 0)
    x = inputs.pixel_points(h, w, "cpu")
    port = common.port_prior(cfg, h, w, "cpu").apply(p, x)
    ref = rprior.model(cfg, h, w, "cpu").apply(p, x)
    torch.testing.assert_close(port, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cfg", [FBMS, HOWTO], ids=["fbms_pc", "howto"])
def test_three_fit_steps(cfg):
    """The port's plain fit (3 steps) against the reference's steps."""
    from awesome_tpu_torch.fit.prior_fit import fit_prior

    h, w = 12, 16
    gen = inputs.generator(9, "cpu")
    fg = inputs.shapes(gen, 1, h, w, ["ellipse"], "cpu")
    target = inputs.unaries(gen, fg, 0.1)[0]
    p = layout.select(_params(cfg, 1), 0)
    x = inputs.pixel_points(h, w, "cpu")
    ctx = harness.Context(cfg, {}, 0, "cpu")
    out, aux = fit_prior(common.port_prior(cfg, h, w, "cpu"), p, x, target,
                         common.fit_config(ctx, 3))
    losses, ref = rfit.follow(rprior.model(cfg, h, w, "cpu"),
                              common.reference_fit_settings(cfg), p, x,
                              target, 3)
    torch.testing.assert_close(aux["loss_hist"], torch.tensor(losses),
                               rtol=1e-5, atol=0)
    for a, b in zip(layout.leaves(out), layout.leaves(ref)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_unet_forward_and_grads():
    from awesome_tpu_torch.nn.seg import UNet

    gen = inputs.generator(4, "cpu")
    p = layout.select(layout.draw(layout.unet(FBMS), gen, 1, "cpu"), 0)
    s = layout.unet_state(FBMS, "cpu")
    img = torch.rand((2, 16, 16, 3), generator=gen)
    feat = torch.rand((2, 16, 16, 1), generator=gen)

    def run(apply):
        ps = [t.detach().requires_grad_(True) for t in layout.leaves(p)]
        out, state = apply(layout.rebuild(p, iter(ps)))
        loss = (torch.sigmoid(out) * torch.linspace(
            0, 1, out.numel()).reshape(out.shape)).sum()
        return out, state, torch.autograd.grad(loss, ps)

    a = run(lambda q: UNet(4, 1, device="cpu").apply(q, s, img, feat,
                                                     train=True))
    b = run(lambda q: runet.apply(q, s, img, feat))
    torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=1e-5)
    for x, y in zip(layout.leaves(a[1]), layout.leaves(b[1])):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    norms = [float(g.norm()) for g in b[2]]
    big = sorted(norms)[len(norms) // 2] * 1e-3
    for x, y, n in zip(a[2], b[2], norms):
        if n >= big:  # the conv biases before batch norm carry round-off
            assert float((x - y).norm()) <= 1e-4 * n


@pytest.mark.parametrize("cell", ["fbms_pc.pretrain_480x640",
                                  "howto_convex.gated_8x480x640",
                                  "fbms_pc.joint_2x480x640"])
def test_whole_check_agrees_at_a_tiny_size(cell):
    """A run's compared numbers, port against reference, on the CPU: the
    losses, gradients and IoUs at float32 rounding; a leaf's change after
    three Adam steps moves more, as Adam gives an element whose gradient is
    near rounding a whole step of either sign."""
    entry = spec.cell(spec.benchmark(), cell)
    cfg = dict(spec.config(entry["config"]), num_steps=4, warm_steps=3)
    # 32 x 32: the UNet's deepest level keeps 2 x 2 pixels for its batch norm
    trf = dict(spec.traffic(entry["traffic"]), height=32, width=32,
               images=2)
    rec = harness.run_cell(entry, cfg, trf, spec.limits(cell), 12345, 0.0,
                           False, "cpu")
    assert rec["failed"] == 0
    for name, most in (("loss_gap", 1e-4), ("dloss_gap", 1e-4),
                       ("grad_gap", 1e-4), ("iou_gap", 1e-4),
                       ("step_gap", 0.02)):
        if name in rec["checks"]:
            assert rec["checks"][name]["value"] < most, (name, rec["checks"])
