"""The port's spans and fit-loop counters (CPU, no JAX):
``utils.profiling.span`` enters no ``record_function`` without a profiler;
under one, the fit loop, the gate and the joint step give their named,
nested ranges and ``span.totals`` (on a flagship prior the joint step's
fused prior grads as ``joint.prior_grad`` inside ``joint.backward``);
``fit.prior_fit.loop_work`` counts image-steps and masked image-steps."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from awesome_tpu_torch.core import grids as TG
from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.fit import prior_fit as PF
from awesome_tpu_torch.fit import trainer as TR
from awesome_tpu_torch.nn import seg as TS
from awesome_tpu_torch.nn import wrapper as TW
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.nn.path_connected import real_nvp_path_connected_net
from awesome_tpu_torch.utils.profiling import span
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
H = W = 16


def _model():
    return ConvexNextNet(n_hidden=8, n_hidden_layers=1, device=CPU)


def _batch(n: int):
    """``n`` images of an 8x8 grid: disks of growing radius."""
    pts = TG.flatten_grid(TG.pixel_grid((8, 8), device=CPU))
    yy, xx = np.mgrid[0:8, 0:8]
    tgt = np.stack([(((yy - 4) ** 2 + (xx - 4) ** 2) > (2 + i) ** 2)
                    .astype(np.float32).reshape(-1, 1) for i in range(n)])
    return pts, torch.tensor(tgt)


def _init(model, n: int):
    return T.stack_trees([model.init(torch.Generator().manual_seed(i))
                          for i in range(n)])


def _profiled(fn):
    """``fn()`` under a CPU profiler: the port's spans as (name, start,
    end), in order of start."""
    span.totals.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith(("fit.", "joint."))),
                  key=lambda s: s[1])


def _inside(outer, spans):
    return [s for s in spans if outer[1] <= s[1] and s[2] <= outer[2]
            and s is not outer]


def test_span_without_a_profiler_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    span.totals.clear()
    with span("fit.update"):
        pass
    model = _model()
    pts, tgt = _batch(2)
    PF.make_batched_fit_fn(model, PF.FitConfig(num_steps=2))(
        _init(model, 2), pts, tgt)
    assert span.totals == {}


def test_batched_fit_spans_nest():
    model = _model()
    pts, tgt = _batch(2)
    run = PF.make_batched_fit_fn(model, PF.FitConfig(num_steps=3))
    spans = _profiled(lambda: run(_init(model, 2), pts, tgt))
    loops = [s for s in spans if s[0] == "fit.loop"]
    assert len(loops) == 1
    inner = [s[0] for s in _inside(loops[0], spans)]
    assert inner == ["fit.loss_grad", "fit.update"] * 3
    assert span.totals["fit.loop"][0] == 1
    assert span.totals["fit.loss_grad"][0] == 3
    assert span.totals["fit.update"][0] == 3
    assert all(t[1] > 0.0 for t in span.totals.values())


def test_gate_span_holds_the_refit_loop():
    model = _model()
    pts, tgt = _batch(2)
    cfg = PF.FitConfig(num_steps=2, gate_threshold=1.1)  # every gate fails
    run = PF.make_batched_fit_fn(model, cfg)
    spans = _profiled(lambda: run(_init(model, 2), pts, tgt,
                                  retry_keys=[7, 8]))
    gates = [s for s in spans if s[0] == "fit.gate"]
    loops = [s for s in spans if s[0] == "fit.loop"]
    assert len(gates) == 1 and len(loops) == 2
    assert loops[0][2] <= gates[0][1]  # the first fit, before the gate
    held = [s[0] for s in _inside(gates[0], spans)]
    assert held == ["fit.loop"] + ["fit.loss_grad", "fit.update"] * 2


def test_joint_step_spans_in_order():
    prior = ConvexNextNet(n_hidden=8, n_hidden_layers=1, device=CPU)
    wrapper = TW.WrapperModule(
        segmentation_module=TS.UNet(in_chn=4, out_chn=1, device=CPU),
        prior_module=prior, input_mode="image",
        prior_arg_mode="param_clean_grid", seg_stateful=True)
    cfg = TR.JointTrainConfig(lr=1e-3, prior_lr=1e-3)
    state = TR.joint_train_init(wrapper, torch.Generator().manual_seed(0),
                                3, cfg)
    g = torch.Generator().manual_seed(1)
    batch = {"image": torch.rand((2, H, W, 3), generator=g),
             "features": torch.rand((2, H, W, 1), generator=g),
             "grid": TG.flatten_grid(TG.pixel_grid((H, W), device=CPU)),
             "target": (torch.rand((2, H, W, 1), generator=g) > 0.5).float(),
             "index": torch.tensor([0, 2])}
    step = TR.make_joint_train_step(wrapper, cfg)
    spans = _profiled(lambda: step(state, batch))
    steps = [s for s in spans if s[0] == "joint.step"]
    assert len(steps) == 1
    assert [s[0] for s in _inside(steps[0], spans)] == \
        ["joint.forward", "joint.backward", "joint.update"]
    assert {k: v[0] for k, v in span.totals.items()} == {
        "joint.step": 1, "joint.forward": 1, "joint.backward": 1,
        "joint.update": 1}


def test_joint_prior_grad_span_once_a_step_inside_the_backward():
    """On a flagship prior the fused prior grads open ``joint.prior_grad``
    once a step, inside ``joint.backward``."""
    prior = real_nvp_path_connected_net(
        channels=2, hidden_units=8, flow_n_flows=2, flow_output_fn="tanh",
        spatial_shape=(H, W), convex_net_hidden_units=8,
        convex_net_hidden_layers=1, device=CPU)
    wrapper = TW.WrapperModule(
        segmentation_module=TS.UNet(in_chn=4, out_chn=1, device=CPU),
        prior_module=prior, input_mode="image",
        prior_arg_mode="param_clean_grid", seg_stateful=True)
    cfg = TR.JointTrainConfig(lr=1e-3, prior_lr=1e-3)
    state = TR.joint_train_init(wrapper, torch.Generator().manual_seed(0),
                                4, cfg)
    g = torch.Generator().manual_seed(1)
    data = {"image": torch.rand((4, H, W, 3), generator=g),
            "features": torch.rand((4, H, W, 1), generator=g),
            "grid": TG.flatten_grid(TG.pixel_grid((H, W), device=CPU)),
            "target": (torch.rand((4, H, W, 1), generator=g) > 0.5).float()}
    epoch = TR.make_joint_epoch_fn(wrapper, cfg)
    spans = _profiled(lambda: epoch(state, data, np.array([[0, 2], [1, 3]]),
                                    np.ones((2, 2), np.float32)))
    backward = [s for s in spans if s[0] == "joint.backward"]
    assert len(backward) == 2
    for b in backward:
        assert [s[0] for s in _inside(b, spans)] == ["joint.prior_grad"]
    for s in spans:
        if s[0] == "joint.step":
            assert [i[0] for i in _inside(s, spans)] == [
                "joint.forward", "joint.backward", "joint.prior_grad",
                "joint.update"]
    assert {k: v[0] for k, v in span.totals.items()} == {
        "joint.step": 2, "joint.forward": 2, "joint.backward": 2,
        "joint.prior_grad": 2, "joint.update": 2}


def test_loop_counts_image_steps_and_masked_image_steps():
    before = PF.fit_loop_counts()
    params = {"w": torch.zeros((3, 2))}

    def loss_grad(p):
        return (p["w"] - 1.0).pow(2).sum(dim=1), {"w": 2 * (p["w"] - 1.0)}

    PF.run_fit_loop(loss_grad, params, PF.FitConfig(num_steps=4),
                    {"w": 0.0}, lambda p: p,
                    active=torch.tensor([True, False, True]),
                    batch_shape=(3,))
    after = PF.fit_loop_counts()
    assert after["steps"] - before["steps"] == 4
    assert after["image_steps"] - before["image_steps"] == 12
    assert after["masked_image_steps"] - before["masked_image_steps"] == 4


@pytest.mark.parametrize("active, masked", [(True, 0), (False, 2)])
def test_loop_counts_host_active(active, masked):
    before = PF.fit_loop_counts()
    PF.run_fit_loop(lambda p: ((p["w"] ** 2).sum(), {"w": 2 * p["w"]}),
                    {"w": torch.ones(2)}, PF.FitConfig(num_steps=2),
                    {"w": 0.0}, lambda p: p, active=active)
    after = PF.fit_loop_counts()
    assert after["image_steps"] - before["image_steps"] == 2
    assert after["masked_image_steps"] - before["masked_image_steps"] == \
        masked


def test_passing_gated_batch_masks_its_whole_refit():
    """Every gate passes (threshold 0): the retry still refits the batch,
    with every image masked, so B x steps masked image-steps of 2 x B x
    steps."""
    model = _model()
    pts, tgt = _batch(3)
    run = PF.make_batched_fit_fn(
        model, PF.FitConfig(num_steps=4, gate_threshold=0.0))
    before = PF.fit_loop_counts()
    _, aux = run(_init(model, 3), pts, tgt, retry_keys=[1, 2, 3])
    after = PF.fit_loop_counts()
    assert bool(aux["gate_pass"].all())
    assert after["image_steps"] - before["image_steps"] == 2 * 3 * 4
    assert after["masked_image_steps"] - before["masked_image_steps"] == 3 * 4
