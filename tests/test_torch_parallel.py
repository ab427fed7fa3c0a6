"""The port's device mesh (``awesome_tpu_torch/parallel``) on CPU ranks:
sharded fits, steps and runs against the single-process port and, for
the batched fit, the JAX package's ``fit_priors_sharded`` on its 8-device
CPU mesh. Counterpart of ``tests/test_parallel.py`` at its tolerances.

One group of 4 gloo ranks (``parallel.launch.spawn``) runs every case
once for the module (``_rank_cases``); each test reads its case's
results. Cases on a smaller mesh build it on ranks 0-1. Every rank's
results must also agree with rank 0's: the ranks never diverge.
"""
import os

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
WORLD = 4


def _unaries(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    fg = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2) <= (h / 3) ** 2
    return 1.0 - fg.astype(np.float32)


def _icnn():
    from awesome_tpu_torch.nn.icnn import ConvexNextNet

    return ConvexNextNet(n_hidden=16, n_hidden_layers=1, device=CPU)


def _grid(h, w):
    from awesome_tpu_torch.core import grids as G

    return G.flatten_grid(G.pixel_grid((h, w), device=CPU))


def _targets(b, h, w):
    return torch.stack([torch.as_tensor(_unaries(h, w)).reshape(-1, 1)] * b)


def _fit_cfg(**kw):
    from awesome_tpu_torch.fit.prior_fit import FitConfig

    return FitConfig(**dict({"num_steps": 30, "lr": 2e-3,
                             "optimizer": "adam"}, **kw))


def _flagship(h, w):
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )

    return real_nvp_path_connected_net(
        channels=2, hidden_units=8, flow_n_flows=3, flow_output_fn="tanh",
        spatial_shape=(h, w), convex_net_hidden_units=8,
        convex_net_hidden_layers=1, device=CPU)


def _unet_wrapper(prior, out_chn=1):
    from awesome_tpu_torch.nn.seg import UNet
    from awesome_tpu_torch.nn.wrapper import WrapperModule

    return WrapperModule(
        segmentation_module=UNet(in_chn=4, out_chn=out_chn, device=CPU),
        prior_module=prior, input_mode="image",
        prior_arg_mode="param_clean_grid", seg_stateful=True)


def _multi_object_setup():
    from awesome_tpu_torch.fit.trainer import (
        JointTrainConfig,
        multi_object_train_init,
    )
    from awesome_tpu_torch.nn.icnn import ConvexNextNet
    from awesome_tpu_torch.nn.multi_prior import MultiPriorModule

    h = w = 16
    k = 2
    wrapper = _unet_wrapper(MultiPriorModule(
        ConvexNextNet(in_features=2, n_hidden=8, n_hidden_layers=1,
                      device=CPU), max_priors=k), out_chn=k)
    cfg = JointTrainConfig(lr=1e-3, prior_lr=1e-3)
    state = multi_object_train_init(wrapper, torch.Generator().manual_seed(0),
                                    4, cfg, initial_count=k)
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.as_tensor(rng.random((4, h, w, 3)), dtype=torch.float32),
        "features": torch.as_tensor(rng.random((4, h, w, 1)),
                                    dtype=torch.float32),
        "grid": _grid(h, w),
        "target_obj": torch.as_tensor(
            (rng.random((4, h, w, k)) > 0.7).astype(np.float32)),
        "labeled": torch.as_tensor(rng.random((4, h, w)) > 0.4),
        "index": torch.arange(4),
    }
    return wrapper, cfg, state, batch


def _joint_setup():
    from awesome_tpu_torch.fit.trainer import JointTrainConfig, joint_train_init

    h = w = 16
    wrapper = _unet_wrapper(_flagship(h, w))
    cfg = JointTrainConfig(lr=1e-3, prior_lr=1e-3)
    state = joint_train_init(wrapper, torch.Generator().manual_seed(0), 4,
                             cfg)
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.as_tensor(rng.random((4, h, w, 3)), dtype=torch.float32),
        "features": torch.as_tensor(rng.random((4, h, w, 1)),
                                    dtype=torch.float32),
        "grid": _grid(h, w),
        "target": torch.as_tensor(
            (rng.random((4, h, w, 1)) > 0.5).astype(np.float32)),
        "index": torch.arange(4),
    }
    return wrapper, cfg, state, batch


def _runner_config(mesh_shape, root):
    from awesome_tpu_torch.runner.config import AwesomeConfig

    return AwesomeConfig(
        name_experiment="mesh_cfg", dataset_args={"n": 4, "h": 16, "w": 16},
        segmentation_model_args={"n_hidden": 16},
        prior_model_args={"n_hidden": 12, "n_hidden_layers": 1},
        optimizer_type="adam", optimizer_args={"lr": 0.02}, num_epochs=40,
        pretrain_args={"num_epochs": 30}, runs_path=root, seed=5,
        mesh_shape=mesh_shape, device=CPU)


def _run_runner(mesh_shape, root):
    from awesome_tpu_torch.runner.runner import AwesomeRunner

    runner = AwesomeRunner(_runner_config(mesh_shape, root))
    runner.build()
    shape = None if runner.mesh is None else dict(runner.mesh.shape)
    runner.pretrain()
    result = runner.train()
    return {"loss_hist": result["loss_hist"], "metrics": runner.evaluate(),
            "mesh": shape}


def _leaves(tree):
    from awesome_tpu_torch.core import tree as T

    return [x.detach().numpy().copy() for x in T.tree_leaves(tree)]


def _rebuild(like, leaves):
    """``like``'s structure with ``leaves`` (as tensors) in its order."""
    from awesome_tpu_torch.core import tree as T

    it = iter(leaves)
    return T.tree_map(lambda _: torch.as_tensor(next(it)), like)


# --- the cases, run by every rank --------------------------------------------


def _case_batched(stacked_np, shape):
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.parallel import fit_priors_sharded, make_mesh

    mesh = make_mesh(shape)
    b = T.tree_leaves(stacked_np)[0].shape[0]
    stacked = T.tree_map(torch.as_tensor, stacked_np)
    fitted, aux = fit_priors_sharded(_icnn(), stacked, _grid(16, 16),
                                     _targets(b, 16, 16), _fit_cfg(),
                                     mesh=mesh)
    return {"params": _leaves(fitted),
            "loss_hist": aux["loss_hist"].numpy()}


def _case_grid_loss():
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.parallel import make_mesh

    mesh = make_mesh((1, WORLD))
    model = _icnn()
    params = model.init(torch.Generator().manual_seed(0))
    pts, tgt = _grid(16, 16), _targets(1, 16, 16)[0]
    n = pts.shape[0]
    gs = mesh.local("grid", n)

    def local_loss(p):
        prob = torch.sigmoid(model.apply(p, pts[gs]))
        return torch.sum((prob - tgt[gs]) ** 2) / n

    grads, loss = torch.func.grad_and_value(local_loss)(params)
    loss = mesh.sum_over("grid", loss)
    grads = mesh.sum_over_tree("grid", grads)
    assert T.tree_leaves(params)[0].shape == T.tree_leaves(grads)[0].shape
    return {"loss": float(loss), "grads": _leaves(grads)}


def _case_fused():
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.fused_fit import _FlatFit
    from awesome_tpu_torch.fit.prior_fit import (
        _stacked_weights,
        fit_priors_batched,
    )
    from awesome_tpu_torch.parallel import make_mesh

    mesh = make_mesh((1, 2), ranks=[0, 1])
    if mesh is None:
        return None
    h = w = 16
    model = _flagship(h, w)
    stacked = T.stack_trees([model.init(torch.Generator().manual_seed(i))
                             for i in range(2)])
    cfg = _fit_cfg(fused=True, fg_weight=0.4, optimizer="adamax")
    pts, tgt = _grid(h, w), _targets(2, h, w)
    tgt[1, :40] = 0.0  # another foreground share in image 1
    # one step's loss and grads: this rank's half of the points, the
    # weights over the whole image, the two halves summed
    eng = _FlatFit(model, cfg, None)
    gs, grid_sum = mesh.local("grid", h * w), mesh.reducer("grid", h * w)
    wts = _stacked_weights(tgt[:, gs], cfg, None, grid_sum)
    flat = eng.pack(stacked)
    loss, grads = eng.fused.flat(flat, pts[gs].contiguous(),
                                 tgt[:, gs, 0].contiguous(),
                                 wts[..., 0].contiguous())
    loss, grads = mesh.sum_over("grid", loss), mesh.sum_over("grid", grads)
    fitted, aux = fit_priors_batched(model, stacked, pts, tgt, cfg,
                                     mesh=mesh)
    return {"loss": loss.numpy(), "grads": grads.numpy(),
            "params": _leaves(fitted), "loss_hist": aux["loss_hist"].numpy()}


def _case_spatiotemporal():
    from awesome_tpu_torch.fit.spatiotemporal import sequence_points
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )
    from awesome_tpu_torch.parallel import (
        fit_spatiotemporal_sharded,
        make_mesh,
    )

    h = w = 8
    t = 3
    model = real_nvp_path_connected_net(
        channels=3, hidden_units=8, flow_n_flows=3, flow_output_fn="tanh",
        spatial_shape=(h, w), convex_net_hidden_units=8,
        convex_net_hidden_layers=1, device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    targets = torch.as_tensor((rng.random((t, h * w, 1)) > 0.5).astype(
        np.float32))
    labeled = torch.as_tensor(rng.random((t, h * w)) > 0.3)
    fitted, aux = fit_spatiotemporal_sharded(
        model, params, sequence_points((h, w), t, device=CPU), targets,
        labeled, _fit_cfg(num_steps=10, weight_mode="equal"),
        mesh=make_mesh((1, WORLD)), num_epochs=10)
    return {"params": _leaves(fitted), "epoch_loss": aux["epoch_loss"].numpy()}


def _case_multi_object():
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.trainer import make_multi_object_train_step
    from awesome_tpu_torch.parallel import make_mesh

    wrapper, cfg, state, batch = _multi_object_setup()
    step = make_multi_object_train_step(wrapper, cfg,
                                        mesh=make_mesh((2, 2)))
    new_state, metrics = step(state, batch)
    # the UNet's params are large: each rank measures them against the
    # unsharded step itself
    ref, _ = make_multi_object_train_step(wrapper, cfg)(state, batch)
    seg_err = max(float((a - b).abs().max()) for a, b in zip(
        T.tree_leaves(new_state.seg_params), T.tree_leaves(ref.seg_params)))
    return {"loss": float(metrics["loss"]),
            "prior": _leaves(new_state.prior_params),
            "seg_max_abs_err": seg_err,
            "seg_state": _leaves(new_state.seg_state)}


def _bn_inputs():
    from awesome_tpu_torch.nn.conv import batchnorm_init

    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(1.0, 2.0, (4, 6, 5, 3)),
                        dtype=torch.float32)
    r = torch.as_tensor(rng.normal(size=(4, 6, 5, 3)), dtype=torch.float32)
    params, state = batchnorm_init(3, device=CPU)
    params = {"scale": torch.tensor([1.0, 2.0, 0.5]),
              "bias": torch.tensor([0.1, -0.2, 0.3])}
    return x, r, params, state


def _bn_run(x, r, params, state):
    """(y, new running stats, d sum(y * r) / dx)."""
    from awesome_tpu_torch.nn.conv import batchnorm_apply

    x = x.clone().requires_grad_(True)
    y, new = batchnorm_apply(params, state, x, train=True)
    (g,) = torch.autograd.grad((y * r).sum(), x)
    return y.detach(), new, g


def _case_batch_norm():
    from awesome_tpu_torch.nn.conv import batch_stats_over
    from awesome_tpu_torch.parallel import make_mesh

    mesh = make_mesh((2, 1), ranks=[0, 1])
    if mesh is None:
        return None
    x, r, params, state = _bn_inputs()
    rows = mesh.local("data", 4)
    with batch_stats_over(mesh):
        y, new, g = _bn_run(x[rows], r[rows], params, state)
    return {"y": mesh.gather("data", y).numpy(),
            "grad": mesh.gather("data", g).numpy(),
            "mean": new["mean"].numpy(), "var": new["var"].numpy()}


def _case_resume(root):
    import torch.distributed as dist

    from awesome_tpu_torch.fit.checkpoint import AgentCheckpoint
    from awesome_tpu_torch.fit.trainer import make_joint_train_step
    from awesome_tpu_torch.parallel import make_mesh

    mesh = make_mesh((2, 2))
    wrapper, cfg, state0, batch = _joint_setup()
    step = make_joint_train_step(wrapper, cfg, mesh=mesh)
    s = state0
    for _ in range(4):
        s, _ = step(s, batch)
    straight = s
    s = state0
    for _ in range(2):
        s, _ = step(s, batch)
    d = os.path.join(root, "resume_ck")
    if mesh.is_root:
        AgentCheckpoint("resume", params=s).save(d)
    dist.barrier()
    loaded = AgentCheckpoint.load(d, params_template=state0,
                                  device=CPU).params
    s2 = loaded
    for _ in range(2):
        s2, _ = step(s2, batch)
    from awesome_tpu_torch.core import tree as T

    diff = [i for i, (a, b) in enumerate(zip(T.tree_leaves(straight),
                                             T.tree_leaves(s2)))
            if not torch.equal(a, b)]
    return {"differing_leaves": diff, "leaves": len(T.tree_leaves(s2)),
            "kind": type(loaded).__name__}


def _helper_inputs():
    """Leaves for the placement helpers: (4, 6, 3) and (4,) stacked, (6,
    2), (3, 5) and (5, 2) that only some axes divide, and a 0-d one."""
    x = np.arange(72, dtype=np.float32).reshape(4, 6, 3)
    return {"x": x, "m": np.arange(4, dtype=np.float32),
            "y": np.arange(12, dtype=np.float32).reshape(6, 2),
            "z": np.arange(15, dtype=np.float32).reshape(3, 5),
            "o": np.arange(10, dtype=np.float32).reshape(5, 2),
            "c": np.float32(7.0)}


def _helper_calls(mod, mesh, leaf):
    """The placement helpers of ``mod`` (the port's or JAX's) on the
    inputs, each result under a name."""
    v = {k: leaf(a) for k, a in _helper_inputs().items()}
    stacked = {"x": v["x"], "m": v["m"], "o": v["o"], "c": v["c"]}
    return {
        "batched_data": mod.shard_batched(mesh, {"x": v["x"], "y": v["y"]}),
        "batched_grid": mod.shard_batched(mesh, v["x"], "grid"),
        "replicate": mod.replicate(mesh, v["x"]),
        "maybe_both": mod.maybe_shard(mesh, v["x"], ("data", "grid")),
        "maybe_uneven": mod.maybe_shard(mesh, v["z"], ("data", "grid")),
        "maybe_unknown_axis": mod.maybe_shard(mesh, v["x"],
                                              (None, "rows", "grid")),
        "leading_4": mod.shard_leading_stacked(mesh, stacked, 4),
        "leading_none": mod.shard_leading_stacked(mesh, stacked, None),
        "leading_uneven": mod.shard_leading_stacked(mesh, {"o": v["o"]}, 5),
    }


def _case_helpers():
    """This rank's block of every helper's result on the (2, 2) mesh."""
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch import parallel

    out = _helper_calls(parallel, parallel.make_mesh((2, 2)),
                        torch.as_tensor)
    return T.tree_map(lambda t: t.numpy().copy(), out)


def _rank_cases(root, jax_stacked8):
    import torch.distributed as dist

    from awesome_tpu_torch.core import tree as T

    out = {
        "batched_4x1": _case_batched(jax_stacked8, (WORLD, 1)),
        "grid_loss": _case_grid_loss(),
        "batched_2x2": _case_batched(
            T.tree_map(lambda v: v[:4], jax_stacked8), (2, 2)),
        "fused": _case_fused(),
        "spatiotemporal": _case_spatiotemporal(),
        "multi_object": _case_multi_object(),
        "batch_norm": _case_batch_norm(),
        "resume": _case_resume(root),
        "runner": _run_runner([2, 2], os.path.join(root, "mesh_runs")),
    }
    # the UNet's leaves are large: rank 0 sends the results, every rank
    # their digests
    digests = {name: _digest(res) for name, res in out.items()}
    if dist.get_rank() != 0:
        out = {}
    # each rank holds its own block of the helpers' results
    out["helpers"] = _case_helpers()
    return {"results": out, "digests": digests}


def _digest(value) -> str:
    """A hash of every array and number in ``value`` (None for None)."""
    import hashlib

    if value is None:
        return "none"
    h = hashlib.sha1()

    def walk(v):
        if isinstance(v, dict):
            for k in sorted(v):
                h.update(str(k).encode())
                walk(v[k])
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, np.ndarray):
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(repr(v).encode())

    walk(value)
    return h.hexdigest()


# --- the module's group ------------------------------------------------------


def _jax_model():
    from awesome_tpu.nn.icnn import ConvexNextNet as JConvexNextNet

    return JConvexNextNet(n_hidden=16, n_hidden_layers=1)


def _jax_stacked8():
    """8 ConvexNextNet inits of the JAX package: the JAX tree and the
    port's (numpy leaves)."""
    import jax

    from awesome_tpu_torch.bridge import params_from_jax
    from awesome_tpu_torch.core import tree as T

    stacked = jax.vmap(_jax_model().init)(
        jax.random.split(jax.random.PRNGKey(0), 8))
    port = params_from_jax(jax.device_get(stacked), device=CPU, stacked=True)
    return stacked, T.tree_map(lambda v: v.numpy(), port)


def _jax_fit_sharded(stacked):
    """The JAX package's ``fit_priors_sharded`` on its (8, 1) CPU mesh."""
    import jax
    import jax.numpy as jnp

    from awesome_tpu.core import grids as JG
    from awesome_tpu.fit import FitConfig as JFitConfig
    from awesome_tpu.parallel import fit_priors_sharded, make_mesh

    points = JG.flatten_grid(JG.pixel_grid((16, 16)))
    targets = jnp.stack([jnp.asarray(_unaries(16, 16)).reshape(-1, 1)] * 8)
    cfg = JFitConfig(num_steps=30, lr=2e-3, optimizer="adam")
    fitted, _ = fit_priors_sharded(_jax_model(), stacked, points, targets,
                                   cfg, mesh=make_mesh((8, 1)))
    return [np.asarray(a) for a in
            jax.tree_util.tree_leaves(jax.device_get(fitted))]


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    from awesome_tpu_torch.parallel.launch import start

    root = str(tmp_path_factory.mktemp("mesh"))
    stacked, host = _jax_stacked8()
    ranks = start(_rank_cases, WORLD, (root, host), device=CPU, threads=1)
    jax_fitted = _jax_fit_sharded(stacked)  # while the ranks run
    return {"ranks": ranks.join(), "root": root, "jax_stacked8": host,
            "jax_fitted8": jax_fitted}


def _case(mesh_results, name, world=WORLD):
    """Rank 0's results of ``name``, after checking that every rank of the
    case's mesh got the same ones (bitwise, by digest)."""
    ranks = mesh_results["ranks"]
    for other in ranks[1:world]:
        assert other["digests"][name] == ranks[0]["digests"][name], name
    return ranks[0]["results"][name]


# --- the tests ---------------------------------------------------------------


def test_mesh_larger_than_the_world_raises():
    """As JAX's ``make_mesh`` for devices: a shape that is not the
    world's size raises ``ValueError``, and so does a runner config whose
    ``mesh_shape`` asks for more processes than this one."""
    from awesome_tpu_torch.parallel import make_mesh, mesh_from_config
    from awesome_tpu_torch.runner.config import AwesomeConfig

    with pytest.raises(ValueError, match="processes"):
        make_mesh((2, 2))
    with pytest.raises(ValueError, match="needs 4 processes"):
        mesh_from_config(AwesomeConfig(mesh_shape=[2, 2], device=CPU))
    mesh = make_mesh((1, 1), device=CPU)
    assert mesh.shape == {"data": 1, "grid": 1}
    assert mesh.device == torch.device(CPU)
    if not torch.cuda.is_available():
        # the card by default: without one, only an explicit CPU mesh
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh((1, 1))
    assert mesh.local("grid", 7) == slice(0, 7)
    assert mesh_from_config(AwesomeConfig(device=CPU)) is None


def test_placement_helpers_match_jax(mesh_results):
    """``shard_batched``, ``replicate``, ``maybe_shard`` and
    ``shard_leading_stacked`` on a (2, 2) mesh: every rank's block is the
    shard that JAX's helper puts on the same position of its (2, 2) mesh
    of CPU devices, exactly; a size the axis does not divide, an axis
    name the mesh lacks, ``batch=None`` and a 0-d leaf stay whole."""
    import jax
    import jax.numpy as jnp

    from awesome_tpu.parallel import mesh as jmesh

    mesh = jmesh.make_mesh((2, 2), devices=jax.devices()[:4])
    want = _helper_calls(jmesh, mesh, jnp.asarray)
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    for r, rank in enumerate(mesh_results["ranks"]):
        dev = mesh.devices[r // 2, r % 2]
        got = dict(jax.tree_util.tree_flatten_with_path(
            rank["results"]["helpers"])[0])
        assert len(got) == len(flat)
        for path, arr in flat:
            shard = [s.data for s in arr.addressable_shards
                     if s.device == dev]
            np.testing.assert_array_equal(
                got[path], np.asarray(shard[0]),
                err_msg=f"rank {r}, {jax.tree_util.keystr(path)}")


def test_sharded_batched_fit_matches_single_device(mesh_results):
    """8 images over a (4, 1) mesh against the port's single ``fit_prior``
    of image 3 and against JAX's ``fit_priors_sharded`` of the same inits
    on its (8, 1) mesh (the leaves in JAX's order through ``bridge``)."""
    import jax

    from awesome_tpu_torch.bridge import params_to_numpy
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.prior_fit import fit_prior

    res = _case(mesh_results, "batched_4x1")
    stacked = T.tree_map(torch.as_tensor, mesh_results["jax_stacked8"])
    single, _ = fit_prior(_icnn(), T.tree_select(stacked, 3), _grid(16, 16),
                          _targets(1, 16, 16)[0], _fit_cfg())
    fitted = _rebuild(stacked, res["params"])
    for a, b in zip(_leaves(T.tree_select(fitted, 3)), _leaves(single)):
        np.testing.assert_allclose(a, b, atol=1e-4)
    got = jax.tree_util.tree_leaves(params_to_numpy(fitted, stacked=True))
    for a, b in zip(got, mesh_results["jax_fitted8"]):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_grid_axis_loss_and_grads(mesh_results):
    """The points over a (1, 4) mesh's grid axis: the summed loss and
    grads equal the single-process mean SE and its grads."""
    res = _case(mesh_results, "grid_loss")
    model = _icnn()
    params = model.init(torch.Generator().manual_seed(0))
    pts, tgt = _grid(16, 16), _targets(1, 16, 16)[0]

    def loss(p):
        return torch.mean((torch.sigmoid(model.apply(p, pts)) - tgt) ** 2)

    grads, val = torch.func.grad_and_value(loss)(params)
    np.testing.assert_allclose(res["loss"], float(val), rtol=1e-6)
    for a, b in zip(res["grads"], _leaves(grads)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_2d_sharded_batched_fit_matches_single_device(mesh_results):
    """4 images over 'data' x the points over 'grid' on (2, 2)."""
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.prior_fit import fit_prior

    res = _case(mesh_results, "batched_2x2")
    stacked = T.tree_map(torch.as_tensor, mesh_results["jax_stacked8"])
    single, _ = fit_prior(_icnn(), T.tree_select(stacked, 1), _grid(16, 16),
                          _targets(1, 16, 16)[0], _fit_cfg())
    fitted = _rebuild(stacked, res["params"])
    for a, b in zip(_leaves(T.tree_select(fitted, 1)), _leaves(single)):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_fused_route_on_the_grid_axis(mesh_results):
    """The fused flagship route (its plain version here) with the points
    over a (1, 2) grid axis and ``fg_weight``, so the point weights need
    the whole image's class counts: one step's loss and grads and the
    fit's loss history against the unsharded fit."""
    from awesome_tpu_torch.core import tree as T
    from awesome_tpu_torch.fit.fused_fit import _FlatFit
    from awesome_tpu_torch.fit.prior_fit import (
        _stacked_weights,
        fit_priors_batched,
    )

    res = _case(mesh_results, "fused", world=2)
    h = w = 16
    model = _flagship(h, w)
    stacked = T.stack_trees([model.init(torch.Generator().manual_seed(i))
                             for i in range(2)])
    cfg = _fit_cfg(fused=True, fg_weight=0.4, optimizer="adamax")
    pts, tgt = _grid(h, w), _targets(2, h, w)
    tgt[1, :40] = 0.0
    eng = _FlatFit(model, cfg, None)
    wts = _stacked_weights(tgt, cfg, None)
    loss, grads = eng.fused.flat(eng.pack(stacked), pts, tgt[..., 0],
                                 wts[..., 0])
    np.testing.assert_allclose(res["loss"], loss.numpy(), rtol=2e-5)
    np.testing.assert_allclose(res["grads"], grads.numpy(), rtol=5e-4,
                               atol=1e-6)
    _, aux = fit_priors_batched(model, stacked, pts, tgt, cfg)
    np.testing.assert_allclose(res["loss_hist"], aux["loss_hist"].numpy(),
                               rtol=2e-4)


def test_spatiotemporal_sharded_matches_single_device(mesh_results):
    from awesome_tpu_torch.fit.spatiotemporal import (
        fit_spatiotemporal_prior,
        sequence_points,
    )
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )

    res = _case(mesh_results, "spatiotemporal")
    h = w = 8
    t = 3
    model = real_nvp_path_connected_net(
        channels=3, hidden_units=8, flow_n_flows=3, flow_output_fn="tanh",
        spatial_shape=(h, w), convex_net_hidden_units=8,
        convex_net_hidden_layers=1, device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    targets = torch.as_tensor((rng.random((t, h * w, 1)) > 0.5).astype(
        np.float32))
    labeled = torch.as_tensor(rng.random((t, h * w)) > 0.3)
    single, aux = fit_spatiotemporal_prior(
        model, params, sequence_points((h, w), t, device=CPU), targets,
        labeled, _fit_cfg(num_steps=10, weight_mode="equal"), num_epochs=10)
    for a, b in zip(res["params"], _leaves(single)):
        np.testing.assert_allclose(a, b, atol=1e-4)
    np.testing.assert_allclose(res["epoch_loss"], aux["epoch_loss"].numpy(),
                               rtol=1e-4)


def test_multi_object_step_sharded_matches_single_device(mesh_results):
    """The multi-object step on (2, 2): frames over 'data' (the UNet's
    batch norm over the whole batch), points over 'grid'."""
    from awesome_tpu_torch.fit.trainer import make_multi_object_train_step

    res = _case(mesh_results, "multi_object")
    wrapper, cfg, state, batch = _multi_object_setup()
    ref, metrics = make_multi_object_train_step(wrapper, cfg)(state, batch)
    np.testing.assert_allclose(res["loss"], float(metrics["loss"]),
                               rtol=1e-5)
    for a, b in zip(res["prior"], _leaves(ref.prior_params)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for a, b in zip(res["seg_state"], _leaves(ref.seg_state)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # Adam's first step moves near-zero grads by up to ~the lr (atol
    # 2e-3, measured by the ranks against this unsharded step)
    assert res["seg_max_abs_err"] <= 2e-3


def test_batch_norm_over_the_data_axis(mesh_results):
    """Training-mode batch norm with the batch split over a (2, 1) mesh's
    data axis: the output, the running stats and the input grads of the
    whole batch's statistics, within float32 summation order (rtol 1e-5,
    atol 1e-6)."""
    res = _case(mesh_results, "batch_norm", world=2)
    y, new, g = _bn_run(*_bn_inputs())
    np.testing.assert_allclose(res["y"], y.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res["grad"], g.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res["mean"], new["mean"].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(res["var"], new["var"].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_sharded_checkpoint_resume_bit_identical(mesh_results):
    """A (2, 2)-mesh joint state saved after 2 of 4 steps (rank 0), loaded
    on every rank and stepped on equals the uninterrupted run bitwise."""
    res = _case(mesh_results, "resume")
    assert res["kind"] == "JointTrainState"
    assert res["leaves"] > 0 and res["differing_leaves"] == []


def test_runner_mesh_config_equal_losses(mesh_results, tmp_path):
    """The runner with ``mesh_shape=[2, 2]`` (pretrain -> train ->
    evaluate) against one process: equal loss histories and metrics."""
    res = _case(mesh_results, "runner")
    assert res["mesh"] == {"data": 2, "grid": 2}
    single = _run_runner(None, str(tmp_path))
    assert single["mesh"] is None
    np.testing.assert_allclose(res["loss_hist"], single["loss_hist"],
                               rtol=2e-3, atol=2e-4)
    assert abs(res["metrics"]["MeanForegroundBinaryMIOU"]
               - single["metrics"]["MeanForegroundBinaryMIOU"]) < 2e-2
    # only rank 0 wrote the pretrain state and checkpoints
    runs = os.path.join(mesh_results["root"], "mesh_runs")
    assert len(os.listdir(runs)) == 1
