"""Port parity: the teaser harness (``awesome_tpu_torch/runner/teaser.py``),
its two scripts and the four how-to examples, against the JAX package's
``awesome_tpu/runner/teaser.py`` on a synthetic reference tree
(``tools/teaser_tree.py``: 24x32 images, the temporal masks 8x12).

- The numpy parts and ``centered_points`` are exact.
- ``minibatch_fit`` takes JAX's index draws (the JAX PRNG replayed as
  ``minibatch_fit`` draws them) through the port's ``_draw_indices`` and
  JAX's init through ``bridge.params_from_jax``: loss history rtol 2e-4
  (``tests/test_fused_fit.py:37``), final params rtol 5e-4, atol 1e-6.
- ``run_howto_convexity`` and ``run_convex_depth`` against the JAX
  protocols from one init: final loss rtol 2e-4, masks equal but for at
  most ``MASK_PIXELS`` pixels (of 192) at the threshold.
- Every protocol, the scripts and the examples on the port alone, at a
  tiny step scale; the flow-identity prefits (100 steps in the protocols,
  whatever the scale) are cut to ``PREFIT_STEPS`` to keep the file's
  budget.

``tests/teaser_jax_vs_port.py`` runs the star and lattice protocols of
both packages from one init and JAX's draws at sizes beyond this budget.
"""
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.nn import convex_diffeo as JCD
from awesome_tpu.nn import icnn as JI
from awesome_tpu.nn import priors_extra as JP
from awesome_tpu.runner import teaser as JT
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.fit import prior_fit as TF
from awesome_tpu_torch.nn import convex_diffeo as TCD
from awesome_tpu_torch.nn import icnn as TI
from awesome_tpu_torch.nn import priors_extra as TP
from awesome_tpu_torch.nn.module import make_generator
from awesome_tpu_torch.runner import teaser as TT
from tools.teaser_tree import write_tree
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
HIST_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-4, 1e-6
MASK_PIXELS = 2
RESTARTS = ("repeating", "connectedness_cat")  # the restart ensembles
TINY = 0.0005  # steps_scale: 1-8 steps per fit
PREFIT_STEPS = 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_params_close(port, jax_tree):
    want = dict(_leaves(params_from_jax(jax.device_get(jax_tree),
                                        device=CPU)))
    got = dict(_leaves(port))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.endswith("scale/v") and v.shape == (1, 1):
            # a 1x1 weight-normalized layer (``nn/flows.py:_wnscale_init``)
            # computes g * v / |v| = g * sign(v): v's gradient is 0 but for
            # rounding, which Adam scales up to steps of up to lr. The
            # function sees only v's sign.
            assert torch.equal(torch.sign(got[k]), torch.sign(v)), k
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The synthetic tree, with both packages' paths pointed at it and the
    port's flow-identity prefits cut to ``PREFIT_STEPS``."""
    root = str(tmp_path_factory.mktemp("reference"))
    write_tree(root, 24, 32, frame_shape=(8, 12))
    prefit = TF.learn_flow_identity
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JT, TT):
            mp.setattr(mod, "REFERENCE_ROOT", root)
            mp.setattr(mod, "TEASER_DIR", os.path.join(
                root, "notebooks", "icml_teaser_code"))
            mp.setattr(mod, "HOWTO_DIR", os.path.join(
                root, "notebooks", "how_to", "data"))
        mp.setattr(TF, "learn_flow_identity", lambda *a, **k: prefit(
            *a, **dict(k, max_iter=PREFIT_STEPS)))
        yield root


# ------------------------------------------------------- the numpy parts


def _lattice(h, w, period, dy=0, dx=0):
    yy, xx = np.mgrid[0:h, 0:w]
    return (((yy + dy) % period) < 6) & (((xx + dx) % period) < 6)


def test_mask_iou_and_periods_exact():
    rng = np.random.default_rng(0)
    a, b = rng.random((2, 40, 56)) < 0.4
    assert TT.mask_iou(a, b) == JT.mask_iou(a, b)
    assert TT.mask_iou(a, np.zeros_like(a)) == 0.0
    for m in (_lattice(96, 96, 16), _lattice(60, 80, 12, 3, 5), a):
        for axis in (0, 1):
            assert TT._axis_period(m, axis) == JT._axis_period(m, axis)
    for dy, dx in ((3, -2), (-5, 0), (0, 7)):
        assert TT._shifted_iou(a, b, dy, dx) == JT._shifted_iou(a, b, dy, dx)


def test_phase_aligned_iou_half_period_lattice():
    """``tests/test_reference_images.py:56``'s case: a lattice shifted by
    half a period scores ~0 raw and ~1 phase-aligned, in both packages
    alike; a wrong shape is not rescued."""
    ref = _lattice(96, 96, 16)
    shifted = _lattice(96, 96, 16, 8, 8)
    pa, (dy, dx) = TT.phase_aligned_iou(shifted, ref)
    assert (pa, (dy, dx)) == JT.phase_aligned_iou(shifted, ref)
    assert TT.mask_iou(shifted, ref) < 0.05 and pa > 0.95
    assert (abs(dy) % 16, abs(dx) % 16) == (8, 8)
    yy, xx = np.mgrid[0:96, 0:96]
    blob = (yy - 48) ** 2 + (xx - 48) ** 2 < 32 ** 2
    pa_blob = TT.phase_aligned_iou(blob, ref, period_mask=ref)
    assert pa_blob == JT.phase_aligned_iou(blob, ref, period_mask=ref)
    assert pa_blob[0] < 0.4


def test_ensemble_logits_exact():
    rng = np.random.default_rng(1)
    stack = rng.standard_normal((5, 6, 7)).astype(np.float32)
    tails = [0.2, np.nan, 0.25, 0.5, 0.21]  # a NaN and a failed restart
    np.testing.assert_array_equal(TT.ensemble_logits(stack, tails),
                                  JT.ensemble_logits(stack, tails))
    with pytest.raises(ValueError):
        TT.ensemble_logits(stack[:2], [np.nan, np.inf])


@pytest.mark.parametrize("h,w", [(7, 10)])
def test_centered_points_exact(h, w):
    np.testing.assert_array_equal(
        TT.centered_points(h, w, CPU).numpy(),
        np.asarray(JT.centered_points(h, w)))


def test_loaders_exact(tree):
    path = os.path.join(TT.TEASER_DIR, "star_shaped", "starfish.jpg")
    for ds in (1, 2):
        np.testing.assert_array_equal(TT.load_image(path, ds),
                                      JT.load_image(path, ds))
    path = os.path.join(TT.TEASER_DIR, "repeating", "original", "mask.png")
    for shape in (None, (12, 16)):
        np.testing.assert_array_equal(TT.load_mask(path, shape),
                                      JT.load_mask(path, shape))
    assert TT.reference_data_available() and JT.reference_data_available()


def test_entry_points_default_to_the_card(tree):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.centered_points(4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.run_convex_depth(steps_scale=TINY)


# ------------------------------------------- minibatch_fit with JAX's draws


N0, N1, N_SAMPLE, STEPS = 30, 25, 6, 15


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_draws(base, steps, n_sample, n0, n1):
    """``minibatch_fit``'s draws from its base key, replayed: ``:216-218``
    and ``:248``."""
    def draw(k):
        k0, k1 = jax.random.split(k)
        return (jax.random.randint(k0, (n_sample,), 0, n0),
                jax.random.randint(k1, (n_sample,), 0, n1))

    return jax.vmap(draw)(jax.random.split(base, steps))


def _draws_of_jax(gen, steps, n_sample, n0, n1):
    """The port's ``_draw_indices`` made to return JAX's draws: the
    generator is seeded as JAX's base key is (``:194``)."""
    return tuple(torch.tensor(np.asarray(d), dtype=torch.int64)
                 for d in _jax_draws(jax.random.PRNGKey(gen.initial_seed()),
                                     steps, n_sample, n0, n1))


def _case(name):
    """(JAX model, port model, pts0, pts1, fit kwargs); the port's init
    seeds both packages (JAX's through ``bridge.params_to_numpy``)."""
    rng = np.random.default_rng(5)
    kw = dict(steps=STEPS, n_sample=N_SAMPLE, lr=1e-2, loss="se", seed=3)
    pts0 = rng.uniform(-0.45, 0.45, (N0, 2)).astype(np.float32)
    pts1 = rng.uniform(-0.45, 0.45, (N1, 2)).astype(np.float32)
    if name == "se_concat_convex":
        jm = JI.ConvexNextNet(n_hidden=8, n_hidden_layers=1)
        tm = TI.ConvexNextNet(n_hidden=8, n_hidden_layers=1, device=CPU)
        kw.update(concat_mean=True)
    elif name == "bce_coef_phase2_convex_diffeo":
        small = dict(n_hidden=8, nf_layers=2, nf_hidden=8)
        jm = JCD.ConvexDiffeomorphismNet.create(**small)
        tm = TCD.ConvexDiffeomorphismNet.create(**small, device=CPU)
        kw.update(loss="bce", coef0=2.0, lr=1e-3, params_are_phase2=True)
    else:  # a point at the offset: the radius's sqrt gives NaN grads
        pts0[-1] = 0.0
        jm = JP.RotationSymmetricNet(n_hidden=8)
        tm = TP.RotationSymmetricNet(n_hidden=8, device=CPU)
        kw.update(coef0=2.0, coef1=1.0, lr=1e-3)
    return jm, tm, pts0, pts1, kw


CASES = ["se_concat_convex", "bce_coef_phase2_convex_diffeo",
         "skip_nonfinite_symmetric"]


@pytest.mark.parametrize("name", CASES)
def test_minibatch_fit_matches_jax_with_its_draws(name, monkeypatch):
    jm, tm, pts0, pts1, kw = _case(name)
    p0 = tm.init(torch.Generator().manual_seed(4))
    j_fit, j_hist = JT.minibatch_fit(
        jm, jax.tree_util.tree_map(jnp.asarray, params_to_numpy(p0)),
        jnp.asarray(pts0), jnp.asarray(pts1), **kw)
    gen = torch.Generator().manual_seed(
        kw["seed"] + (1 << 20 if kw.get("params_are_phase2") else 0))
    draws = _draws_of_jax(gen, STEPS, N_SAMPLE, N0, N1)
    monkeypatch.setattr(TT, "_draw_indices", lambda *a: draws)
    t_fit, t_hist = TT.minibatch_fit(tm, p0, torch.as_tensor(pts0),
                                     torch.as_tensor(pts1), **kw)
    assert t_hist.shape == (STEPS,)
    np.testing.assert_allclose(t_hist.numpy(), np.asarray(j_hist),
                               rtol=HIST_RTOL)
    _assert_params_close(t_fit, j_fit)
    if name.startswith("skip"):
        hits = (draws[0] == N0 - 1).any(dim=1)  # steps that draw the offset
        assert 0 < int(hits.sum()) < STEPS, hits
        assert np.isfinite(t_hist.numpy()).all()


def test_minibatch_fit_skips_a_nonfinite_step(monkeypatch):
    """One step whose batch holds the offset: the grads are not finite,
    so the params come back unchanged, bit for bit."""
    model = TP.RotationSymmetricNet(n_hidden=8, device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    pts0 = torch.zeros((1, 2))
    pts1 = torch.full((4, 2), 0.3)
    monkeypatch.setattr(TT, "_draw_indices", lambda *a: (
        torch.zeros((1, 2), dtype=torch.int64),
        torch.arange(2, dtype=torch.int64)[None]))
    fitted, hist = TT.minibatch_fit(model, params, pts0, pts1, steps=1,
                                    n_sample=2, lr=1e-2)
    assert np.isfinite(hist.numpy()).all()
    for (k, a), (_, b) in zip(_leaves(fitted), _leaves(params)):
        assert torch.equal(a, b), k


def test_draw_indices_on_the_generator_device():
    gen = torch.Generator().manual_seed(0)
    i0, i1 = TT._draw_indices(gen, 7, 5, 3, 9)
    assert i0.shape == i1.shape == (7, 5)
    assert int(i0.max()) < 3 and int(i1.max()) < 9 and int(i0.min()) >= 0


# ------------------------------------------- protocols against JAX's


def _bridge_init(monkeypatch, port_cls, jax_model):
    """The port's ``port_cls`` starts from JAX's init of the same widths
    (``jax_model(port_model)``) and seed: ``model.init(make_generator(s))``
    takes ``PRNGKey(s)``'s params."""
    def init(self, generator=None):
        key = jax.random.PRNGKey(make_generator(generator).initial_seed())
        return params_from_jax(jax.device_get(jax_model(self).init(key)),
                               device=self.device)

    monkeypatch.setattr(port_cls, "init", init)


CONVEX_NEXT = (TI.ConvexNextNet, lambda m: JI.ConvexNextNet(
    n_hidden=m.n_hidden, in_features=m.in_features,
    n_hidden_layers=m.n_hidden_layers))


@pytest.mark.parametrize("name,scale", [("howto_convexity", 0.03),
                                        ("convex_depth", 0.02)])
def test_protocol_matches_jax(tree, name, scale, monkeypatch):
    """The JAX protocol and the port's from one init: the final loss and
    the masks (at most ``MASK_PIXELS`` apart at the threshold)."""
    want = JT.TEASERS[name](steps_scale=scale)
    _bridge_init(monkeypatch, *CONVEX_NEXT)
    got = TT.TEASERS[name](steps_scale=scale, device=CPU)
    np.testing.assert_allclose(got.extra["loss"], want.extra["loss"],
                               rtol=HIST_RTOL)
    np.testing.assert_array_equal(got.ref_mask, want.ref_mask)
    assert got.mask.shape == want.mask.shape == (12, 16)
    assert want.mask.any() and not want.mask.all()
    assert int((got.mask != want.mask).sum()) <= MASK_PIXELS
    assert abs(got.iou - want.iou) <= MASK_PIXELS / want.mask.sum()
    for k, v in want.extra.items():
        if k != "loss":
            assert got.extra[k] == v, k


# ------------------------------------------- every protocol on the port


@pytest.fixture(scope="module")
def port_runs(tree):
    return {name: fn(steps_scale=TINY, device=CPU,
                     **({"n_restarts": 2} if name in RESTARTS else {}))
            for name, fn in TT.TEASERS.items()}


@pytest.mark.parametrize("name", list(TT.TEASERS))
def test_protocol_runs_on_the_port(port_runs, name):
    r = port_runs[name]
    assert isinstance(r, TT.TeaserResult) and r.name == name
    assert np.isfinite(r.extra["loss"])
    assert r.mask.dtype == bool and r.mask.shape == r.ref_mask.shape
    assert r.mask.shape[-2:] in ((24, 32), (12, 16), (8, 12))
    assert 0.0 <= r.iou <= 1.0


# ------------------------------------------- the scripts, in process


def test_run_teasers_script(tree, tmp_path, monkeypatch):
    from awesome_tpu_torch.scripts import run_teasers

    out = str(tmp_path / "teasers")
    run_teasers.main(["--names", "convex_tomato", "temporal_connectedness",
                      "--steps-scale", str(TINY), "--out", out,
                      "--device", CPU])

    def boom(**kw):
        raise RuntimeError("synthetic failure")

    monkeypatch.setitem(TT.TEASERS, "star", boom)
    run_teasers.main(["--names", "star", "--steps-scale", str(TINY),
                      "--out", out, "--device", CPU])
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)
    assert sorted(res) == ["convex_tomato", "star", "temporal_connectedness"]
    assert "synthetic failure" in res["star"]["error"]
    assert len(res["temporal_connectedness"]["per_frame_iou"]) == 8
    for name in ("convex_tomato", "temporal_connectedness"):
        assert 0.0 <= res[name]["fill"] <= 1.0
        assert 0.0 < res[name]["ref_fill"] < 1.0
    for name in ("convex_tomato", "temporal_connectedness_0",
                 "temporal_connectedness_7"):
        for sfx in ("ours", "ref"):
            assert os.path.exists(os.path.join(out, f"{name}_{sfx}.png"))


def test_repeating_decomposition_script(tree, tmp_path):
    from awesome_tpu_torch.scripts import run_repeating_decomposition

    out = str(tmp_path / "decomp.json")
    run_repeating_decomposition.main(["--n-restarts", "2", "--steps-scale",
                                      "0.001", "--out", out,
                                      "--device", CPU])
    with open(out) as f:
        res = json.load(f)
    assert len(res["per_restart"]) == 2 and len(res["tails"]) == 2
    for key in ("ensemble_status_quo", "majority_vote",
                "phase_aligned_ensemble", "oracle_threshold",
                "ref_thr_64", "ref_thr_127", "ref_thr_192"):
        assert key in res, key


# ------------------------------------------- the examples, in process


def _example(name):
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_convexity(tree, tmp_path, capsys):
    _example("torch_howto_convexity").main(
        ["--epochs", "5", "--out", str(tmp_path), "--device", CPU])
    assert "loss" in capsys.readouterr().out
    assert (tmp_path / "convex_mask.png").exists()
    assert (tmp_path / "input_mask.png").exists()


def test_example_multi_object(capsys):
    _example("torch_howto_multi_object").main(["--steps", "5",
                                               "--device", CPU])
    assert "object 1 IoU" in capsys.readouterr().out


@pytest.mark.parametrize("synthetic", [False, True])
def test_example_path_connectedness(tree, tmp_path, capsys, synthetic):
    _example("torch_howto_path_connectedness").main(
        ["--epochs", "5", "--out", str(tmp_path), "--device", CPU]
        + (["--synthetic", "--size", "32"] if synthetic else []))
    out = capsys.readouterr().out
    assert "deformation inverse max err" in out
    assert ("fit IoU" if synthetic else "IoU vs reference shipped") in out
    assert (tmp_path / "mask.png").exists() and (tmp_path / "gt.png").exists()


def test_example_read_results(tmp_path, capsys):
    _example("torch_howto_read_results").main(
        ["--epochs", "5", "--out", str(tmp_path), "--device", CPU])
    out = capsys.readouterr().out
    assert "tracked metrics" in out and "comparison table" in out
    assert (tmp_path / "metric_curve.png").exists()
    assert (tmp_path / "metric_bar.png").exists()
