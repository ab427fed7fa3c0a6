"""Port parity: the rest of the data layer (SISBOSI and its subset views,
``AwesomeDataset``, ``PriorCache``, the GT-id mapping) and the single-image
fused fit, against the JAX package on the same numpy inputs.

The data modules are numpy in both packages, so their outputs must be
equal exactly. ``PriorCache`` carries a JAX cache's params through
``bridge.params_from_jax``; ``fit_prior_fused`` is held to JAX's at the
rules of ``tests/test_torch_fit.py`` (loss history rtol 2e-4, params rtol
2e-3, atol 2e-6)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awesome_tpu.core import grids as JG
from awesome_tpu.data import awesome_dataset as JAD
from awesome_tpu.data import convexity as JC
from awesome_tpu.data import mapping as JMAP
from awesome_tpu.data import sisbosi as JS
from awesome_tpu.data import subdivisible as JSUB
from awesome_tpu.fit import fused_fit as JFF
from awesome_tpu.fit import prior_fit as JF
from awesome_tpu.nn.icnn import ConvexNextNet as JConvexNextNet
from awesome_tpu.nn.path_connected import (
    real_nvp_path_connected_net as j_factory,
)
from awesome_tpu_torch.bridge import params_from_jax, params_to_numpy
from awesome_tpu_torch.core import tree as TT
from awesome_tpu_torch.data import awesome_dataset as TAD
from awesome_tpu_torch.data import convexity as TC
from awesome_tpu_torch.data import mapping as TMAP
from awesome_tpu_torch.data import sisbosi as TS
from awesome_tpu_torch.data import subdivisible as TSUB
from awesome_tpu_torch.fit import fused_fit as TFF
from awesome_tpu_torch.fit import prior_fit as TF
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.nn.path_connected import (
    real_nvp_path_connected_net as t_factory,
)

CPU = "cpu"
HIST_RTOL, P_RTOL, P_ATOL = 2e-4, 2e-3, 2e-6


def _sample(mod, h=24, w=32, seed=0, index=0):
    """One convexity sample (an ellipse, scribbles inside and at the
    border) as ``mod.ConvexitySample``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    fg = ((yy - h / 2) ** 2 / (0.1 * h * h)
          + (xx - w / 2) ** 2 / (0.1 * w * w)) <= 1.0
    image = np.clip(rng.uniform(0, 1, (h, w, 3)) * 0.3
                    + fg[..., None] * 0.6, 0, 1).astype(np.float32)
    fg_mask = np.zeros((h, w), bool)
    fg_mask[h // 2 - 1:h // 2 + 2, w // 2 - 3:w // 2 + 3] = True
    bg_mask = np.zeros((h, w), bool)
    bg_mask[:2] = True
    bg_mask[:, -2:] = True
    return mod.ConvexitySample(image=image,
                               gt=(1.0 - fg).astype(np.float32),
                               fg_mask=fg_mask, bg_mask=bg_mask, index=index)


def _assert_equal(a, b):
    """Equal exactly, field by field for dataclasses and dicts."""
    if dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(b):
            _assert_equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _assert_equal(a[k], b[k])
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# --- SISBOSI ----------------------------------------------------------------


def test_remove_semantic_information():
    labels = np.random.default_rng(3).choice([3, 7, 250], (6, 5))
    _assert_equal(TS.remove_semantic_information(labels),
                  JS.remove_semantic_information(labels))


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_augment_and_random_patch(seed):
    s = _sample(JC)
    scr = np.zeros(s.gt.shape, np.uint8)
    scr[s.bg_mask] = 1
    scr[s.fg_mask] = 2
    got = TS.augment(s.image, s.gt, scr, np.random.default_rng(seed))
    ref = JS.augment(s.image, s.gt, scr, np.random.default_rng(seed))
    _assert_equal(got, ref)
    got = TS.random_patch(*got, 16, np.random.default_rng(seed))
    ref = JS.random_patch(*ref, 16, np.random.default_rng(seed))
    _assert_equal(got, ref)
    assert got[1].shape == (16, 16)


@pytest.mark.parametrize("xy_mode", ["xy", "distance_scribble"])
def test_scribble_image(xy_mode):
    s = _sample(JC)
    scr = np.full(s.gt.shape, 2, np.uint8)
    scr[s.bg_mask] = 1
    scr[s.fg_mask] = 0
    got = TS.ScribbleImage(image=s.image, gt=s.gt, scribble=scr,
                           xy_mode=xy_mode)
    ref = JS.ScribbleImage(image=s.image, gt=s.gt, scribble=scr,
                           xy_mode=xy_mode)
    for dim in ("2d", "3d"):
        _assert_equal(got[dim], ref[dim])
    assert got.get_number_of_classes() == ref.get_number_of_classes() == 2
    assert got.get_xy_dimension() == ref.get_xy_dimension()
    with pytest.raises(ValueError):
        got["4d"]


def test_sisbosi_dataset():
    """Augmentation, patches and a subset: every draw of the same seed
    equal, sample by sample, in the order both datasets draw them."""
    kw = dict(augmentation=True, seed=4, patch_size=20, subset=[2, 0],
              scribble_percentage=0.5)
    got = TS.SISBOSIDataset([_sample(TC, seed=i, index=i)
                             for i in range(3)], **kw)
    ref = JS.SISBOSIDataset([_sample(JC, seed=i, index=i)
                             for i in range(3)], **kw)
    assert len(got) == len(ref) == 2
    assert got.get_data_index(0) == ref.get_data_index(0) == 2
    for i in (0, 1, 0):
        _assert_equal(got.load(i), ref.load(i))
        _assert_equal(got[i], ref[i])
        _assert_equal(got.scribble_image(i)["2d"],
                      ref.scribble_image(i)["2d"])
    plain = TS.SISBOSIDataset([_sample(TC)], augmentation=False)
    _assert_equal(plain.load(0), JS.SISBOSIDataset(
        [_sample(JC)], augmentation=False).load(0))


def test_subset_view_and_subdivisible_dataset():
    for spec in (None, 3, [4, 1, 2], slice(1, None, 2)):
        got, ref = TSUB.SubsetView(6, spec), JSUB.SubsetView(6, spec)
        assert len(got) == len(ref)
        assert got.has_subset == ref.has_subset
        assert got.data_indices() == ref.data_indices()
        for i in range(6):
            assert got.get_subset_index(i) == ref.get_subset_index(i)
        train, val = np.array([0, 1, 4]), np.array([2, 3, 5])
        _assert_equal(got.subset_split_indices(train, val),
                      ref.subset_split_indices(train, val))
    with pytest.raises(IndexError):
        TSUB.SubsetView(3, [5])
    data = [f"item{i}" for i in range(5)]
    got = TSUB.SubdivisibleDataset(data, [3, 1])
    ref = JSUB.SubdivisibleDataset(data, [3, 1])
    assert [got[i] for i in range(len(got))] == \
        [ref[i] for i in range(len(ref))] == ["item3", "item1"]
    assert got.get_subset_index(1) == ref.get_subset_index(1) == 1
    assert got.get_data_index(0) == 3


# --- AwesomeDataset ---------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(dimension="2d"),
    dict(dimension="2d", supervision_mode="full", scribble_percentage=0.4),
    dict(dimension="2d", feature_mode="edge", temporal=True),
    dict(dimension="2d", feature_mode="distance_scribble"),
    dict(dimension="3d"),
    dict(dimension="3d", supervision_mode="full"),
    dict(mode="sample"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_awesome_dataset(kw):
    got = TAD.AwesomeDataset([_sample(TC, seed=i, index=i)
                              for i in range(2)], **kw)
    ref = JAD.AwesomeDataset([_sample(JC, seed=i, index=i)
                              for i in range(2)], **kw)
    assert len(got) == len(ref) == 2
    for i in range(2):
        _assert_equal(got[i], ref[i])


def test_awesome_dataset_rejects_unknown_modes():
    with pytest.raises(ValueError):
        TAD.AwesomeDataset([], mode="nope")
    with pytest.raises(ValueError):
        TAD.AwesomeDataset([_sample(TC)], dimension="4d")[0]
    with pytest.raises(ValueError):
        TAD.AwesomeDataset([_sample(TC)], supervision_mode="nope")[0]


# --- PriorCache --------------------------------------------------------------


def test_prior_cache_matches_jax(tmp_path):
    """The port's cache holding a JAX cache's params: extract and apply
    equal JAX's, and a save/load round trip is bitwise."""
    jc = JAD.PriorCache(JConvexNextNet(n_hidden=8), 4,
                        key=jax.random.PRNGKey(3))
    tc = TAD.PriorCache(ConvexNextNet(n_hidden=8, device=CPU), 4, key=3)
    assert TT.tree_leaves(tc.get_state())[0].shape[0] == 4
    tc.set_state(params_from_jax(jax.device_get(jc.get_state()),
                                 device=CPU, stacked=1))

    def same(t_tree, j_tree, stacked=False):
        got = jax.tree_util.tree_leaves(params_to_numpy(t_tree,
                                                        stacked=stacked))
        ref = jax.tree_util.tree_leaves(jax.device_get(j_tree))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))

    same(tc.extract_prior(2), jc.extract_prior(2))
    new = jax.tree_util.tree_map(lambda a: a + 1.0, jc.extract_prior(0))
    jc.apply_prior(1, new)
    tc.apply_prior(1, params_from_jax(jax.device_get(new), device=CPU))
    same(tc.get_state(), jc.get_state(), stacked=True)
    same(tc.extract_prior(1), new)

    path = str(tmp_path / "cache")
    tc.save(path)
    loaded = TAD.PriorCache(ConvexNextNet(n_hidden=8, device=CPU), 4)
    loaded.load(path)
    same_leaf = TT.tree_map(
        lambda a, b: a.device == b.device and torch.equal(a, b),
        tc.get_state(), loaded.get_state())
    assert all(TT.tree_leaves(same_leaf))


# --- GT-id mapping -----------------------------------------------------------


def _mapping_inputs():
    rng = np.random.default_rng(7)
    gts, trajs = [], []
    for _ in range(2):
        gt = np.zeros((12, 16), np.int64)
        gt[2:6, 3:9] = 128
        gt[7:11, 9:15] = 255
        masks = (rng.uniform(size=(3, 12, 16)) > 0.6).astype(np.uint8)
        masks[0, 2:6, 3:9] = 1
        masks[1, 7:11, 9:15] = 1
        gts.append(gt)
        trajs.append((masks, np.array([4, 9, 2])))
    return gts, trajs


def test_match_ids_and_mapping_collection(tmp_path):
    gts, trajs = _mapping_inputs()
    got = TMAP.match_ids(gts, trajs, sequence="cars1")
    ref = JMAP.match_ids(gts, trajs, sequence="cars1")
    _assert_equal(got, ref)
    assert got.foreground_object_ids() == ref.foreground_object_ids()
    path = str(tmp_path / "maps" / "mapping.json")
    jcol = JMAP.MappingCollection(path)
    jcol.put(ref)
    jcol.save()
    tcol = TMAP.MappingCollection(path)  # reads the JAX-written file
    _assert_equal(tcol.get("cars1"), ref)
    assert tcol.get("none") is None
    tcol.put(dataclasses.replace(got, sequence="cars2"))
    tcol.save()
    with open(path) as f:
        text = f.read()
    assert set(JMAP.MappingCollection(path).mappings) == {"cars1", "cars2"}
    assert '"cars2"' in text


# --- the single-image fused fit ----------------------------------------------


def test_fit_prior_fused_matches_jax():
    """``fit_prior_fused`` against JAX's (its Pallas kernel in interpret
    mode) on an 8x8 grid, a narrow flagship model, 10 steps."""
    h = w = 8
    kw = dict(channels=2, hidden_units=8, flow_n_flows=2,
              flow_output_fn="tanh", spatial_shape=(h, w),
              convex_net_hidden_units=8, convex_net_hidden_layers=1)
    jm, tm = j_factory(**kw), t_factory(device=CPU, **kw)
    jp = jm.init(jax.random.PRNGKey(1))
    pts = np.asarray(JG.flatten_grid(JG.pixel_grid((h, w))))
    yy, xx = np.mgrid[0:h, 0:w]
    tgt = (1.0 - (((yy - 4) ** 2 + (xx - 3.5) ** 2) <= 6).astype(
        np.float32)).reshape(-1, 1)
    cfg = JF.FitConfig(num_steps=10, lr=1e-2)
    ref_p, ref_aux = JFF.fit_prior_fused(jm, jp, jnp.asarray(pts),
                                         jnp.asarray(tgt), cfg,
                                         interpret=True)
    got_p, aux = TFF.fit_prior_fused(
        tm, params_from_jax(jax.device_get(jp), device=CPU),
        torch.tensor(pts), torch.tensor(tgt),
        TF.FitConfig(num_steps=10, lr=1e-2))
    np.testing.assert_allclose(aux["loss_hist"].numpy(),
                               np.asarray(ref_aux["loss_hist"]),
                               rtol=HIST_RTOL)
    got = jax.tree_util.tree_leaves(params_to_numpy(got_p))
    ref = jax.tree_util.tree_leaves(jax.device_get(ref_p))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=P_RTOL,
                                   atol=P_ATOL)


# --- SISBOSI in a config -----------------------------------------------------


def test_sisbosi_in_a_config_runs_the_runner(tmp_path):
    """The reference's and the JAX package's SISBOSI paths resolve to the
    port's class; a runner built from in-memory samples through
    ``dataset_args`` trains one epoch on the CPU."""
    from awesome_tpu_torch.runner.config import AwesomeConfig
    from awesome_tpu_torch.runner.runner import AwesomeRunner
    from awesome_tpu_torch.serialization.jsonconv import dynamic_import

    for name in ("awesome.dataset.sisbosi_dataset.SISBOSIDataset",
                 "awesome_tpu.data.sisbosi.SISBOSIDataset"):
        cfg = AwesomeConfig(dataset_type=name, device=CPU)
        cfg.prepare()
        assert dynamic_import(cfg.dataset_type) is TS.SISBOSIDataset
    samples = [_sample(TC, seed=i, index=i) for i in range(2)]
    cfg = AwesomeConfig(
        name_experiment="sisbosi", device=CPU,
        dataset_type="awesome.dataset.sisbosi_dataset.SISBOSIDataset",
        dataset_args={"samples": samples, "augmentation": True, "seed": 0},
        segmentation_model_args={"n_hidden": 8},
        prior_model_args={"n_hidden": 8, "n_hidden_layers": 1},
        num_epochs=1, pretrain_args={"num_epochs": 2},
        runs_path=str(tmp_path), seed=0)
    runner = AwesomeRunner(cfg)
    runner.build()
    assert isinstance(runner.dataset, TS.SISBOSIDataset)
    ref = TS.SISBOSIDataset(samples, augmentation=True, seed=0)
    for got, want in zip(runner.samples, [ref.load(i) for i in range(2)]):
        _assert_equal(got, want)
    runner.pretrain()
    res = runner.train()
    assert np.isfinite(res["loss_hist"]).all()
    assert res["loss_hist"].shape[-1] == 1
    assert os.path.isdir(str(tmp_path))
