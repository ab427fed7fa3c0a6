"""Port parity: the convexity data of awesome_tpu_torch (``data/``) against
the JAX package's, bit for bit for the same seed: synthetic scenes (easy
and hard), scribble and random pixels, the padded batch, the train/val
split with its persisted indices file, PNG loading, and the per-image
feature maps."""
import numpy as np
import pytest

from awesome_tpu.data import batching as JB
from awesome_tpu.data import convexity as JC
from awesome_tpu.data import image_sample as JI
from awesome_tpu.data import split as JSP
from awesome_tpu.data import synthetic as JS
from awesome_tpu_torch.data import batching as TB
from awesome_tpu_torch.data import convexity as TC
from awesome_tpu_torch.data import image_sample as TI
from awesome_tpu_torch.data import split as TSP
from awesome_tpu_torch.data import synthetic as TS
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = ("image", "gt", "fg_mask", "bg_mask", "train_gt")


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hard, flip", [(0.0, 1.0), (0.7, 2.0)])
def test_synthetic_samples_equal(hard, flip):
    for seed in range(3):
        j = JS.make_sample(seed, h=30, w=26, hard=hard, flip_scale=flip)
        t = TS.make_sample(seed, h=30, w=26, hard=hard, flip_scale=flip)
        for f in FIELDS:
            _equal(getattr(t, f), getattr(j, f))
        assert t.index == j.index and t.shape == j.shape


def test_synthetic_dataset_equal():
    js = JS.synthetic_convexity_dataset(n=4, h=20, w=24, hard=0.5,
                                        hard_spread=True)
    ts = TS.synthetic_convexity_dataset(n=4, h=20, w=24, hard=0.5,
                                        hard_spread=True)
    for j, t in zip(js, ts):
        for f in FIELDS:
            _equal(getattr(t, f), getattr(j, f))


@pytest.mark.parametrize("percentage", [1.0, 0.8, 0.3])
def test_pixels_equal(percentage):
    j = JS.make_sample(4, h=32, w=40)
    t = TS.make_sample(4, h=32, w=40)
    for a, b in zip(t.important_pixels(), j.important_pixels()):
        _equal(a, b)
    for a, b in zip(t.pixels(percentage, seed=9),
                    j.pixels(percentage, seed=9)):
        _equal(a, b)
    _equal(t.random_pixels(50, seed=2), j.random_pixels(50, seed=2))


def test_stack_padded_equal():
    rng = np.random.default_rng(0)
    lists = [rng.random((n, 5)).astype(np.float32) for n in (7, 1500, 900)]
    for got, ref in zip(TB.stack_padded(lists), JB.stack_padded(lists)):
        _equal(got, ref)
    for got, ref in zip(TB.stack_padded(lists, granularity=64),
                        JB.stack_padded(lists, granularity=64)):
        _equal(got, ref)
    assert TB.bucket_size(1025) == JB.bucket_size(1025) == 2048
    with pytest.raises(ValueError):
        TB.pad_points(lists[1], 100)


def test_split_indices_equal(tmp_path):
    for n, ratio, seed in ((10, 0.8, 42), (51, 0.7, 3), (5, 1.0, 1)):
        assert TSP.split_indices(n, ratio, seed=seed) == \
            JSP.split_indices(n, ratio, seed=seed)
    path = str(tmp_path / "idx" / "split.json")
    first = TSP.split_indices(12, 0.5, seed=7, indices_file=path)
    # the persisted file wins over a new seed, in both packages
    assert TSP.split_indices(12, 0.5, seed=8, indices_file=path) == first
    assert JSP.split_indices(12, 0.5, seed=8, indices_file=path) == first


def test_dataset_loads_pngs_equal(tmp_path):
    from PIL import Image

    for sub in ("img", "ground_truth", "user_scribbles"):
        (tmp_path / sub).mkdir()
    for i in (0, 3):
        s = JS.make_sample(i, h=16, w=20)
        Image.fromarray((s.image * 255).astype(np.uint8)).save(
            tmp_path / "img" / f"img_{i}.png")
        Image.fromarray(np.where(s.gt == 0, 255, 0).astype(np.uint8)).save(
            tmp_path / "ground_truth" / f"GT_{i}.png")
        scr = np.zeros((16, 20), np.uint8)
        scr[s.bg_mask] = 128
        scr[s.fg_mask] = 255
        Image.fromarray(scr).save(
            tmp_path / "user_scribbles" / f"scribbleMask_{i}.png")
    jd = JC.ConvexityDataset(str(tmp_path), scribble_percentage=0.8)
    td = TC.ConvexityDataset(str(tmp_path), scribble_percentage=0.8)
    assert len(td) == len(jd) == 2
    for i in range(2):
        j, t = jd.load(i), td.load(i)
        for f in FIELDS:
            _equal(getattr(t, f), getattr(j, f))
        for a, b in zip(td[i], jd[i]):
            _equal(a, b)


def test_feature_maps_equal():
    s = JS.make_sample(2, h=18, w=22, hard=0.4)
    _equal(TI.edge_map(s.image), JI.edge_map(s.image))
    np.testing.assert_array_equal(TI.assemble_channels(s.image),
                                  np.asarray(JI.assemble_channels(s.image)))
    scribble = s.fg_mask.astype(np.int64) + 2 * s.bg_mask
    _equal(TI.assemble_channels(s.image, "distance_scribble", scribble),
           JI.assemble_channels(s.image, "distance_scribble", scribble))
