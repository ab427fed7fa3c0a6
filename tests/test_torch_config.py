"""Port parity: configs and serialization of awesome_tpu_torch
(``runner/config.py``, ``runner/reference_import.py``,
``serialization/jsonconv.py``) against the JAX package's: YAML round trips,
a config.yaml written by the JAX package loaded here with its class paths
mapped to this package (in a process where ``jax`` and ``awesome_tpu``
cannot be imported), the argparse bridge, and the reference type
translation."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from awesome_tpu.nn.icnn import ConvexNextNet as JConvexNextNet
from awesome_tpu.runner import config as JCfg
from awesome_tpu.runner import reference_import as JRef
from awesome_tpu_torch.nn.icnn import ConvexNextNet
from awesome_tpu_torch.ops.mlp import FullyFusedConvexNextNet
from awesome_tpu_torch.runner import config as TCfg
from awesome_tpu_torch.runner import reference_import as TRef
from awesome_tpu_torch.serialization import jsonconv as J
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_yaml_round_trip(tmp_path):
    cfg = TCfg.AwesomeConfig(
        name_experiment="rt", num_epochs=7, device="cpu",
        prior_model_type="awesome_tpu_torch.ops.mlp.FullyFusedConvexNextNet",
        prior_model_args={"base": ConvexNextNet(n_hidden=9, device="cpu")},
        dataset_args={"shapes": [[4, 6]], "t": (1, 2),
                      "a": np.arange(3, dtype=np.int16)},
        optimizer_args={"lr": 0.5})
    cfg.prepare()
    path = str(tmp_path / "c.yaml")
    cfg.save(path)
    loaded = TCfg.AwesomeConfig.load(path)
    for f in dataclasses.fields(cfg):
        if f.name not in ("prior_model_args", "dataset_args"):
            assert getattr(loaded, f.name) == getattr(cfg, f.name), f.name
    base = loaded.prior_model_args["base"]
    assert isinstance(base, ConvexNextNet)
    assert J.module_args(base) == J.module_args(
        cfg.prior_model_args["base"])
    assert base.device.type == "cpu"
    assert loaded.dataset_args["t"] == (1, 2)
    a = loaded.dataset_args["a"]
    assert a.dtype == np.int16 and a.tolist() == [0, 1, 2]
    wrapped = J.from_jsonable(J.to_jsonable(FullyFusedConvexNextNet(base)),
                              "cpu")
    assert isinstance(wrapped, FullyFusedConvexNextNet)
    assert wrapped.base.n_hidden == 9


def test_jax_written_config_loads_without_jax(tmp_path):
    """A config.yaml the JAX package wrote: its classes map to this
    package's and no module of ``awesome_tpu`` or ``jax`` is imported."""
    jcfg = JCfg.AwesomeConfig(
        name_experiment="jax", num_epochs=11,
        prior_model_type="awesome_tpu.ops.pallas_mlp.FullyFusedConvexNextNet",
        prior_model_args={"base": JConvexNextNet(n_hidden=13,
                                                 n_hidden_layers=1)},
        segmentation_model_type="awesome_tpu.nn.seg.Net",
        segmentation_model_args={"n_hidden": 16})
    jcfg.prepare()
    path = str(tmp_path / "config.yaml")
    jcfg.save(path)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'awesome_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from awesome_tpu_torch.runner.config import AwesomeConfig\n"
        "from awesome_tpu_torch.nn.icnn import ConvexNextNet\n"
        f"cfg = AwesomeConfig.load({path!r}, device='cpu')\n"
        "assert type(cfg) is AwesomeConfig, type(cfg)\n"
        "cfg.prepare()\n"
        "assert cfg.prior_model_type == "
        "'awesome_tpu_torch.ops.mlp.FullyFusedConvexNextNet', "
        "cfg.prior_model_type\n"
        "assert cfg.segmentation_model_type == "
        "'awesome_tpu_torch.nn.seg.Net'\n"
        "assert cfg.combined_segmentation_module_type == "
        "'awesome_tpu_torch.nn.wrapper.WrapperModule'\n"
        "base = cfg.prior_model_args['base']\n"
        "assert type(base) is ConvexNextNet and base.n_hidden == 13\n"
        "assert base.device.type == 'cpu' and cfg.device == 'cuda'\n"
        "assert cfg.num_epochs == 11\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'awesome_tpu.'))"
        "\n               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_argparse_bridge_matches_jax():
    argv = ["--num-epochs", "5", "--optimizer-args", "{lr: 0.5}",
            "--use-prior-model", "false", "--device", "cpu",
            "--dataset-args", "{n: 2, shapes: [[3, 4]]}"]
    got, ref = TCfg.AwesomeConfig(), JCfg.AwesomeConfig()
    got.apply_parsed_args(TCfg.AwesomeConfig.get_parser().parse_args(argv))
    ref.apply_parsed_args(JCfg.AwesomeConfig.get_parser().parse_args(argv))
    for f in dataclasses.fields(got):
        if f.name not in ("combined_segmentation_module_type",):
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert got.num_epochs == 5 and got.use_prior_model is False
    assert TCfg.AwesomeConfig().device == "cuda"


def test_config_diff():
    a = TCfg.AwesomeConfig(num_epochs=100)
    b = TCfg.AwesomeConfig(num_epochs=200, optimizer_args={"lr": 0.1})
    assert set(b.changes(a)) == {"num_epochs", "optimizer_args"}


def test_reference_type_translation():
    """Every reference type the JAX package translates, this package
    translates to the counterpart of the JAX target (or keeps the JAX path
    where there is none yet, which then raises on import, naming it)."""
    assert set(TCfg.TYPE_TRANSLATION) == set(JCfg.TYPE_TRANSLATION)
    for ref, jax_target in JCfg.TYPE_TRANSLATION.items():
        got = TCfg.translate_reference_value(ref)
        try:
            want = J.port_path(jax_target)
        except J.NoPortError:
            want = jax_target
            with pytest.raises(J.NoPortError, match=jax_target):
                J.dynamic_import(got)
        assert got == want, ref
    assert TCfg.translate_reference_value(7) == 7
    cfg = TCfg.AwesomeConfig(optimizer_type="torch.optim.Adamax",
                             prior_model_type="awesome.model.convex_net."
                             "ConvexNextNet", device="tpu")
    cfg.prepare()
    assert cfg.optimizer_type == "adamax"
    assert J.dynamic_import(cfg.prior_model_type) is ConvexNextNet
    assert cfg.device == "cuda"


def test_port_paths_never_import_the_jax_package():
    assert J.port_path("awesome_tpu.nn.icnn.ConvexNextNet") == \
        "awesome_tpu_torch.nn.icnn.ConvexNextNet"
    assert J.port_path("numpy.ndarray") == "numpy.ndarray"
    assert J.dynamic_import("awesome_tpu.nn.seg.Net").__module__ == \
        "awesome_tpu_torch.nn.seg"
    for path in ("awesome_tpu.nn.convex_diffeo.ConvexDiffeo",
                 "awesome_tpu.nn.icnn.NoSuchNet"):
        with pytest.raises(J.NoPortError, match=path):
            J.dynamic_import(path)
        with pytest.raises(J.NoPortError, match=path):
            J.from_jsonable({"__class__": path, "x": 1}, "cpu")
    # a foreign (reference) tag still degrades to a plain dict
    assert J.from_jsonable({"__class__": "awesome.x.Y", "a": 1}) == {
        "__class__": "awesome.x.Y", "a": 1}


_REFERENCE_YAML = """\
AwesomeConfig:
  __class__: awesome.run.awesome_config.AwesomeConfig
  name_experiment: ref
  device: cuda
  dtype: torch.float32
  num_epochs: 12
  optimizer_type: torch.optim.Adam
  optimizer_args: {lr: 0.02}
  segmentation_model_type: awesome.model.net.Net
  prior_model_type: awesome.model.convex_net.ConvexNextNet
  prior_model_args: {n_hidden: 130, _private: 3}
  dataset_type: "awesome.dataset.convexity_segmentation_dataset.\\
    ConvexitySegmentationDataset"
  agent_args: {do_pretraining: true, pretrain_args: {num_epochs: 5}, other: 1}
  unknown_field: 4
"""


def test_reference_import_matches_jax(tmp_path):
    path = tmp_path / "ref.yaml"
    path.write_text(_REFERENCE_YAML)
    got, got_extra = TRef.load_reference_config(str(path))
    ref, ref_extra = JRef.load_reference_config(str(path))
    assert got.device == "cuda" and ref.device == "tpu"
    assert got_extra == ref_extra == {"unknown_field": 4}
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if f.name in ("device", "timestamp"):
            continue
        if isinstance(b, str) and b.startswith("awesome_tpu."):
            b = J.port_path(b)
        assert a == b, f.name
    assert got.pretrain_args == {"num_epochs": 5}
    assert got.prior_model_args == {"n_hidden": 130}


def test_module_encoding_keeps_init_args():
    m = ConvexNextNet(n_hidden=7, in_features=3, n_hidden_layers=2,
                      device="cpu")
    enc = J.to_jsonable(m)
    assert enc == {"__class__": "awesome_tpu_torch.nn.icnn.ConvexNextNet",
                   "n_hidden": 7, "in_features": 3, "out_features": 1,
                   "n_hidden_layers": 2}
    back = J.from_jsonable(enc, torch.device("cpu"))
    assert J.to_jsonable(back) == enc
