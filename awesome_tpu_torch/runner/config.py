"""Experiment configuration; counterpart of ``awesome_tpu/runner/config.py``.

Dataclass configs that (a) round-trip YAML/JSON with class tags, (b)
expose every field as an argparse flag, (c) diff against a parent.
Field names match the reference (`awesome/run/awesome_config.py:69-253`)
and the JAX package, so both packages' YAMLs load here: reference type
strings (``torch.optim.Adam``) map through :data:`TYPE_TRANSLATION`, the
JAX package's class paths through ``serialization.jsonconv.port_path``.

``device`` is a torch device string and defaults to ``"cuda"``; a
JAX-written ``"tpu"`` reads as ``"cuda"``, ``"cpu"`` stays ``"cpu"``.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import typing
from typing import Any, Dict, List, Optional, Union

from awesome_tpu_torch.serialization.jsonconv import (
    NoPortError,
    from_jsonable,
    port_path,
    read_yaml,
    save_yaml,
    to_jsonable,
)

NOCHANGE = object()

# device strings of the JAX package -> this package's
_DEVICES = {"tpu": "cuda", "gpu": "cuda"}


def translate_device(device: Optional[str]) -> Optional[str]:
    """A config's device string as a torch device: ``"tpu"`` -> ``"cuda"``;
    torch strings (``"cpu"``, ``"cuda"``, ``"cuda:1"``) unchanged."""
    if device is None:
        return None
    return _DEVICES.get(device, device)


@dataclasses.dataclass
class Config:
    """Base config: naming, run-folder layout, diffing.

    Spec: `awesome/run/config.py:12,47,66`.
    """

    name_experiment: Optional[str] = None
    timestamp: Optional[str] = None
    diff_config: Optional[Dict[str, Any]] = None

    def prepare(self) -> None:
        if self.timestamp is None:
            self.timestamp = datetime.datetime.now().strftime(
                "%Y-%m-%d_%H-%M-%S")

    @property
    def run_name(self) -> str:
        return f"{self.timestamp}_{self.name_experiment or 'run'}"

    def changes(self, parent: "Config") -> Dict[str, Any]:
        """Field-level diff vs a parent config (NOCHANGE elided)."""
        out = {}
        for f in dataclasses.fields(self):
            if f.name in ("timestamp", "diff_config"):
                continue
            a = getattr(self, f.name)
            b = getattr(parent, f.name)
            if to_jsonable(a) != to_jsonable(b):
                out[f.name] = a
        return out

    def save(self, path: str) -> None:
        save_yaml(self, path)

    @classmethod
    def load(cls, path: str, device: Optional[str] = None) -> "Config":
        """Load a YAML written by this package or the JAX package. Modules
        inside it (e.g. ``prior_model_args['base']``) are built on
        ``device``, else on the YAML's own ``device`` field, else on the
        card."""
        raw = read_yaml(path)
        if device is None and isinstance(raw, dict):
            device = translate_device(raw.get("device"))
        obj = from_jsonable(raw, device)
        if isinstance(obj, dict):
            names = {f.name for f in dataclasses.fields(cls)}
            obj.pop("__class__", None)
            return cls(**{k: v for k, v in obj.items() if k in names})
        return obj

    # --- argparse bridge (ArgparserMixin equivalent,
    # `awesome/mixin/argparser_mixin.py:50-275`) ------------------------
    @classmethod
    def get_parser(cls, parser: Optional[argparse.ArgumentParser] = None):
        parser = parser or argparse.ArgumentParser(description=cls.__name__)
        for f in dataclasses.fields(cls):
            arg = "--" + f.name.replace("_", "-")
            ftype = _unwrap_optional(f.type)
            if ftype is bool:
                parser.add_argument(arg, type=_str2bool, default=None)
            elif ftype in (int, float, str):
                parser.add_argument(arg, type=ftype, default=None)
            else:
                parser.add_argument(arg, type=_yaml_arg, default=None)
        return parser

    def apply_parsed_args(self, args: argparse.Namespace) -> None:
        for f in dataclasses.fields(self):
            val = getattr(args, f.name, None)
            if val is not None:
                setattr(self, f.name, val)


def _str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def _yaml_arg(v: str):
    import yaml

    return yaml.safe_load(v)


def _unwrap_optional(t):
    if isinstance(t, str):
        return {"bool": bool, "int": int, "float": float, "str": str}.get(
            t.replace("Optional[", "").replace("]", ""), None)
    origin = typing.get_origin(t)
    if origin is Union:
        args = [a for a in typing.get_args(t) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return t


# Reference dotted-type strings -> this package's equivalents. Lets
# reference YAML configs load unchanged (`run/awesome_runner.py:108`
# parse_type). Targets this package does not have yet keep the JAX
# package's path: importing one raises NoPortError, naming it.
TYPE_TRANSLATION = {
    "awesome.model.net_factory.real_nvp_path_connected_net":
        "awesome_tpu_torch.nn.path_connected.real_nvp_path_connected_net",
    "awesome.model.path_connected_net.PathConnectedNet":
        "awesome_tpu_torch.nn.path_connected.PathConnectedNet",
    "awesome.model.convex_net.ConvexNet":
        "awesome_tpu_torch.nn.icnn.ConvexNet",
    "awesome.model.convex_net.ConvexNextNet":
        "awesome_tpu_torch.nn.icnn.ConvexNextNet",
    "awesome.model.unet.UNet": "awesome_tpu_torch.nn.seg.UNet",
    "awesome.model.net.Net": "awesome_tpu_torch.nn.seg.Net",
    "awesome.model.fc_net.FCNet": "awesome_tpu_torch.nn.seg.FCNet",
    "awesome.model.cnn_net.CNNNet": "awesome_tpu_torch.nn.seg.CNNNet",
    "awesome.model.wrapper_module.WrapperModule":
        "awesome_tpu_torch.nn.wrapper.WrapperModule",
    "awesome.measures.awesome_loss.AwesomeLoss": "awesome_loss",
    "awesome.measures.awesome_image_loss.AwesomeImageLoss": "awesome_loss",
    "awesome.measures.awesome_image_loss_joint.AwesomeImageLossJoint":
        "awesome_loss_joint",
    "awesome.measures.awesome_loss_joint.AwesomeLossJoint":
        "awesome_loss_joint",
    "awesome.measures.weighted_loss.WeightedLoss": "weighted_loss",
    "awesome.measures.fbms_joint_loss.FBMSJointLoss": "fbms_joint_loss",
    "awesome.measures.unaries_weighted_loss.UnariesWeightedLoss":
        "unaries_weighted_loss",
    "torch.optim.Adam": "adam",
    "torch.optim.adam.Adam": "adam",
    "torch.optim.Adamax": "adamax",
    "torch.optim.adamax.Adamax": "adamax",
    "torch.nn.modules.loss.BCELoss": "bce",
    "awesome.measures.se.SE": "se",
    "awesome.measures.gradient_penalty_loss.GradientPenaltyLoss":
        "gradient_penalty",
    "awesome.dataset.sisbosi_dataset.SISBOSIDataset":
        "awesome_tpu_torch.data.sisbosi.SISBOSIDataset",
    "awesome.dataset.sisbosi_dataset.ConvexityDataset":
        "awesome_tpu_torch.data.convexity.ConvexityDataset",
    "awesome.dataset.fbms_sequence_dataset.FBMSSequenceDataset":
        "awesome_tpu.data.fbms.FBMSSequenceDataset",
    "awesome.measures.miou.MIOU": "miou",
    "awesome.dataset.convexity_segmentation_dataset."
    "ConvexitySegmentationDataset":
        "awesome_tpu_torch.data.convexity.ConvexityDataset",
    "awesome.dataset.awesome_dataset.AwesomeDataset":
        "awesome_tpu_torch.data.convexity.ConvexityDataset",
}


def translate_reference_value(v: Any) -> Any:
    """A reference type string as this package's; a JAX-package class
    path as its counterpart here (kept as it is when there is none yet,
    so that importing it names it)."""
    if not isinstance(v, str):
        return v
    v = TYPE_TRANSLATION.get(v, v)
    try:
        return port_path(v)
    except NoPortError:
        return v


@dataclasses.dataclass
class AwesomeConfig(Config):
    """The experiment config; field names mirror
    `awesome/run/awesome_config.py:69-253` (torch-only fields dropped or
    reinterpreted: ``device`` is a torch device string).
    """

    # dataset
    dataset_type: Optional[str] = None
    dataset_args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # combined module
    combined_segmentation_module_type: str = (
        "awesome_tpu_torch.nn.wrapper.WrapperModule")
    combined_segmentation_module_args: Dict[str, Any] = dataclasses.field(
        default_factory=dict)

    # segmentation model
    segmentation_model_type: Optional[str] = None
    segmentation_model_args: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    segmentation_training_mode: str = "single"  # 'multi'|'single'|'none'
    use_segmentation_output_inversion: bool = False
    # binary problems use ONE output channel + sigmoid instead of a
    # 2-channel softmax head (`awesome/run/awesome_runner.py:64`)
    use_binary_classification: bool = True
    # pass GT targets into the segmentation module's forward (Mask-RCNN
    # style training, `awesome/run/awesome_runner.py:151`)
    segmentation_model_gets_targets: bool = False

    # prior
    prior_model_type: Optional[str] = None
    prior_model_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    use_prior_model: bool = True

    # loss
    loss_type: str = "awesome_loss"
    loss_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    use_extra_penalty_hook: bool = False
    extra_penalty_after_n_epochs: int = 200
    use_reduce_lr_in_extra_penalty_hook: bool = False
    reduce_lr_in_extra_penalty_hook_factor: float = 0.05

    # optimizer / schedule
    optimizer_type: str = "adam"
    optimizer_args: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"lr": 1e-3})
    use_lr_on_plateau_scheduler: bool = False
    lr_on_plateau_scheduler_args: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    use_step_lr_scheduler: bool = False
    step_lr_scheduler_args: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    use_lr_stop_training_watchdog: bool = True
    lr_stop_training_watchdog_args: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    # weight-norm param-group split: decay ONLY the WN magnitude leaves by
    # this factor (`awesome/run/awesome_runner.py:427-444` ->
    # fit/optim.wn_param_groups)
    split_params_in_param_groups: bool = False
    weight_decay_on_weight_norm_modules: float = 5e-5

    # training
    num_epochs: int = 800
    scribble_percentage: float = 0.8
    validation_each_nth_epoch: int = 100
    seed: int = 42

    # pretraining (prior fit)
    do_pretraining: bool = True
    force_pretrain: bool = False  # refit even when a state file exists
    pretrain_only: bool = False  # stop after pretraining (agent_args)
    pretrain_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    pretrain_state_path: Optional[str] = None
    # warm-start the (shared) segmentation net from a saved tree
    # (`awesome/run/awesome_config.py` segmentation_model_state_dict_path)
    segmentation_model_state_dict_path: Optional[str] = None

    # eval / outputs
    compute_metrics_during_training_nth_epoch: Optional[int] = 100
    compute_crf_with_metrics: bool = False
    compute_crf_after_training: bool = False
    compute_crf_after_pretraining: bool = False
    save_images_after_pretraining: bool = False
    plot_indices_during_training: Optional[List[int]] = None
    plot_indices_during_training_nth_epoch: Optional[int] = 100
    # final-save handle (`awesome/run/awesome_runner.py:343-347`):
    # -1 = dump every image after training
    plot_final_indices: Optional[Any] = None
    include_unaries_when_saving: bool = False

    # semantic-soft-segmentation feature extraction (the 'feat'/'featxy'
    # xytypes): directories of the external SSS code and checkpoint
    # (`awesome/run/semantic_soft_segmentation_extractor.py`)
    semantic_soft_segmentation_code_dir: Optional[str] = None
    semantic_soft_segmentation_model_checkpoint_dir: Optional[str] = None
    tf_use_gpu: bool = False  # SSS shell-out accelerator flag (TF1-only)

    # Mask-RCNN finetuning: restrict the finetune loss to box+mask terms
    # (declared at `awesome/run/awesome_config.py`; not read by any shipped
    # experiment path, kept for YAML round-trip fidelity)
    mask_rcnn_finetune_box_mask_only: bool = False

    # host-UI / provenance bookkeeping (no effect on computation)
    use_progress_bar: bool = True
    run_script_path: Optional[str] = None
    used_runner_type: Optional[str] = None
    # residual agent_args after the importer lifts the schema-known
    # pretrain keys (reference nests them; see runner/reference_import.py)
    agent_args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # runtime
    device: str = "cuda"
    dtype: str = "float32"
    runs_path: str = "./runs"
    output_folder: Optional[str] = None
    # multi-device [data, grid] mesh shape; the runner raises for any value
    # but None until parallel/mesh.py is ported (ROADMAP Queue 1 item 8)
    mesh_shape: Optional[List[int]] = None
    # auto-resume: continue training from the newest full train-state
    # checkpoint in <output_folder>/checkpoints (the runner's nth-epoch
    # 'latest' saves) to num_epochs, bit-identical to an uninterrupted run
    resume: bool = False

    def prepare(self) -> None:
        super().prepare()
        for name in ("dataset_type", "segmentation_model_type",
                     "prior_model_type", "loss_type", "optimizer_type",
                     "combined_segmentation_module_type"):
            setattr(self, name, translate_reference_value(
                getattr(self, name)))
        self.device = translate_device(self.device)
