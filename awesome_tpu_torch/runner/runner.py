"""Runner, the composition root of the convexity benchmark; counterpart of
``awesome_tpu/runner/runner.py``.

Behavior port of `awesome/run/runner.py:27-154` (seeding, config snapshot,
run-folder layout) and `awesome/run/awesome_runner.py:35-533` (build
dataset -> build models -> pretrain -> train -> eval). The reference's
event attachments are explicit phases here; per-image weight swapping is
the stacked-params engine of ``fit/pixel_trainer.py``.

Wired for the pixel pipeline (per-image wrapper models over (y, x, r, g,
b) pixel matrices; modes 'single', 'none' (seg frozen) and 'multi' (one
shared seg net)), the image pipeline (``dataset_args['dimension'] ==
'3d'``: CNNNet or UNet per image on the dense grid, every image padded to
one (Hmax, Wmax) bucket, the prior on the clean xy grid), and every
``xytype`` ('xy', 'feat', 'featxy', 'edge', 'edgexy'; the feature ones
through ``runner/sss_extractor.py``). Every tensor lives on
``config.device`` (the card unless the config says ``cpu``).

``mesh_shape`` runs the runner on a device mesh (``parallel/mesh.py``):
every rank runs every method (SPMD) and holds the whole state; the
pretrain's batched fit and each training segment split the images over
'data' and, where the loss is a sum over pixels, the pixels over 'grid'.
Only rank 0 writes checkpoints, the pretrain state, images and the run
folder.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import random
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.device import resolve_device
from awesome_tpu_torch.runner.config import AwesomeConfig
from awesome_tpu_torch.serialization.jsonconv import (
    dynamic_import,
    from_jsonable,
    init_names,
    save_yaml,
    takes_device,
    to_jsonable,
)

logger = logging.getLogger(__name__)


def _jax_order(tree, path=()):
    """``(path, leaf)`` in the order ``jax.tree_util`` flattens the same
    tree: dict keys sorted, lists and tuples in order, ``None`` empty."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _jax_order(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _jax_order(v, path + (i,))
        return out
    return [] if tree is None else [(path, tree)]


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` of the same tree."""

    def walk(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "None" if node is None else "*"

    return f"PyTreeDef({walk(tree)})"


def persist_run(out: str, config, tracker, params: Dict[str, Any],
                stacked: Dict[str, int]) -> str:
    """The on-disk run layout the analytics layer scans
    (`analytics/result_model.py`: config.yaml + tracker.json + params.npz
    + treedef.txt), file for file as the JAX package writes it: the leaves
    in ``jax.tree_util``'s flatten order and in the JAX package's layout
    (``bridge.params_to_numpy``; ``stacked`` counts the leading image axes
    of each top-level subtree)."""
    from awesome_tpu_torch.bridge import params_to_numpy

    os.makedirs(out, exist_ok=True)
    save_yaml(config, os.path.join(out, "config.yaml"))
    tracker.save(os.path.join(out, "tracker.json"))
    host = {k: params_to_numpy(v, stacked[k]) for k, v in params.items()}
    np.savez(os.path.join(out, "params.npz"),
             *[leaf for _, leaf in _jax_order(host)])
    with open(os.path.join(out, "treedef.txt"), "w") as f:
        f.write(treedef_str(host))
    return out


def seed_all(seed: int) -> None:
    """Seed python's, numpy's and torch's global RNGs (the runner itself
    draws from generators seeded by the config's seed)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _seeds(base: int, n: int) -> List[int]:
    """``n`` distinct int seeds derived from ``base``: the port's stand-in
    for ``jax.random.split(PRNGKey(base), n)``."""
    return [base * 1_000_003 + i for i in range(n)]


class Runner:
    """Base runner: seeding + run folder + config snapshot.

    Spec: `awesome/run/runner.py:27-99`.
    """

    def __init__(self, config: AwesomeConfig):
        self.config = config
        config.prepare()
        seed_all(config.seed)
        self.output_folder = config.output_folder or os.path.join(
            config.runs_path, config.run_name)
        self.mesh = None

    @property
    def is_root(self) -> bool:
        """Whether this process writes files: no mesh, or its rank 0."""
        return self.mesh is None or self.mesh.is_root

    def store_config(self) -> None:
        if self.is_root:
            save_yaml(self.config,
                      os.path.join(self.output_folder, "config.yaml"))

    def build(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def train(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class AwesomeRunner(Runner):
    """End-to-end pixel-pipeline runner.

    Wires the reference composition root's event attachments
    (`awesome/run/awesome_runner.py:294-475`) as explicit cadence handles
    around a SEGMENTED training loop: eval-metric cadence
    (``compute_metrics_during_training_nth_epoch``), validation cadence +
    best-model checkpointing (``validation_each_nth_epoch``), periodic
    image dumps (``plot_indices_during_training*``), nth-epoch checkpoint
    saves (`awesome_runner.py:404-416`), pretrain orchestration with state
    load/save (``do_pretraining`` / ``pretrain_state_path``,
    `agent/torch_agent.py:553-607`) and the LR watchdog early stop.
    """

    CHECKPOINT_NTH_EPOCH = 20  # `awesome_runner.py:409` get_only_nth_epoch(20)

    def __init__(self, config: AwesomeConfig):
        super().__init__(config)
        self.device = resolve_device(config.device)
        self.dataset = None
        self.wrapper = None
        self.stacked_params = None
        self.tracker = None
        self.best_params = None
        self.train_indices = None
        self.val_indices = None
        self.handles: Dict[str, List[Callable]] = {
            "epoch_processed": [],
            "training_finished": [],
        }
        self._batch = None
        self._dev_batch = None
        self._eval_px = None
        self._feat_cache: Dict[Any, np.ndarray] = {}
        self._extractor = None
        self.image_mode = False
        self.seg_stateful = False

    # --- build -----------------------------------------------------------
    @staticmethod
    def _dataset_paths_exist(args: Dict[str, Any]) -> bool:
        """True iff every *_dir / *_path string in (nested) dataset args
        points at an existing location. Missing data falls back to the
        synthetic replica instead of crashing."""
        found = [True]

        def walk(node):
            if isinstance(node, dict):
                for k, v in node.items():
                    if isinstance(v, str) and (
                            k.endswith("_dir") or k.endswith("_path")
                            or k == "dataset_path"):
                        found.append(os.path.exists(v))
                    else:
                        walk(v)
            elif isinstance(node, list):
                for v in node:
                    walk(v)

        walk(args)
        return all(found)

    def _synthetic_fallback(self, args: Dict[str, Any]):
        from awesome_tpu_torch.data.synthetic import (
            make_sample,
            synthetic_convexity_dataset,
        )

        inner = args.get("dataset") or {}
        shapes = args.get("shapes")
        if shapes:
            # heterogeneous replica: one sample per requested (h, w), as the
            # real convexity-51 images vary in size
            return [make_sample(i, h=int(h), w=int(w))
                    for i, (h, w) in enumerate(shapes)]
        n = args.get("n") or inner.get("dataset_len") or 8
        return synthetic_convexity_dataset(
            n=int(min(n, 16)),
            h=args.get("h", 64),
            w=args.get("w", 64),
            hard=float(args.get("hard", 0.0)),
            hard_spread=bool(args.get("hard_spread", False)),
            flip_scale=float(args.get("flip_scale", 1.0)),
        )

    def build_dataset(self):
        cfg = self.config
        args = dict(cfg.dataset_args)
        self.image_mode = args.get("dimension") == "3d"
        if cfg.dataset_type is None:
            self.samples = self._synthetic_fallback(args)
        elif not self._dataset_paths_exist(args):
            logger.warning(
                "dataset paths in %s missing on this host; using the "
                "synthetic convexity replica", cfg.dataset_type)
            self.samples = self._synthetic_fallback(args)
        else:
            ds_cls = dynamic_import(cfg.dataset_type)
            known = {"dataset_path", "scribble_percentage", "subset", "seed",
                     "samples", "augmentation"}
            ds_args = {k: v for k, v in args.items() if k in known}
            inner = args.get("dataset")
            if isinstance(inner, dict) and "img_dir" in inner:
                # reference nests the directory dataset inside the wrapper
                ds_args.setdefault("dataset_path",
                                   os.path.dirname(inner["img_dir"]))
            self.dataset = ds_cls(**ds_args)
            self.samples = [self.dataset.load(i)
                            for i in range(len(self.dataset))]
        return self.samples

    def _seg_args(self, seg_cls, args: Dict[str, Any]) -> Dict[str, Any]:
        """Map reference seg-model args onto the port's models: 'input' ->
        in_type with the channel count derived from the dataset's xytype
        encoding (`awesome/model/cnn_net.py:18-28`: rgb|xy|rgbxy concat of
        rgb(3) + the encoding channels). The UNet, which always sees
        concat(image, encoding), gets ``in_chn`` 3 + the encoding's."""
        out = dict(args)
        in_type = out.pop("input", None)
        if in_type is not None:
            out["in_type"] = in_type
        enc = self.XYTYPE_CHANNELS.get(self.xytype, 2)
        name = getattr(seg_cls, "__name__", "")
        if name in ("CNNNet", "FCNet") and "in_chn" not in out:
            out.setdefault("in_chn", {"rgb": 3, "xy": enc, "rgbxy": 3 + enc
                                      }.get(out.get("in_type", "rgbxy"),
                                            3 + enc))
            # use_binary_classification (`awesome/run/awesome_runner.py:64`):
            # binary -> ONE sigmoid channel, else one channel per class
            out.setdefault("out_chn",
                           1 if self.config.use_binary_classification else 2)
        if name == "UNet":
            out.setdefault("in_chn", 3 + enc)
        if name == "Net":
            out.setdefault("in_features", 3 + enc)
        valid = set(init_names(seg_cls))
        return {k: v for k, v in out.items() if k in valid}

    def _construct(self, cls, args: Dict[str, Any]):
        """``cls(**args)`` with every module in ``args`` (an object, or its
        ``__class__``-tagged dict from a YAML or a flag) built anew on the
        runner's device, and ``device=`` passed where ``cls`` takes it."""
        args = from_jsonable(to_jsonable(dict(args)), self.device)
        if takes_device(cls):
            args["device"] = self.device
        return cls(**args)

    def build_models(self):
        from awesome_tpu_torch.nn.adapters import PixelMatrixSeg
        from awesome_tpu_torch.nn.icnn import ConvexNextNet
        from awesome_tpu_torch.nn.seg import Net
        from awesome_tpu_torch.nn.wrapper import WrapperModule

        cfg = self.config
        if self.image_mode and cfg.segmentation_training_mode == "multi":
            raise ValueError(
                "segmentation_training_mode 'multi' (one shared seg net) runs "
                "the pixel pipeline only; image mode trains a seg net per "
                "image ('single' or 'none')")
        if cfg.segmentation_model_type:
            seg_cls = dynamic_import(cfg.segmentation_model_type)
            seg = self._construct(
                seg_cls, self._seg_args(seg_cls, cfg.segmentation_model_args))
            if not self.image_mode and seg_cls.__name__ == "FCNet":
                # FCNet in the 2d pipeline: adapt the (image, grid)
                # signature to pixel matrices (reference pixelize flow)
                seg = PixelMatrixSeg(seg)
            elif not self.image_mode and seg_cls.__name__ in ("CNNNet",
                                                              "UNet"):
                raise ValueError(
                    f"{seg_cls.__name__} is convolutional; use dimension "
                    "'3d' (image mode) in dataset_args")
            # the UNet's batch norm: its per-image params are a (params,
            # state) pair, the state updated by the training forward
            self.seg_stateful = self.image_mode and (
                seg_cls.__name__ == "UNet")
        else:
            seg = self._construct(
                Net, self._seg_args(Net, cfg.segmentation_model_args or {}))

        prior = None
        if cfg.use_prior_model:
            target = dynamic_import(cfg.prior_model_type) \
                if cfg.prior_model_type else ConvexNextNet
            prior = self._construct(target, cfg.prior_model_args or {})

        # combined_segmentation_module_type is config-selected
        # (`awesome/run/awesome_runner.py:176-238` parse_type)
        wrapper_cls = dynamic_import(cfg.combined_segmentation_module_type) \
            if cfg.combined_segmentation_module_type else WrapperModule
        self.wrapper = wrapper_cls(
            segmentation_module=seg,
            prior_module=prior,
            input_mode="image" if self.image_mode else "pixel",
            prior_arg_mode=("param_clean_grid" if self.image_mode
                            else "xy_c_preattached"),
            use_segmentation_output_inversion=(
                cfg.use_segmentation_output_inversion),
            segmentation_module_gets_targets=(
                cfg.segmentation_model_gets_targets),
            **cfg.combined_segmentation_module_args,
        )
        return self.wrapper

    def build(self) -> None:
        from awesome_tpu_torch.data.split import split_indices
        from awesome_tpu_torch.parallel.mesh import mesh_from_config

        # config-selected device mesh ('data' x 'grid'; None = one device)
        self.mesh = mesh_from_config(self.config, self.device)
        self.build_dataset()
        shapes = [s.shape for s in self.samples]
        if self.image_mode:
            # pad-to-bucket: mixed sizes share one (Hmax, Wmax) dense grid;
            # padded pixels carry weight 0 everywhere (the reference is
            # shape-agnostic per image,
            # `awesome/dataset/convexity_segmentation_dataset.py:178-246`)
            self._shape = (max(h for h, _ in shapes),
                           max(w for _, w in shapes))
        else:
            self._shape = shapes[0]
        self.build_models()

        if self.image_mode:
            self._batch = self._image_batch()
        else:
            self._batch = self._pixel_batch()
        self._dev_batch = {k: torch.as_tensor(v, device=self.device)
                           for k, v in self._batch.items()}

        # stacked per-image wrapper params ('single' training mode: the
        # whole wrapper is the per-image prior, PriorMode.FULL). 'multi'
        # shares ONE seg net (stacked priors only); its state is built in
        # train(). 'none' trains priors only (seg frozen).
        if self.config.segmentation_training_mode == "multi":
            self.stacked_params = None
        else:
            gen = torch.Generator().manual_seed(self.config.seed)
            self.stacked_params = T.stack_trees(
                [self.wrapper.init(gen) for _ in self.samples])

        # train/val split over images (`awesome/dataset/separable_dataset.py`,
        # incl. the persisted-indices file so reruns see the same split)
        split_ratio = float(self.config.dataset_args.get("split_ratio", 1.0))
        self.train_indices, self.val_indices = split_indices(
            len(self.samples), split_ratio, seed=self.config.seed,
            indices_file=self.config.dataset_args.get("indices_file"))

        # warm-start the segmentation net from a saved state when given
        # (`torch_agent.py` segmentation_model_state_dict_path load)
        sd_path = self.config.segmentation_model_state_dict_path
        if sd_path:
            from awesome_tpu_torch.fit.checkpoint import (
                load_pytree,
                pytree_exists,
            )

            if pytree_exists(sd_path) and self.stacked_params is not None:
                seg_stack = self.stacked_params["seg"]
                loaded = load_pytree(sd_path,
                                     template=T.tree_select(seg_stack, 0))
                self.stacked_params = dict(self.stacked_params, seg=T.tree_map(
                    lambda l, s: l.to(s.dtype).expand_as(s).clone(),
                    loaded, seg_stack))
            elif not pytree_exists(sd_path):
                logger.warning("segmentation_model_state_dict_path %s "
                               "missing; keeping fresh init", sd_path)

        from awesome_tpu_torch.fit.tracker import Tracker

        self.tracker = Tracker(
            primary_metric="Loss",
            primary_mode="val" if self.val_indices else "train")

    def _pixel_batch(self) -> Dict[str, np.ndarray]:
        """Per-image pixel tensors (encoded), bucket-padded."""
        from awesome_tpu_torch.data.batching import stack_padded

        px_list, gt_list, scr_counts = [], [], []
        for s in self.samples:
            px, gt = s.pixels(self.config.scribble_percentage,
                              seed=self.config.seed)
            px = self._encode_px(s, px)
            gt_full = np.zeros((px.shape[0], 1), np.float32)
            gt_full[: gt.shape[0]] = gt
            px_list.append(px)
            gt_list.append(gt_full)
            scr_counts.append(s.important_pixels()[0].shape[0])
        px, valid = stack_padded(px_list)
        gt, _ = stack_padded(gt_list)
        scr_mask = np.zeros_like(valid)
        rnd_mask = np.zeros_like(valid)
        for i, c in enumerate(scr_counts):
            scr_mask[i, :c] = True
            rnd_mask[i] = valid[i] & ~scr_mask[i]
        return {"px": px, "gt": gt, "scr_mask": scr_mask,
                "rnd_mask": rnd_mask, "valid": valid}

    def _image_batch(self) -> Dict[str, np.ndarray]:
        """Dense full-grid tensors in the padded-grid layout: the conv seg
        net sees whole images; the loss is masked to scribbles, the extra
        penalty to the unlabeled rest (AwesomeImageLoss semantics,
        `awesome/measures/awesome_image_loss.py:9-52`), and padding to
        neither. gt encodes fg as 0; unlabeled and padded pixels read 1."""
        px = self._eval_pixels()  # (B, N=Hp*Wp, C)
        b, n = px.shape[:2]
        hp, wp = self._shape
        gt = np.ones((b, n, 1), np.float32)
        scr_mask = np.zeros((b, n), bool)
        valid = np.zeros((b, n), bool)
        for i, s in enumerate(self.samples):
            h, w = s.shape
            v = np.zeros((hp, wp), bool)
            v[:h, :w] = True
            fg = np.zeros((hp, wp), bool)
            fg[:h, :w] = s.fg_mask
            bg = np.zeros((hp, wp), bool)
            bg[:h, :w] = s.bg_mask
            fg, bg, v = fg.reshape(-1), bg.reshape(-1), v.reshape(-1)
            gt[i, fg, 0] = 0.0  # fg encoded as 0
            gt[i, bg, 0] = 1.0
            scr_mask[i] = fg | bg
            valid[i] = v
        return {"px": px, "gt": gt, "scr_mask": scr_mask,
                "rnd_mask": valid & ~scr_mask, "valid": valid}

    # --- xytype feature encodings -------------------------------------------
    XYTYPE_CHANNELS = {"xy": 2, "feat": 2, "featxy": 4, "edge": 1,
                       "edgexy": 3}

    @property
    def xytype(self) -> str:
        return self.config.dataset_args.get("xytype", "xy")

    def _encoding_map(self, s) -> Optional[np.ndarray]:
        """Per-image (H, W, E) encoding replacing/extending the xy channels
        per the dataset's ``xytype`` (`awesome/dataset/image_sample.py:111-127`
        _get_xy): 'feat' = 2-ch semantic features, 'featxy' = (xy, feat),
        'edge' = Sobel edge map, 'edgexy' = (xy, edge); None for plain
        'xy'. The features come from ``feature_dir`` embedmaps when there
        are some, else from the SSS proxy (``dataset_args['sss_proxy']``,
        default the host spectral-matting proxy; 'spectral_device' solves
        on the runner's device), cached per image."""
        from awesome_tpu_torch.data.image_sample import (
            edge_map,
            load_semantic_features,
        )

        xytype = self.xytype
        if xytype == "xy":
            return None
        h, w = s.shape
        yy, xx = np.mgrid[0:h, 0:w]
        xy = np.stack([yy / h - 0.5, xx / w - 0.5], -1).astype(np.float32)
        if xytype in ("feat", "featxy"):
            feat = None
            feature_dir = self.config.dataset_args.get("feature_dir")
            if feature_dir and os.path.isdir(feature_dir):
                feat = load_semantic_features(
                    feature_dir, f"img_{getattr(s, 'index', 0)}")
            if feat is None:
                key = getattr(s, "index", None)
                if key is not None and key in self._feat_cache:
                    feat = self._feat_cache[key]
                else:
                    feat = self._proxy_features(s.image, feature_dir)
                    if key is not None:
                        self._feat_cache[key] = feat
            return feat if xytype == "feat" else np.concatenate(
                [xy, feat], -1)
        if xytype in ("edge", "edgexy"):
            e = edge_map(s.image)[..., None].astype(np.float32)
            return e if xytype == "edge" else np.concatenate([xy, e], -1)
        raise ValueError(f"Unknown xytype {xytype}")

    def _proxy_features(self, image, feature_dir) -> np.ndarray:
        """The SSS proxy's features of one image, by one extractor per
        runner (its ``fallbacks`` count the images too small for the
        device solve)."""
        from awesome_tpu_torch.runner.sss_extractor import (
            SemanticSoftSegmentationExtractor,
        )

        proxy = self.config.dataset_args.get("sss_proxy", "spectral")
        if self._extractor is None:
            self._extractor = SemanticSoftSegmentationExtractor(
                feature_dir or "/nonexistent", proxy=proxy,
                device=self.device)
        ex = self._extractor
        if proxy == "spectral_device":
            # a failure of the device solve is the run's failure
            return ex.proxy_features(image)
        # the host proxies degrade internally (host spectral -> pyramid
        # PCA); this guard covers the pyramid path itself dying
        try:
            return ex.proxy_features(image)
        except Exception as e:  # noqa: BLE001
            from awesome_tpu_torch.data.image_sample import semantic_features

            logger.warning("every sss proxy failed (%r); 'feat' falls back "
                           "to RGB-PCA for this image", e)
            return semantic_features(image)

    def _encode_px(self, s, px: np.ndarray) -> np.ndarray:
        """Rewrite a (N, 5)=(y, x, r, g, b) pixel matrix to (N, E+3) with
        the xytype encoding channels in front (the prior reads [0:2])."""
        enc = self._encoding_map(s)
        if enc is None:
            return px
        h, w = s.shape
        iy = np.clip(np.round((px[:, 0] + 0.5) * h), 0, h - 1).astype(int)
        ix = np.clip(np.round((px[:, 1] + 0.5) * w), 0, w - 1).astype(int)
        return np.concatenate([enc[iy, ix], px[:, 2:5]],
                              axis=-1).astype(np.float32)

    def _stacked_axes(self) -> Dict[str, int]:
        """Leading image axes of each top-level subtree of the params."""
        shared = self.config.segmentation_training_mode == "multi"
        return {"seg": 0 if shared else 1, "prior": 1}

    # --- forward dispatch ---------------------------------------------------
    def _forward_one(self, params, px, evaluate_prior: bool = True):
        """Per-image forward on a pixel matrix (N, 5)=(y,x,r,g,b) -> (N, C).

        Pixel mode delegates to the wrapper; image mode reshapes to NHWC
        for the seg net and queries the prior on the clean xy grid
        (`awesome/model/wrapper_module.py:157-228`,
        ``prior_arg_mode='param_clean_grid'``). A UNet runs on its
        running batch-norm stats here (eval)."""
        if not self.image_mode:
            return self.wrapper.apply(params, px,
                                      evaluate_prior=evaluate_prior)
        seg_params, seg_state = params["seg"] if self.seg_stateful \
            else (params["seg"], None)
        return self._image_forward(seg_params, seg_state, params.get("prior"),
                                   px, evaluate_prior)[0]

    def _image_forward(self, seg_params, seg_state, prior_params, px,
                       evaluate_prior: bool = True, train: bool = False):
        """Image-mode forward: ``(out (N, C), new seg state)``; the state
        is None for a stateless seg net and moves only with ``train``."""
        h, w = self._shape
        img = px[:, -3:].reshape(1, h, w, 3)
        grid_img = px[:, :-3].reshape(1, h, w, -1)
        seg_mod = self.wrapper.segmentation_module
        if self.seg_stateful:
            seg, new_state = seg_mod.apply(seg_params, seg_state, img,
                                           grid_img, train=train)
        else:
            seg, new_state = seg_mod.apply(seg_params, img, grid_img), None
        seg = self.wrapper.process_segmentation_output(seg).reshape(-1, 1)
        if self.wrapper.prior_module is None or not evaluate_prior:
            return seg, new_state
        prior = self.wrapper.prior_module.apply(prior_params, px[:, 0:2])
        prior = self.wrapper.process_prior_output(prior).reshape(-1, 1)
        return torch.cat([seg, prior], dim=-1), new_state

    def _gp_weights(self):
        """Gradient-penalty weights from the configured loss criterion
        (`awesome/measures/gradient_penalty_loss.py:11`); zeros when the
        config doesn't use GradientPenaltyLoss."""
        crit = self.config.loss_args.get("criterion")
        if isinstance(crit, dict) and crit.get("__class__") == (
                "gradient_penalty"):
            return (float(crit.get("xygrad", 0.0) or 0.0),
                    float(crit.get("rgbgrad", 0.0) or 0.0))
        return 0.0, 0.0

    def _make_loss_impl(self):
        """Custom per-image loss when image mode or a gradient penalty is
        configured; None -> the pixel engine's default masked AwesomeLoss.
        With a stateful seg net (the UNet) the loss is ``loss(params,
        seg_state, px, ...) -> (loss, new_seg_state)``, the forward in
        training mode (batch statistics)."""
        from awesome_tpu_torch.fit.pixel_trainer import masked_awesome_loss
        from awesome_tpu_torch.measures.losses import bce

        xyw, rgbw = self._gp_weights()
        if not self.image_mode and not (xyw or rgbw):
            return None
        alpha = self.config.loss_args.get("alpha", 1.0)
        pen_base, pen_align = self._penalty_scales()
        has_prior = self.wrapper.prior_module is not None
        train_seg = self.config.segmentation_training_mode != "none"

        def forward(params, seg_state, px, evaluate_prior=True):
            if self.seg_stateful:
                return self._image_forward(params["seg"], seg_state,
                                           params.get("prior"), px,
                                           evaluate_prior, train=train_seg)
            return self._forward_one(params, px, evaluate_prior), None

        def loss_and_state(params, seg_state, px, gt, smask, rmask,
                           extra_penalty):
            out, new_state = forward(params, seg_state, px)
            if has_prior:
                loss = masked_awesome_loss(
                    out, gt, smask, rmask, alpha, extra_penalty,
                    pen_base_scale=pen_base, pen_align_scale=pen_align)
            else:
                sw = smask.to(out.dtype)[:, None]
                raw = bce(out[:, 0:1], gt, reduction="none")
                loss = (raw * sw).sum() / torch.clamp_min(sw.sum(), 1.0)
            if xyw or rgbw:
                # d(seg)/d(input-channel-groups); px layout (y,x,r,g,b);
                # the seg column alone (the prior does not reach it)
                g = torch.func.grad(lambda p: forward(
                    params, seg_state, p, evaluate_prior=False
                )[0][:, 0:1].sum())(px)
                if xyw:
                    loss = loss + xyw * torch.mean(g[:, 0:2] ** 2)
                if rgbw:
                    loss = loss + rgbw * torch.mean(g[:, 2:5] ** 2)
            return loss, new_state

        if self.seg_stateful:
            return loss_and_state

        def loss_impl(params, px, gt, smask, rmask, extra_penalty):
            return loss_and_state(params, None, px, gt, smask, rmask,
                                  extra_penalty)[0]

        return loss_impl

    # --- pretrain ----------------------------------------------------------
    def pretrain(self) -> Optional[Dict[str, Any]]:
        """Pretrain orchestration: load a pretrain state when
        ``pretrain_state_path`` exists, else run the batched prior fit and
        save the state. Spec: `awesome/agent/torch_agent.py:553-607`.
        """
        from awesome_tpu_torch.fit.checkpoint import (
            load_prior_cache,
            pytree_exists,
            save_prior_cache,
        )
        from awesome_tpu_torch.fit.prior_fit import (
            FitConfig,
            apply_prefits,
            fit_priors_batched,
            fit_priors_sequential,
            make_gate_retry_fn,
        )

        cfg = self.config
        if not cfg.do_pretraining or self.wrapper.prior_module is None:
            return None
        if self.stacked_params is None:
            # 'multi' mode builds its state lazily; create it now so the
            # pretrain fits seed the shared-seg training
            from awesome_tpu_torch.fit.pixel_trainer import (
                shared_pixel_train_init,
            )

            self.stacked_params = shared_pixel_train_init(
                self.wrapper, cfg.seed, len(self.samples),
                self._train_cfg(1)).params

        state_path = cfg.pretrain_state_path or os.path.join(
            self.output_folder, "pretrain_state")
        # force_pretrain: refit even when a state exists
        # (`agent/torch_agent.py:594` force_pretrain gate)
        found = not cfg.force_pretrain and pytree_exists(state_path)
        if self.mesh is not None:
            # every rank has looked before rank 0 may write the state
            self.mesh.barrier()
        if found:
            prior_stack = load_prior_cache(
                state_path, template=self.stacked_params["prior"])
            self.stacked_params = dict(self.stacked_params, prior=prior_stack)
            logger.info("Pretrain state loaded from %s", state_path)
            return {"loaded": True, "path": state_path}

        b = self._dev_batch
        px = b["px"]
        # unaries = current (untrained) segmentation output, thresholded:
        # `path_connected_net.py:832-855` (skip single-valued images)
        with torch.no_grad():
            if cfg.segmentation_training_mode == "multi":
                shared_seg = self.stacked_params["seg"]  # no image axis
                seg = torch.func.vmap(lambda x: self._forward_one(
                    {"seg": shared_seg}, x, evaluate_prior=False))(px)
            else:
                seg = torch.func.vmap(lambda p, x: self._forward_one(
                    p, x, evaluate_prior=False))(self.stacked_params, px)
        unaries_t = (seg >= 0.5).to(torch.float32)
        unaries = unaries_t.cpu().numpy()
        pmask = self._batch["valid"]  # (B, N): padded points excluded
        valid = np.array([len(np.unique(u[m])) > 1
                          for u, m in zip(unaries[..., 0], pmask)],
                         dtype=bool)
        if self.val_indices:
            # the reference pretrains on the train split only
            # (`path_connected_net.py:810` iterates DataLoader(train_set))
            valid[list(self.val_indices)] = False
        pargs = dict(cfg.pretrain_args)
        fit_cfg = FitConfig(
            num_steps=int(pargs.get("num_epochs", 2000)),
            lr=float(pargs.get("lr", 1e-3)),
            flow_weight_decay=float(pargs.get("flow_weight_decay", 1e-5)),
            gate_threshold=0.5,
            gate_retries=int(pargs.get("proper_prior_fit_retrys", 1)),
        )
        points = px[..., 0:2]
        prior_model = self.wrapper.prior_module
        valid_t = torch.as_tensor(valid, device=self.device)
        pmask_t = b["valid"]
        n_img = len(self.samples)
        if bool(pargs.get("reuse_state", False)):
            # the sequential (reuse_state) pretrain of
            # `path_connected_net.py:869-894`: optional flow-identity /
            # convex prefits warm-start image 0's cold fit (Zoo-cached flow
            # identity), then every later image starts from the previous
            # fitted state for reuse_state_epochs steps.
            params0 = prior_model.init(
                torch.Generator().manual_seed(cfg.seed + 3))
            pts0 = points[0][pmask_t[0]]
            u0 = unaries_t[0][pmask_t[0]]
            # 'unaries' convex mode is pointwise (no dense-grid reshape):
            # the multi-object override's choice
            # (`multiple_object_aware_path_connected_net.py:248-259`)
            params0 = apply_prefits(
                prior_model, params0, pts0,
                prefit_flow_identity=bool(
                    pargs.get("prefit_flow_net_identity")),
                flow_identity_lr=float(
                    pargs.get("prefit_flow_net_identity_lr", 1e-2)),
                flow_identity_weight_decay=float(pargs.get(
                    "prefit_flow_net_identity_weight_decay", 1e-5)),
                flow_identity_steps=int(pargs.get(
                    "prefit_flow_net_identity_num_epochs", 100)),
                prefit_convex=bool(pargs.get("prefit_convex_net")),
                convex_mode="unaries",
                convex_target=u0,
                convex_lr=float(pargs.get("prefit_convex_net_lr", 1e-3)),
                convex_weight_decay=float(
                    pargs.get("prefit_convex_net_weight_decay", 0.0)),
                convex_steps=int(
                    pargs.get("prefit_convex_net_num_epochs", 200)),
                zoo=self._pretrain_zoo(pargs),
                zoo_key=f"flow_identity_{tuple(pts0.shape)}_{cfg.seed}",
            )
            warm_cfg = dataclasses.replace(
                fit_cfg, num_steps=int(pargs.get("reuse_state_epochs", 200)),
                gate_threshold=None)
            fitted, aux = fit_priors_sequential(
                prior_model, params0, points, unaries_t,
                dataclasses.replace(fit_cfg, gate_threshold=None),
                warm_cfg=warm_cfg, valid_mask=valid_t, point_masks=pmask_t)
            # skipped images (val holdout / single-valued unaries) keep
            # their OWN pre-existing priors (the reference's "keep the state
            # of the prior" skip semantics,
            # `multiple_object_aware_path_connected_net.py:200-207`)
            fitted = T.tree_where(valid_t, fitted,
                                  self.stacked_params["prior"])
            # the reference gates EVERY fit (warm-started ones included):
            # IoU < threshold -> reset and retry with the FULL epoch count
            # (`path_connected_net.py:964-982`)
            gate_retry = make_gate_retry_fn(
                prior_model, fit_cfg, per_image_points=True,
                with_point_masks=True)
            fitted, scores = gate_retry(
                fitted, points, unaries_t, valid_t,
                retry_keys=_seeds(cfg.seed + 11, n_img),
                point_masks=pmask_t)
            aux["gate_iou"] = scores
        else:
            # on a mesh: the images over 'data', the points over 'grid'
            fitted, aux = fit_priors_batched(
                prior_model, self.stacked_params["prior"], points, unaries_t,
                fit_cfg, retry_keys=_seeds(cfg.seed + 7, n_img),
                valid_mask=valid_t, point_masks=pmask_t, mesh=self.mesh)
        self.stacked_params = dict(self.stacked_params, prior=fitted)
        if self.is_root:
            os.makedirs(os.path.dirname(state_path) or ".", exist_ok=True)
            save_prior_cache(fitted, state_path)
            logger.info("Pretrain state saved to %s", state_path)
        if cfg.save_images_after_pretraining:
            self._dump_images(epoch=0, folder="prior",
                              indices=range(len(self.samples)))
        gate = aux.get("gate_iou")
        result = {
            "loaded": False,
            "path": state_path,
            "gate_iou": np.asarray([]) if gate is None
            else gate.cpu().numpy(),
        }
        if cfg.compute_crf_after_pretraining:
            # after-pretrain CRF'd eval (`awesome_runner.py:335-341`
            # get_final_save_handle(compute_crf=...))
            result["metrics"] = self.evaluate(compute_crf=True)
        return result

    def _pretrain_zoo(self, pargs: Dict[str, Any]):
        """Zoo instance from pretrain_args (the reference nests
        ``zoo: {zoo_folder: ...}`` there,
        `config/path-connectedness/sequential/*.yaml`)."""
        z = pargs.get("zoo")
        if isinstance(z, dict) and z.get("zoo_folder"):
            from awesome_tpu_torch.nn.zoo import Zoo

            return Zoo(z["zoo_folder"])
        return z if hasattr(z, "load_model_state") else None

    # --- train -----------------------------------------------------------
    def _penalty_scales(self):
        """Extra-penalty scales: AwesomeLoss hardcodes (0.1, 100); the
        JOINT losses weight with (gamma, beta) from loss_args
        (`awesome/measures/awesome_loss_joint.py`)."""
        la = self.config.loss_args
        if "joint" in (self.config.loss_type or ""):
            return float(la.get("gamma", 1.0)), float(la.get("beta", 1.0))
        return 0.1, 100.0

    def _train_cfg(self, num_epochs: int):
        from awesome_tpu_torch.fit.pixel_trainer import PixelTrainConfig

        cfg = self.config
        pen_base, pen_align = self._penalty_scales()
        return PixelTrainConfig(
            num_epochs=num_epochs,
            lr=cfg.optimizer_args.get("lr", 1e-3),
            pen_base_scale=pen_base,
            pen_align_scale=pen_align,
            optimizer=cfg.optimizer_type
            if cfg.optimizer_type in ("adam", "adamax") else "adam",
            alpha=cfg.loss_args.get("alpha", 1.0),
            extra_penalty_after=(cfg.extra_penalty_after_n_epochs
                                 if cfg.use_extra_penalty_hook else None),
            extra_penalty_lr_factor=(
                cfg.reduce_lr_in_extra_penalty_hook_factor
                if cfg.use_reduce_lr_in_extra_penalty_hook else 1.0),
            use_plateau=cfg.use_lr_on_plateau_scheduler,
            lr_stop_scale=(
                cfg.lr_stop_training_watchdog_args.get("threshold_scale", 0.0)
                if cfg.use_lr_stop_training_watchdog
                and cfg.use_lr_on_plateau_scheduler else 0.0),
            train_segmentation=(cfg.segmentation_training_mode != "none"),
            wn_weight_decay=(cfg.weight_decay_on_weight_norm_modules
                             if cfg.split_params_in_param_groups else 0.0),
        )

    def _cadences(self) -> List[int]:
        cfg = self.config
        out = [self.CHECKPOINT_NTH_EPOCH]
        if cfg.compute_metrics_during_training_nth_epoch:
            out.append(cfg.compute_metrics_during_training_nth_epoch)
        if (cfg.plot_indices_during_training
                and cfg.plot_indices_during_training_nth_epoch):
            out.append(cfg.plot_indices_during_training_nth_epoch)
        if cfg.validation_each_nth_epoch:
            out.append(cfg.validation_each_nth_epoch)
        return out

    def segment_length(self) -> int:
        """Epochs per segment: the gcd of the run length and every
        cadence, so each cadence tick falls on a segment's end."""
        num_epochs = self.config.num_epochs
        seg_len = math.gcd(num_epochs, math.gcd(*(self._cadences() + [0])))
        return max(1, min(seg_len or num_epochs, num_epochs))

    def train(self) -> Dict[str, Any]:
        """Run the full training protocol; an unexpected error dumps the
        newest params + the error for post-mortem before re-raising
        (reference `awesome/agent/torch_agent.py:1063` emergency_save on
        training exceptions)."""
        from awesome_tpu_torch.fit.checkpoint import run_with_emergency

        return run_with_emergency(
            self._train_impl,
            os.path.join(self.output_folder, "checkpoints", "emergency")
            if self.is_root else None,
            lambda: self.stacked_params,
            lambda: {"epoch": getattr(self.tracker, "epoch", None)},
        )

    def _train_impl(self) -> Dict[str, Any]:
        from awesome_tpu_torch.fit.pixel_trainer import (
            make_pixel_segment_fn,
            make_shared_pixel_segment_fn,
            pixel_train_init,
            shared_pixel_train_init,
        )

        cfg = self.config
        shared_mode = cfg.segmentation_training_mode == "multi"
        num_epochs = cfg.num_epochs
        seg_len = self.segment_length()
        tcfg = self._train_cfg(seg_len)
        b = self._dev_batch
        batch = (b["px"], b["gt"], b["scr_mask"], b["rnd_mask"])

        if shared_mode:
            state = shared_pixel_train_init(
                self.wrapper, cfg.seed, len(self.samples), tcfg,
                params=self.stacked_params)  # pretrained priors if any
            self.stacked_params = state.params  # {'seg': shared, 'prior': B}
            segment = make_shared_pixel_segment_fn(self.wrapper, tcfg,
                                                   seg_len, mesh=self.mesh)
        else:
            state = pixel_train_init(self.wrapper, self.stacked_params, tcfg,
                                     stateful_seg=self.seg_stateful)
            segment = make_pixel_segment_fn(
                self.wrapper, tcfg, seg_len, loss_impl=self._make_loss_impl(),
                stateful_seg=self.seg_stateful, mesh=self.mesh)
        kind = "shared" if shared_mode else "pixel"
        start_seg = 0
        start_epoch = 0
        resumed_stopped = False
        if cfg.resume:
            resumed = self._try_resume(state, kind, seg_len, num_epochs)
            if resumed is not None:
                state, start_epoch, rex = resumed
                self.stacked_params = state.params
                start_seg = start_epoch // seg_len
                # a watchdog-stopped run must not train extra epochs on
                # every restart (that would break bit-identity)
                resumed_stopped = bool(rex.get("stopped_early"))

        # validation holdout: val images' params are NEVER stepped (and in
        # 'multi' mode contribute nothing to the shared-seg gradient); their
        # per-epoch losses are pure forward measurements. Spec:
        # `awesome/dataset/separable_dataset.py:10-105` +
        # `awesome/agent/torch_agent.py:233-243` (no-grad val phase).
        trainable = np.ones((len(self.samples),), bool)
        if self.val_indices:
            trainable[list(self.val_indices)] = False
        trainable = torch.as_tensor(trainable, device=self.device)

        # training_starts handles: initial eval metrics (already in the
        # restored tracker when resuming mid-run)
        if start_epoch == 0:
            if cfg.compute_metrics_during_training_nth_epoch:
                self.evaluate(compute_crf=cfg.compute_crf_with_metrics)
            self._maybe_dump_images(epoch=0)

        loss_chunks = []
        stopped_early = resumed_stopped
        # keep the TRUE epoch when nothing is left to train (stopped run,
        # or checkpoint >= num_epochs under a changed cadence)
        epoch = (start_epoch if (resumed_stopped or start_epoch >= num_epochs)
                 else start_seg * seg_len)
        for seg_i in range(start_seg, num_epochs // seg_len):
            if stopped_early:
                break
            state, aux = segment(state, *batch, trainable)
            self.stacked_params = state.params
            epoch = (seg_i + 1) * seg_len
            loss_hist = aux["loss_hist"].cpu().numpy()  # (B, L), one read
            loss_chunks.append(loss_hist)
            per_epoch = loss_hist.mean(axis=0)
            for e in range(seg_len):
                if self.train_indices and self.val_indices:
                    self.tracker.epoch_metric(
                        "Loss", loss_hist[self.train_indices, e].mean(),
                        "train")
                else:
                    self.tracker.epoch_metric("Loss", per_epoch[e], "train")
                self.tracker.tick_epoch()

            # validation cadence (+ best-model gate on the primary metric);
            # the reference also always validates on the LAST epoch
            # (`awesome_runner.py:474-475` should_validate_on_epoch)
            val_tick = (cfg.validation_each_nth_epoch
                        and epoch % cfg.validation_each_nth_epoch == 0
                        ) or epoch == num_epochs
            if self.val_indices and val_tick:
                self.tracker.epoch_metric(
                    "Loss", loss_hist[self.val_indices, -1].mean(), "val")
            if self.tracker.is_current_state_best_model():
                self.best_params = state.params
                self.save_checkpoint("best")

            if (cfg.compute_metrics_during_training_nth_epoch
                    and epoch % cfg.compute_metrics_during_training_nth_epoch
                    == 0 and epoch < num_epochs):
                self.evaluate(compute_crf=cfg.compute_crf_with_metrics)
            self._maybe_dump_images(epoch)
            # LR watchdog early stop: every image's plateau scale under the
            # threshold means every per-image fit is frozen (computed BEFORE
            # the 'latest' save so a stop landing on a checkpoint epoch
            # records stopped_early there too)
            watchdog_fired = False
            if tcfg.use_plateau and tcfg.lr_stop_scale > 0.0:
                scales = aux["lr_scale"].reshape(-1)
                watchdog_fired = bool((scales <= tcfg.lr_stop_scale).all())

            if epoch % self.CHECKPOINT_NTH_EPOCH == 0:
                self.save_checkpoint("latest", state=state, epoch=epoch,
                                     state_kind=kind,
                                     stopped_early=watchdog_fired)

            if watchdog_fired:
                logger.info("LR watchdog: all fits frozen at epoch %d",
                            epoch)
                stopped_early = True
                break

            for fn in self.handles["epoch_processed"]:
                fn(self, epoch)

        # training_finished: final metrics (+CRF), final save, checkpoint
        final_metrics = self.evaluate(
            compute_crf=cfg.compute_crf_with_metrics
            or cfg.compute_crf_after_training)
        if self.best_params is None:
            self.best_params = state.params
        self.save_checkpoint("end", state=state, epoch=epoch,
                             state_kind=kind, stopped_early=stopped_early)
        # final-save handle: plot_final_indices (-1 = all images)
        final_idx = cfg.plot_final_indices
        if final_idx is not None:
            if final_idx == -1:
                final_idx = list(range(len(self.samples)))
            elif not isinstance(final_idx, (list, tuple)):
                final_idx = [final_idx]
            self._dump_images(epoch, "final", final_idx)
        else:
            self._maybe_dump_images(epoch=epoch, force=True)
        for fn in self.handles["training_finished"]:
            fn(self)
        loss_hist = (np.concatenate(loss_chunks, axis=1) if loss_chunks
                     else np.zeros((len(self.samples), 0)))
        return {"loss_hist": loss_hist, "stopped_early": stopped_early,
                "final_metrics": final_metrics}

    def _try_resume(self, template_state, kind: str, seg_len: int,
                    num_epochs: int):
        """Locate the newest resumable checkpoint under
        ``<output_folder>/checkpoints`` and restore the full train state.

        Returns ``(state, epoch, extra_meta)`` or ``None`` when nothing
        resumable exists. The resumed trajectory is bit-identical to an
        uninterrupted run: the NamedTuple state carries params, optimizer
        moments, plateau schedule and the absolute epoch counter, and the
        tracker (including its best-model gate) is restored from the
        checkpoint metadata."""
        from awesome_tpu_torch.fit.checkpoint import restore_resumable

        def _check_alignment(ep, ex):
            # a watchdog-stopped run needs no alignment: nothing more trains
            if ep % seg_len and not ex.get("stopped_early"):
                raise ValueError(
                    f"resume checkpoint at epoch {ep} is not aligned to "
                    f"the segment length {seg_len}: a cadence/num_epochs "
                    "config change since the checkpoint was written is "
                    "not resumable")

        base = os.path.join(self.output_folder, "checkpoints")
        res = restore_resumable(
            base, kind, template_state, num_epochs, best_subpath="params",
            best_template=template_state.params, validate=_check_alignment)
        if res is None:
            return None
        if res["tracker"] is not None:
            self.tracker = res["tracker"]
        if res["best"] is not None:
            self.best_params = res["best"]
        return res["state"], res["epoch"], res["extra"]

    # --- saving / image dumps ---------------------------------------------
    def save_checkpoint(self, tag: str, state=None, epoch=None,
                        state_kind=None, stopped_early: bool = False) -> str:
        """Agent-checkpoint save (params + tracker + config snapshot).
        Spec: `awesome/run/handles.py:195-232` save/prior-save handles.

        With the full train ``state`` and the absolute ``epoch`` the whole
        state (optimizer moments, plateau schedule, epoch counters) is
        saved alongside, making the checkpoint RESUMABLE
        (``AwesomeConfig.resume``). On a mesh only rank 0 writes."""
        from awesome_tpu_torch.fit.checkpoint import (
            AgentCheckpoint,
            atomic_dir,
            config_snapshot,
            save_prior_cache,
            save_pytree,
        )
        directory = os.path.join(self.output_folder, "checkpoints", tag)
        if not self.is_root:
            return directory
        params = (self.best_params
                  if tag == "best" and self.best_params is not None
                  else self.stacked_params)
        extra = {}
        if epoch is not None:
            extra["epoch"] = int(epoch)
            extra["stopped_early"] = bool(stopped_early)
        if state_kind is not None:
            extra["state_kind"] = state_kind
        # atomic swap: a preemption mid-save leaves the previous complete
        # checkpoint intact (tag or its .old twin) instead of a torn one
        config, arrays = config_snapshot(self.config)
        with atomic_dir(directory) as tmp:
            AgentCheckpoint(name=self.config.run_name, params=params,
                            tracker=self.tracker.to_dict(), config=config,
                            extra=extra, arrays=arrays).save(tmp)
            if state is not None:
                save_pytree(tuple(state), os.path.join(tmp, "train_state"))
            if isinstance(params, dict) and "prior" in params:
                save_prior_cache(params["prior"],
                                 os.path.join(tmp, "prior_cache"))
        return directory

    def _maybe_dump_images(self, epoch: int, force: bool = False) -> None:
        cfg = self.config
        indices = cfg.plot_indices_during_training
        if not indices:
            return
        nth = cfg.plot_indices_during_training_nth_epoch or 1
        if not force and epoch % nth != 0:
            return
        self._dump_images(epoch, "output", indices)

    def _dump_images(self, epoch: int, folder: str, indices) -> None:
        """Qualitative dumps of seg/prior masks for selected images.
        Spec: `awesome/run/awesome_runner.py:304-333` _save_image."""
        from awesome_tpu_torch.runner.functions import save_result

        if not self.is_root:
            return
        outputs = self._forward_all()
        for index in indices:
            if index >= len(self.samples):
                continue
            s = self.samples[index]
            h, w = s.shape
            out = self._crop_output(outputs, index)
            seg = out[:, 0].reshape(h, w)
            prior = out[:, 1].reshape(h, w) if out.shape[1] > 1 else None
            save_result(
                os.path.join(self.output_folder, folder, f"{index:03d}",
                             f"e{epoch:05d}"),
                index, s.image, seg > 0.5,
                prior_mask=prior > 0.5 if prior is not None else None,
                unaries=(seg if self.config.include_unaries_when_saving
                         else None))

    # --- eval ------------------------------------------------------------
    def _dense_px(self, s, pad_shape=None) -> np.ndarray:
        """Dense encoded pixel matrix of one image, layout (y, x, r, g, b)
        with the xytype encoding applied. ``pad_shape`` (Hp, Wp) emits the
        PADDED-grid layout (the image at [:h, :w], zero rgb elsewhere; xy
        keeps the image's own normalization)."""
        h, w = s.shape
        if pad_shape is None:
            yy, xx = np.mgrid[0:h, 0:w]
            rgb = s.image.reshape(-1, 3)
        else:
            hp, wp = pad_shape
            yy, xx = np.mgrid[0:hp, 0:wp]
            rgb = np.zeros((hp, wp, 3), np.float32)
            rgb[:h, :w] = s.image
            rgb = rgb.reshape(-1, 3)
        norm = np.stack([yy / h - 0.5, xx / w - 0.5], -1).reshape(-1, 2)
        return self._encode_px(
            s, np.concatenate([norm, rgb], axis=-1).astype(np.float32))

    def _eval_pixels(self) -> np.ndarray:
        """Dense full-grid pixel matrices for every image, padded to a
        shared bucket: (B, Nmax, C), layout (y, x, r, g, b).

        Pixel mode: each image's h*w rows come first, zero rows trail (so
        ``out[i, :h*w].reshape(h, w)`` is exact). Image mode: the
        PADDED-grid layout of (Hmax, Wmax), so the conv seg net sees one
        shape; crop ``[:h, :w]`` after the reshape."""
        if self._eval_px is None:
            if self.image_mode:
                px = np.stack([self._dense_px(s, pad_shape=self._shape)
                               for s in self.samples]).astype(np.float32)
            else:
                mats = [self._dense_px(s) for s in self.samples]
                n_max = max(m.shape[0] for m in mats)
                px = np.zeros((len(mats), n_max, mats[0].shape[1]),
                              np.float32)
                for i, m in enumerate(mats):
                    px[i, : m.shape[0]] = m
            self._eval_px = px
        return self._eval_px

    def _forward_all(self, params=None) -> np.ndarray:
        """One vmapped forward evaluating EVERY image's model on its dense
        grid -> (B, Nmax, C) numpy (one host transfer). Replaces the
        reference's per-image no-grad loop (`run/functions.py:2111`)."""
        params = params if params is not None else self.stacked_params
        px = torch.as_tensor(self._eval_pixels(), device=self.device)
        with torch.no_grad():
            if self.config.segmentation_training_mode == "multi":
                axes = {"seg": None}
                if "prior" in params:
                    axes["prior"] = 0
                out = torch.func.vmap(self.wrapper.apply,
                                      in_dims=(axes, 0))(params, px)
            else:
                out = torch.func.vmap(self._forward_one)(params, px)
        if out.ndim == 2:
            out = out[..., None]
        return out.cpu().numpy()

    def _crop_output(self, outputs: np.ndarray, i: int) -> np.ndarray:
        """Image i's (h*w, C) rows of the stacked eval output, undoing the
        pad-to-bucket layout (trailing rows in pixel mode, the 2-D padded
        grid in image mode)."""
        h, w = self.samples[i].shape
        if self.image_mode:
            hp, wp = self._shape
            return outputs[i].reshape(hp, wp, -1)[:h, :w].reshape(h * w, -1)
        return outputs[i, : h * w]

    def evaluate(self, compute_crf: Optional[bool] = None,
                 params=None) -> Dict[str, float]:
        """Full-dataset eval: per-image seg/prior (and, with ``compute_crf``,
        CRF-refined seg) IoU + pixel accuracy on the dense grid vs GT, one
        vmapped forward for all images. ``compute_crf=None`` takes the
        config's ``compute_crf_with_metrics``. Spec:
        `awesome/run/handles.py:339-477` get_compute_eval_metrics (+CRF via
        `run/handles.py:376-459`, `run/crf.py:45`)."""
        from awesome_tpu_torch.measures.metrics import (
            iou_np,
            pixel_accuracy_np,
        )
        from awesome_tpu_torch.ops.crf import dense_crf, dense_crf_batched

        if compute_crf is None:
            compute_crf = self.config.compute_crf_with_metrics
        outputs = self._forward_all(params)
        # images of one shape: ONE batched CRF call refines them all (the
        # reference loops pydensecrf per image on the host); mixed shapes
        # take the per-image call below
        crf_refined = None
        if compute_crf and len({s.shape for s in self.samples}) == 1:
            imgs = np.stack([s.image for s in self.samples])
            segs = np.stack([
                self._crop_output(outputs, i)[:, 0].reshape(s.shape)
                for i, s in enumerate(self.samples)])
            crf_refined = dense_crf_batched(imgs, segs,
                                            is_softmax_unaries=True,
                                            device=self.device)
        seg_ious, prior_ious, accs, crf_ious = [], [], [], []
        for i, s in enumerate(self.samples):
            out = self._crop_output(outputs, i)
            seg = out[:, 0:1]
            prior = out[:, 1:2] if out.shape[1] > 1 else None
            gt = s.gt.reshape(-1, 1)
            # fg encoded as 0 -> invert for fg IoU
            seg_ious.append(iou_np(seg > 0.5, gt > 0.5, invert=True))
            accs.append(pixel_accuracy_np(seg, gt))
            if prior is not None:
                prior_ious.append(iou_np(prior > 0.5, gt > 0.5, invert=True))
            if compute_crf:
                # the seg probability of BACKGROUND (fg = 0); the CRF
                # refines the 2-class distribution against the rgb image
                refined = crf_refined[i] if crf_refined is not None \
                    else dense_crf(s.image, seg.reshape(s.shape),
                                   is_softmax_unaries=True,
                                   device=self.device)
                crf_ious.append(iou_np(refined[..., 0].reshape(-1, 1) > 0.5,
                                       gt > 0.5, invert=True))
        metrics = {
            "MeanForegroundBinaryMIOU": float(np.mean(seg_ious)),
            "MeanPixelAccuracy": float(np.mean(accs)),
        }
        if prior_ious:
            metrics["PriorMeanForegroundBinaryMIOU"] = float(
                np.mean(prior_ious))
        if crf_ious:
            metrics["CRFMeanForegroundBinaryMIOU"] = float(np.mean(crf_ious))
        # split-aware variants: the reference reports eval metrics per
        # train/val dataloader (`awesome/util/tensorboard.py:59-122` tag
        # scheme); held-out images get their own means.
        if self.train_indices and self.val_indices:
            per_image = {"MeanForegroundBinaryMIOU": seg_ious,
                         "MeanPixelAccuracy": accs}
            if prior_ious:
                per_image["PriorMeanForegroundBinaryMIOU"] = prior_ious
            if crf_ious:
                per_image["CRFMeanForegroundBinaryMIOU"] = crf_ious
            for k, vals in per_image.items():
                vals = np.asarray(vals)
                metrics[f"train/{k}"] = float(
                    vals[list(self.train_indices)].mean())
                metrics[f"val/{k}"] = float(
                    vals[list(self.val_indices)].mean())
        for k, v in metrics.items():
            self.tracker.epoch_metric(k, v, "eval")
        return metrics

    def sequential_prior_fit(self, num_steps: int = 2000, lr: float = 1e-3,
                             gate_threshold: Optional[float] = 0.5,
                             chunk: int = 8) -> Dict[str, Any]:
        """The paper's "sequential fit" (post-processing): refit every
        image's prior against the TRAINED segmentation's dense unaries on
        the full grid, ``chunk`` images per batched fit (one K4 and one K5
        launch per step for the chunk with a fused ICNN prior).

        Spec: `awesome/model/path_connected_net.py:730-1008`
        _prior_based_pretrain (serial there; batched here).
        """
        from awesome_tpu_torch.data.batching import stack_padded
        from awesome_tpu_torch.fit.prior_fit import (
            FitConfig,
            make_batched_fit_fn,
        )

        # one vmapped forward gives every image's trained seg unaries
        outputs = self._forward_all()
        pts_list, target_list, valid = [], [], []
        for i, s in enumerate(self.samples):
            # per-image dense grid at the image's OWN shape; prior query
            # points = the encoding's leading channels (xy, or the feature
            # space for xytype 'feat')
            px = self._dense_px(s)
            seg = self._crop_output(outputs, i)[:, 0:1]
            target = (seg >= 0.5).astype(np.float32)
            pts_list.append(px[:, 0:2].astype(np.float32))
            target_list.append(target)
            valid.append(len(np.unique(target)) > 1)

        # heterogeneous sizes: bucket-pad the per-image point lists; padded
        # points carry loss weight 0 and are excluded from the gate IoU
        pts, masks = stack_padded(pts_list)
        targets, _ = stack_padded(target_list)

        prior_model = self.wrapper.prior_module
        # warm start from the jointly-trained priors when present, else
        # fresh per-image inits
        prior_stack = self._prior_slice_of_stack()
        if prior_stack is None:
            gen = torch.Generator().manual_seed(self.config.seed)
            prior_stack = T.stack_trees(
                [prior_model.init(gen) for _ in self.samples])

        cfg = FitConfig(num_steps=num_steps, lr=lr,
                        gate_threshold=gate_threshold)
        retry_keys = _seeds(self.config.seed + 1, len(self.samples))
        b = len(self.samples)
        chunk = max(1, min(chunk, b))
        run = make_batched_fit_fn(prior_model, cfg, per_image_points=True,
                                  with_point_masks=True, mesh=self.mesh)
        fitted_chunks, gate_chunks = [], []
        valid_arr = np.asarray(valid)
        dev = self.device

        def pad_tail(x, n):
            # the ragged tail repeats its last image up to the chunk width
            # (valid_mask False), so every chunk has one shape
            if x.shape[0] == n:
                return x
            reps = x[-1:].repeat_interleave(n - x.shape[0], dim=0) \
                if isinstance(x, torch.Tensor) \
                else np.repeat(x[-1:], n - x.shape[0], axis=0)
            cat = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
            return cat([x, reps], 0)

        for lo in range(0, b, chunk):
            hi = min(lo + chunk, b)
            n_real = hi - lo
            sel = slice(lo, hi)
            chunk_valid = pad_tail(valid_arr[sel], chunk).copy()
            chunk_valid[n_real:] = False  # pad slots pass through
            f, aux = run(
                T.tree_map(lambda x: pad_tail(x[sel], chunk), prior_stack),
                torch.as_tensor(pad_tail(pts[sel], chunk), device=dev),
                torch.as_tensor(pad_tail(targets[sel], chunk), device=dev),
                valid_mask=torch.as_tensor(chunk_valid, device=dev),
                retry_keys=pad_tail(np.asarray(retry_keys[sel]), chunk
                                    ).tolist(),
                point_masks=torch.as_tensor(pad_tail(masks[sel], chunk),
                                            device=dev))
            fitted_chunks.append(T.tree_map(lambda x: x[:n_real], f))
            if "gate_iou" in aux:
                gate_chunks.append(aux["gate_iou"][:n_real].cpu().numpy())
        fitted = T.tree_map(lambda *xs: torch.cat(xs, dim=0), *fitted_chunks)
        # write the refit priors back into the stacked wrapper params
        self.stacked_params = dict(self.stacked_params, prior=fitted)
        return {"gate_iou": np.concatenate(gate_chunks) if gate_chunks
                else np.asarray([]), "valid": valid_arr}

    def _prior_slice_of_stack(self):
        if isinstance(self.stacked_params, dict) and (
                "prior" in self.stacked_params):
            return self.stacked_params["prior"]
        return None

    def save_results(self) -> str:
        """Persist config, tracker, and the stacked params (rank 0 of a
        mesh)."""
        if not self.is_root:
            return self.output_folder
        return persist_run(self.output_folder, self.config, self.tracker,
                           self.stacked_params, self._stacked_axes())

