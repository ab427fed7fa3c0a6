"""FBMS experiment runner: spatio-temporal prior fitting and joint
UNet+prior training on video sequences; counterpart of
``awesome_tpu/runner/fbms_runner.py``.

Composition-root port of the FBMS paths of `awesome/run/awesome_runner.py`
(dataset='FBMSSequenceDataset', spatio-temporal configs
`config/path-connectedness/spatio-temporal/` and the joint configs
`config/path-connectedness/joint/*`):

- ``pretrain``: fit ONE shared (x, y, t) prior against the sequence's
  sparse trajectory weak labels (optionally noise-flipped), or against
  dense unaries with frame-level noise (the noisy spatio-temporal family),
- ``evaluate``: IoU of the thresholded prior against dense GT on the
  labeled frames,
- ``pretrain_joint_priors``: the per-frame prior pretrain (a cold fit on
  frame 0, warm fits on the rest); on the card each step is one launch of
  the fused flagship kernel (``ops/csrc/flagship.cu``),
- ``train_joint`` / ``train_joint_multi_object``: joint UNet + per-frame
  prior training (``fit/trainer.py``), resumable bitwise from its
  checkpoints.

Every tensor lives on the runner's ``device`` (the card unless the caller
passes ``"cpu"``); model inits draw from ``torch.Generator``s seeded by
the config's seed. ``mesh_shape`` runs the spatio-temporal fit (each
frame's points over 'grid') and the joint and multi-object loops (a
batch's frames over 'data', the priors' points over 'grid') on a device
mesh (``parallel/mesh.py``); every rank runs every method and holds the
whole state, and only rank 0 writes checkpoints, frames and run folders.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from awesome_tpu_torch.core import grids as G
from awesome_tpu_torch.core import tree as T
from awesome_tpu_torch.device import DeviceLike, resolve_device
from awesome_tpu_torch.fit.trainer import (
    MultiObjectTrainState,
    joint_train_init,
    multi_object_train_init,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FBMSExperimentConfig:
    dataset_path: str = ""
    flip_probability: float = 0.0
    # the noisy-spatio-temporal family's noise model: this FRACTION OF
    # FRAMES (middle frames only; first/last prefit the convex net) has
    # its dense unaries replaced by clamp(N(0.5, 1), 0, 1) garbage, and
    # the (x, y, t) prior must bridge them
    # (`awesome/model/noisy_path_connected_net.py:178-230`). None =
    # trajectory weak-label fit (flip_probability applies there instead).
    frame_noise_percentage: Optional[float] = None
    noise_seed: int = 0
    num_epochs: int = 2000
    lr: float = 1e-3
    weight_mode: str = "none"
    prior_hidden_units: int = 32
    prior_flows: int = 12
    convex_hidden_units: int = 130
    convex_hidden_layers: int = 2
    downscale: int = 1
    seed: int = 42
    # [data, grid] device-mesh shape (AwesomeConfig.mesh_shape semantics);
    # None = single device
    mesh_shape: Optional[List[int]] = None


class _EpochLrSchedule:
    """Host-side epoch-level LR schedule shared by the joint loops:
    torch StepLR / ReduceLROnPlateau(mode='min', threshold_mode='rel')
    transitions producing the step's ``lr_scale``
    (`awesome/run/awesome_runner.py:465-472`)."""

    def __init__(self, scheduler):
        self.scheduler = scheduler or {}
        self.scale = 1.0
        self._best = float("inf")
        self._wait = 0

    @property
    def needs_loss(self) -> bool:
        return self.scheduler.get("type") == "plateau"

    def update(self, epoch: int, mean_loss=None) -> float:
        s = self.scheduler
        if s.get("type") == "step":
            if (epoch + 1) % int(s.get("step_size", 100)) == 0:
                self.scale *= float(s.get("gamma", 0.1))
        elif s.get("type") == "plateau" and mean_loss is not None:
            # improvement only if loss < best * (1 - rel_threshold)
            rel = float(s.get("threshold", 1e-4))
            if mean_loss < self._best * (1.0 - rel):
                self._best, self._wait = mean_loss, 0
            else:
                self._wait += 1
                if self._wait > int(s.get("patience", 100)):
                    self.scale *= float(s.get("factor", 0.1))
                    self._wait = 0
        return self.scale

    def state_dict(self) -> Dict:
        return {"scale": self.scale, "best": self._best,
                "wait": self._wait}

    def load_state_dict(self, d: Dict) -> None:
        self.scale = float(d.get("scale", 1.0))
        self._best = float(d.get("best", float("inf")))
        self._wait = int(d.get("wait", 0))


def _mean_loss(metrics) -> float:
    """An epoch's mean batch loss, summed as numpy sums it (the JAX
    runner's ``np.asarray(loss).mean()``)."""
    return float(metrics["loss"].cpu().numpy().mean())


class FBMSRunner:
    def __init__(self, config: FBMSExperimentConfig, dataset=None,
                 device: DeviceLike = None):
        self.config = config
        self.dataset = dataset
        self.device = resolve_device(device)
        self.model = None
        self.params = None
        self.awesome_config = None

    def _gen(self, seed: int) -> torch.Generator:
        return torch.Generator().manual_seed(int(seed))

    @classmethod
    def from_awesome_config(cls, cfg, dataset=None, dataset_path=None,
                            device: DeviceLike = None):
        """Build from an imported reference YAML (`runner.reference_import`)
        e.g. `config/path-connectedness/joint/UNET+cars3+...+joint.yaml`:
        prior factory args from ``prior_model_args``, optimizer lr, epochs,
        batch size and flip settings from the nested dataset args. The
        device is ``device``, else the config's."""
        pargs = dict(cfg.prior_model_args or {})
        ds = (cfg.dataset_args or {}).get("dataset") or {}
        # noisy spatio-temporal family: 'noisy_percentage' is the FRAME
        # noise fraction: that fraction of middle frames has its dense
        # unaries replaced by random garbage before the shared (x, y, t)
        # fit (`awesome/model/noisy_path_connected_net.py:178-230`); the
        # reference nests it in pretrain_args. Presence of the key (even
        # at 0) selects the dense-unaries protocol.
        frame_noise = None
        for source in (cfg.pretrain_args or {}, ds,
                       cfg.dataset_args or {}):
            if "noisy_percentage" in source:
                frame_noise = float(source["noisy_percentage"])
                break
        # point-level weak-label flipping is the separate data-layer
        # feature (`data/weak_label_processing.py`)
        flip = 0.0
        for source in (ds, cfg.dataset_args or {}):
            if source.get("flip_probability"):
                flip = float(source["flip_probability"])
                break
        # pretrain-only families budget the PRIOR fit via
        # pretrain_args.num_epochs (the YAML's top-level num_epochs is
        # the joint-loop count, unused there)
        pa = cfg.pretrain_args or {}
        pretrain_only = bool(getattr(cfg, "pretrain_only", False))
        epochs = (
            int(pa["num_epochs"])
            if pretrain_only and pa.get("num_epochs")
            else cfg.num_epochs
        )
        # pretrain-only budget/lr come from pretrain_args (the top-level
        # optimizer lr is the joint loop's)
        lr = (
            float(pa["lr"]) if pretrain_only and pa.get("lr")
            else float(cfg.optimizer_args.get("lr", 1e-4))
        )
        c = FBMSExperimentConfig(
            dataset_path=dataset_path or ds.get("dataset_path", ""),
            flip_probability=flip,
            frame_noise_percentage=frame_noise,
            # noise draw follows the experiment seed (seed42/47/131 YAMLs
            # are independent noise realizations of the same noise level)
            noise_seed=cfg.seed,
            num_epochs=epochs,
            lr=lr,
            prior_hidden_units=int(pargs.get("hidden_units", 32)),
            prior_flows=int(pargs.get("flow_n_flows", 12)),
            convex_hidden_units=int(pargs.get("convex_net_hidden_units", 130)),
            convex_hidden_layers=int(
                pargs.get("convex_net_hidden_layers", 2)
            ),
            seed=cfg.seed,
            mesh_shape=cfg.mesh_shape,
        )
        runner = cls(c, dataset=dataset,
                     device=device if device is not None else cfg.device)
        runner.awesome_config = cfg
        return runner

    @staticmethod
    def joint_state_kind(cfg) -> str:
        """The checkpoint ``state_kind`` this config's joint dispatch
        produces/consumes: the single source of truth for the label_mode
        routing (``multiple_objects`` -> the multi-object engine;
        `awesome/dataset/label_mode.py`), used by
        ``train_joint_from_config`` and by the CLI's resume pretrain-skip
        predicate (``run.py``) alike."""
        ds = (cfg.dataset_args or {}).get("dataset") or {}
        lm = ds.get("label_mode")
        if isinstance(lm, dict):
            lm = lm.get("value")
        return "multi" if lm == "multiple_objects" else "joint"

    def _out_dir(self) -> str:
        cfg = self.awesome_config
        if cfg.timestamp is None:  # run_name is always truthy: key on
            cfg.prepare()          # the timestamp that makes it unique
        return cfg.output_folder or os.path.join(cfg.runs_path, cfg.run_name)

    def train_joint_from_config(self, num_epochs=None, batch_size=None,
                                eval_epoch0=False):
        """Run the joint experiment with the imported reference settings
        (epochs / lr / batch size / seg training mode / loss alpha+beta /
        prior on-off: ``use_prior_model: false`` is the refit-unet family,
        `config/path-connectedness/refit-unet/*.yaml`: retrain the UNet
        alone on the weak labels)."""
        cfg = self.awesome_config
        if cfg is None:
            raise ValueError("built without from_awesome_config")
        ds = (cfg.dataset_args or {}).get("dataset") or {}
        bs = batch_size or int(ds.get("training_batch_size", 1))
        out_dir = self._out_dir()
        if self.joint_state_kind(cfg) == "multi":
            # multi-object label mode (`awesome/dataset/label_mode.py`):
            # shared multi-channel UNet + per-frame child priors
            if cfg.compute_crf_with_metrics:
                logger.warning(
                    "compute_crf_with_metrics is not supported by the "
                    "multi-object eval (per-object unaries); ignoring"
                )
            return self.train_joint_multi_object(
                max_objects=int(ds.get("max_objects", 2)),
                num_epochs=num_epochs or cfg.num_epochs,
                lr=float(cfg.optimizer_args.get("lr", 1e-4)),
                prior_lr=float(cfg.optimizer_args.get("lr", 1e-4)),
                batch_size=min(bs, len(self.dataset)),
                seed=cfg.seed,
                train_segmentation=(
                    cfg.segmentation_training_mode != "none"
                ),
                alpha=float(cfg.loss_args.get("alpha", 1.0)),
                beta=float(cfg.loss_args.get("beta", 1.0)),
                pretrain_steps=int(
                    (cfg.pretrain_args or {}).get("num_epochs", 400)
                ) if cfg.do_pretraining else 0,
                scheduler=self._scheduler_from_config(cfg),
                watchdog_lr=self._watchdog_lr_from_config(cfg),
                eval_nth_epoch=cfg.compute_metrics_during_training_nth_epoch,
                eval_epoch0=eval_epoch0,
                checkpoint_dir=os.path.join(out_dir, "checkpoints"),
                resume=bool(getattr(cfg, "resume", False)),
            )
        return self.train_joint(
            eval_epoch0=eval_epoch0,
            eval_crf=bool(cfg.compute_crf_with_metrics),
            # nth-epoch 'latest' saves make every CLI joint run resumable
            # (AwesomeConfig.resume; run.py --resume true)
            checkpoint_dir=os.path.join(out_dir, "checkpoints"),
            resume=bool(getattr(cfg, "resume", False)),
            num_epochs=num_epochs or cfg.num_epochs,
            lr=float(cfg.optimizer_args.get("lr", 1e-4)),
            prior_lr=float(cfg.optimizer_args.get("lr", 1e-4)),
            batch_size=min(bs, len(self.dataset)),
            seed=cfg.seed,
            train_segmentation=(cfg.segmentation_training_mode != "none"),
            alpha=float(cfg.loss_args.get("alpha", 1.0)),
            beta=float(cfg.loss_args.get("beta", 1.0)),
            use_segmentation_output_inversion=(
                cfg.use_segmentation_output_inversion
            ),
            use_prior=cfg.use_prior_model,
            eval_nth_epoch=cfg.compute_metrics_during_training_nth_epoch,
            scheduler=self._scheduler_from_config(cfg),
            watchdog_lr=self._watchdog_lr_from_config(cfg),
            plot_indices=cfg.plot_indices_during_training,
            plot_nth_epoch=(
                cfg.plot_indices_during_training_nth_epoch or 100
            ),
            plot_dir=(
                os.path.join(out_dir, "output")
                if cfg.plot_indices_during_training else None
            ),
        )

    @staticmethod
    def _scheduler_from_config(cfg) -> Optional[Dict]:
        """Epoch-level LR scheduler spec from the imported YAML flags
        (`awesome/run/awesome_runner.py:465-472`)."""
        if cfg.use_step_lr_scheduler:
            a = cfg.step_lr_scheduler_args or {}
            return {"type": "step",
                    "gamma": float(a.get("gamma", 0.1)),
                    "step_size": int(a.get("step_size", 100))}
        if cfg.use_lr_on_plateau_scheduler:
            a = cfg.lr_on_plateau_scheduler_args or {}
            return {"type": "plateau",
                    "factor": float(a.get("factor", 0.1)),
                    "patience": int(a.get("patience", 100)),
                    "threshold": float(a.get("threshold", 1e-4))}
        return None

    @staticmethod
    def _watchdog_lr_from_config(cfg) -> Optional[float]:
        """LR-watchdog floor; only meaningful when some scheduler can
        actually decay the LR."""
        if cfg.use_lr_stop_training_watchdog and (
            cfg.use_lr_on_plateau_scheduler or cfg.use_step_lr_scheduler
        ):
            a = cfg.lr_stop_training_watchdog_args or {}
            return float(a.get("learning_rate", 1e-7))
        return None

    def run_pretrain_only_from_config(self, zoo=None, **overrides):
        """The pretrain_only flow of the path-connectedness/sequential and
        weight-decay families (`config/path-connectedness/sequential/*.yaml`:
        agent_args.pretrain_only true, num_epochs 0): load the pretrain
        state when present, else run the reuse_state sequential prior fit
        with the configured prefits and SAVE the state; the runner port of
        `awesome/agent/torch_agent.py:553-607`.

        Returns {'loaded': bool, 'path': str, ...fit aux}.
        """
        from awesome_tpu_torch.fit.checkpoint import (
            load_prior_cache,
            pytree_exists,
            save_prior_cache,
        )
        from awesome_tpu_torch.nn.zoo import Zoo

        cfg = self.awesome_config
        if cfg is None:
            raise ValueError("built without from_awesome_config")
        pa = cfg.pretrain_args or {}
        state_path = cfg.pretrain_state_path or ""
        if zoo is None and isinstance(pa.get("zoo"), dict):
            folder = pa["zoo"].get("zoo_folder")
            if folder:
                zoo = Zoo(folder)
        if (
            state_path
            and not cfg.force_pretrain
            and pytree_exists(state_path)
        ):
            model = self._joint_prior_model()
            template = T.stack_trees(
                [model.init(self._gen(cfg.seed))] * len(self.dataset))
            self.joint_prior_init = load_prior_cache(
                state_path, template=template
            )
            logger.info("Pretrain state loaded from %s", state_path)
            return {"loaded": True, "path": state_path}
        res = self.pretrain_joint_priors_from_config(zoo=zoo, **overrides)
        if state_path:
            os.makedirs(os.path.dirname(state_path) or ".", exist_ok=True)
            save_prior_cache(self.joint_prior_init, state_path)
            logger.info("Pretrain state saved to %s", state_path)
        return dict(res, loaded=False, path=state_path)

    def pretrain_joint_priors_from_config(self, zoo=None, **overrides):
        """Per-image prior pretrain with the imported reference
        ``pretrain_args`` (num_epochs / reuse_state_epochs / lr / prefit_*
        knobs, e.g. the joint YAML's 4000/400 + flow-identity and convex
        prefits)."""
        cfg = self.awesome_config
        if cfg is None:
            raise ValueError("built without from_awesome_config")
        pa = cfg.pretrain_args or {}
        kwargs = dict(
            num_steps=int(pa.get("num_epochs", 2000)),
            reuse_state_steps=int(pa.get("reuse_state_epochs", 400)),
            lr=float(pa.get("lr", 1e-3)),
            # the weight-decay family sweeps this knob
            # (`config/path-connectedness/weight-decay/WD_*.yaml`)
            flow_weight_decay=float(pa.get("flow_weight_decay", 1e-5)),
            seed=cfg.seed,
            prefit_flow_identity=bool(pa.get("prefit_flow_net_identity",
                                             False)),
            prefit_flow_identity_steps=int(
                pa.get("prefit_flow_net_identity_num_epochs", 100)
            ),
            prefit_flow_identity_lr=float(
                pa.get("prefit_flow_net_identity_lr", 1e-2)
            ),
            prefit_convex=bool(pa.get("prefit_convex_net", False)),
            prefit_convex_steps=int(
                pa.get("prefit_convex_net_num_epochs", 200)
            ),
            prefit_convex_lr=float(pa.get("prefit_convex_net_lr", 1e-3)),
            zoo=zoo,
        )
        kwargs.update(overrides)
        return self.pretrain_joint_priors(**kwargs)

    def build(self):
        from awesome_tpu_torch.data.fbms import FBMSSequenceDataset
        from awesome_tpu_torch.nn.path_connected import (
            real_nvp_path_connected_net,
        )

        cfg = self.config
        if self.dataset is None:
            self.dataset = FBMSSequenceDataset(
                cfg.dataset_path,
                flip_probability=cfg.flip_probability,
                noise_seed=cfg.noise_seed,
            )
        frame0 = self.dataset.load_frame(0)
        self.shape = frame0.shape[:2]
        self.model = real_nvp_path_connected_net(
            channels=3,  # (x, y, t)
            hidden_units=cfg.prior_hidden_units,
            flow_n_flows=cfg.prior_flows,
            flow_output_fn="tanh",
            spatial_shape=self.shape,
            convex_net_hidden_units=cfg.convex_hidden_units,
            convex_net_hidden_layers=cfg.convex_hidden_layers,
            device=self.device,
        )
        self.params = self.model.init(self._gen(cfg.seed))
        return self

    def _collect(self):
        """Dense (T, N, 1) unaries + (T, N) labeled masks from trajectory
        weak labels."""
        t = len(self.dataset)
        h, w = self.shape
        targets = np.ones((t, h * w, 1), np.float32)
        labeled = np.zeros((t, h * w), bool)
        for i in range(t):
            s = self.dataset.sample(i)
            targets[i, :, 0] = s["unaries"].reshape(-1)
            labeled[i] = s["labeled"].reshape(-1)
        return targets, labeled

    def _dense_unaries(self) -> np.ndarray:
        """(T, N, 1) dense per-frame unaries (fg = 0). The reference
        forwards its pretrained UNet checkpoint per frame
        (`awesome/model/noisy_path_connected_net.py:208-215`,
        `segmentation_model_state_dict_path`); without that checkpoint a
        soft likelihood is derived from each frame, polarity-oriented by
        the weak labels (low values on the fg side, what the
        weak-label-trained UNet outputs)."""
        t = len(self.dataset)
        h, w = self.shape
        un = np.zeros((t, h * w, 1), np.float32)
        for i in range(t):
            frame = self.dataset.load_frame(i)
            g = frame.mean(-1).reshape(-1)
            g = (g - g.min()) / max(g.max() - g.min(), 1e-9)
            s = self.dataset.sample(i)
            lab = s["labeled"].reshape(-1)
            tgt = s["unaries"].reshape(-1)
            fg = lab & (tgt < 0.5)
            bg = lab & (tgt >= 0.5)
            if fg.any() and bg.any() and g[fg].mean() > g[bg].mean():
                g = 1.0 - g
            un[i, :, 0] = g
        return un

    def _frame_noise_targets(self):
        """Dense unaries with the noisy-st family's frame-level noise:
        ``round(T * pct)`` MIDDLE frames (first/last exempt: they prefit
        the convex net) get their unaries replaced by fixed draws of
        clamp(N(0.5, 1), 0, 1)
        (`awesome/model/noisy_path_connected_net.py:178-230`)."""
        un = self._dense_unaries()
        t = un.shape[0]
        pct = float(self.config.frame_noise_percentage or 0.0)
        rng = np.random.default_rng(self.config.noise_seed)
        middle = np.arange(1, max(t - 1, 1))
        k = min(int(round(t * pct)), len(middle))
        if k > 0:
            for i in rng.choice(middle, size=k, replace=False):
                un[i, :, 0] = np.clip(
                    rng.normal(0.5, 1.0, un.shape[1]), 0.0, 1.0)
        labeled = np.ones((t, un.shape[1]), bool)
        return un, labeled

    def _mesh(self):
        """The config's device mesh (built once; None = one device)."""
        if not hasattr(self, "_mesh_cache"):
            from awesome_tpu_torch.parallel.mesh import mesh_from_config

            self._mesh_cache = mesh_from_config(self.config, self.device)
        return self._mesh_cache

    @property
    def is_root(self) -> bool:
        """Whether this process writes files: no mesh, or its rank 0."""
        mesh = self._mesh()
        return mesh is None or mesh.is_root

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def pretrain(self) -> Dict:
        from awesome_tpu_torch.fit.prior_fit import FitConfig
        from awesome_tpu_torch.fit.spatiotemporal import (
            fit_spatiotemporal_prior,
            sequence_points,
        )

        cfg = self.config
        if cfg.frame_noise_percentage is not None:
            # noisy-st family: dense unaries with frame-level garbage
            targets, labeled = self._frame_noise_targets()
        else:
            targets, labeled = self._collect()
        points = sequence_points(self.shape, len(self.dataset),
                                 device=self.device)
        # honor the YAML's pretrain_args warm-start prefits (flow ~
        # identity + convex on first/last frames; the noisy-st family
        # declares both, `noisy_path_connected_net.py:38-160`)
        pa = dict(getattr(self.awesome_config, "pretrain_args", None) or {}
                  ) if self.awesome_config is not None else {}
        if pa.get("prefit_flow_net_identity") or pa.get("prefit_convex_net"):
            from awesome_tpu_torch.nn.noisy_path_connected import (
                apply_prefits,
            )

            # the reference prefits the convex net against DENSE unaries
            # of frames 0/-1 (`noisy_path_connected_net.py:140-160`); in
            # the trajectory weak-label branch `targets` is mostly
            # background FILL (weight 0 in the fit), which would collapse
            # the prefit toward all-bg: always anchor on dense unaries
            prefit_targets = (
                targets if cfg.frame_noise_percentage is not None
                else self._dense_unaries()
            )
            self.params = apply_prefits(
                self.model, self.params, points,
                self._tensor(prefit_targets), pa)
        fit_cfg = FitConfig(
            num_steps=cfg.num_epochs, lr=cfg.lr, weight_mode=cfg.weight_mode
        )
        self.params, aux = fit_spatiotemporal_prior(
            self.model,
            self.params,
            points,
            self._tensor(targets),
            self._tensor(labeled),
            fit_cfg,
            num_epochs=cfg.num_epochs,
            mesh=self._mesh(),  # each frame's points over 'grid'
        )
        return {
            "epoch_loss": aux["epoch_loss"].cpu().numpy(),
            "lr_scale": float(aux["lr_scale"]),
        }

    def save_results(
        self, metrics: Optional[Dict[str, float]] = None
    ) -> str:
        """Persist a pretrain-only run in the ResultModel on-disk layout
        (config.yaml + tracker.json + params.npz), file for file as the
        JAX runner writes it, so FBMS runs are scannable by the analytics
        layer (`awesome/analytics/result_model.py:668`)."""
        from awesome_tpu_torch.fit.tracker import Tracker
        from awesome_tpu_torch.runner.runner import persist_run

        acfg = self.awesome_config
        if acfg is None:
            raise ValueError("built without from_awesome_config")
        out = self._out_dir()
        tracker = Tracker()
        for k, v in (metrics or self.evaluate()).items():
            tracker.epoch_metric(k, v, "eval")
        tracker.tick_epoch()
        if not self.is_root:
            return out
        return persist_run(out, acfg, tracker, self.params,
                           {k: 0 for k in self.params})

    def save_joint_results(self, out: Optional[str] = None) -> str:
        """Persist a finished JOINT run (config.yaml + the joint tracker's
        full eval-curve series + joint params) in the ResultModel layout:
        what the reference's run dirs carry into
        `notebooks/fbms_eval_icml.ipynb` (ResultModel.from_path)."""
        from awesome_tpu_torch.runner.runner import persist_run

        acfg = self.awesome_config
        if acfg is None:
            raise ValueError("built without from_awesome_config")
        if getattr(self, "joint_tracker", None) is None:
            raise ValueError("no joint training has run")
        out = out or self._out_dir()
        if not self.is_root:
            return out
        state = self.joint_state
        # multi-object priors carry (frame, slot) axes
        prior_axes = 2 if isinstance(state, MultiObjectTrainState) else 1
        return persist_run(
            out, acfg, self.joint_tracker,
            {"seg": state.seg_params, "prior": state.prior_params},
            {"seg": 0, "prior": prior_axes},
        )

    def evaluate(self) -> Dict[str, float]:
        from awesome_tpu_torch.fit.spatiotemporal import sequence_points
        from awesome_tpu_torch.measures.metrics import iou_np

        points = sequence_points(self.shape, len(self.dataset),
                                 device=self.device)
        indices, gts = [], []
        for idx in self.dataset.get_ground_truth_indices():
            gt = self.dataset.load_ground_truth(idx)
            if gt is not None:
                indices.append(idx)
                gts.append(gt)
        ious: List[float] = []
        if indices:
            with torch.no_grad():
                probs = torch.stack([
                    torch.sigmoid(self.model.apply(self.params, points[i]))
                    for i in indices]).cpu().numpy()
            for k, gt in enumerate(gts):
                prob = probs[k].reshape(self.shape)
                ious.append(  # fg = 0 on both sides; host numpy metric
                    iou_np(prob < 0.5, np.asarray(gt) < 0.5)
                )
        return {
            "MeanForegroundBinaryMIOU": float(np.mean(ious)) if ious else 0.0,
            "num_gt_frames": len(ious),
        }

    # --- joint UNet + per-frame prior training ---------------------------
    def _joint_prior_model(self):
        """The joint mode's per-frame 2-channel (x, y) prior (the (x, y, t)
        shared prior is the spatio-temporal mode; reference joint configs
        use channels: 2)."""
        from awesome_tpu_torch.nn.path_connected import (
            real_nvp_path_connected_net,
        )

        c = self.config
        return real_nvp_path_connected_net(
            channels=2,
            hidden_units=c.prior_hidden_units,
            flow_n_flows=c.prior_flows,
            flow_output_fn="tanh",
            spatial_shape=self.shape,
            convex_net_hidden_units=c.convex_hidden_units,
            convex_net_hidden_layers=c.convex_hidden_layers,
            device=self.device,
        )

    def _joint_frame_targets(self) -> np.ndarray:
        """Dense (T, H, W, 1) weak-unary targets (unlabeled -> bg)."""
        t = len(self.dataset)
        h, w = self.shape
        targets = np.ones((t, h, w, 1), np.float32)
        for i in range(t):
            s = self.dataset.sample(i)
            targets[i, :, :, 0] = np.where(s["labeled"], s["unaries"], 1.0)
        return targets

    def _grid(self) -> torch.Tensor:
        """(H*W, 2) pixel grid of the sequence's frames."""
        return G.flatten_grid(G.pixel_grid(self.shape, device=self.device))

    def _frames_and_features(self, indices):
        """(K, H, W, 3) frames and (K, H, W, 1) edge features, host side."""
        from awesome_tpu_torch.data.image_sample import edge_map

        images = np.stack(
            [self.dataset.load_frame(i) for i in indices]
        ).astype(np.float32)
        feats = np.stack(
            [edge_map(img)[..., None] for img in images]
        ).astype(np.float32)
        return images, feats

    def pretrain_joint_priors(
        self,
        num_steps: int = 2000,
        reuse_state_steps: int = 400,
        lr: float = 1e-3,
        flow_weight_decay: float = 1e-5,
        seed: int = 0,
        fused: Optional[bool] = None,
        prefit_flow_identity: bool = False,
        prefit_flow_identity_steps: int = 100,
        prefit_flow_identity_lr: float = 1e-2,
        prefit_convex: bool = False,
        prefit_convex_steps: int = 200,
        prefit_convex_lr: float = 1e-3,
        zoo=None,
    ) -> Dict:
        """The reference's per-image prior pretrain BEFORE joint training
        (`agent/torch_agent.py:553-607` + `path_connected_net.py:730-1008`
        reuse_state semantics: cold fit on frame 0, warm-start fits on the
        rest) through ``fit_priors_sequential``. ``fused=None`` means
        ``fused`` exactly when the runner's device is CUDA: then every
        step is one launch of the fused flagship kernel. The result seeds
        ``train_joint`` (``joint_prior_init``).

        ``prefit_flow_identity`` / ``prefit_convex``: the reference's
        warm-start prefits (flow ~ identity on the grid, Zoo-cached; ICNN
        on the circle approximation of frame 0's unaries),
        `path_connected_net.py:155-390`.
        """
        from awesome_tpu_torch.fit.prior_fit import (
            FitConfig,
            apply_prefits,
            fit_priors_sequential,
        )

        if fused is None:
            fused = self.device.type == "cuda"
        model = self._joint_prior_model()
        params = model.init(self._gen(seed))
        pts = self._grid()
        frame_targets = self._joint_frame_targets()
        params = apply_prefits(
            model, params, pts,
            prefit_flow_identity=prefit_flow_identity,
            flow_identity_lr=prefit_flow_identity_lr,
            flow_identity_steps=prefit_flow_identity_steps,
            prefit_convex=prefit_convex,
            convex_mode="circle",
            convex_target=self._tensor(frame_targets[0].reshape(-1, 1))
            if prefit_convex else None,
            grid_shape=self.shape,
            convex_lr=prefit_convex_lr,
            convex_steps=prefit_convex_steps,
            zoo=zoo,
            zoo_key=f"flow_identity_{self.shape}_{seed}",
        )
        targets = self._tensor(frame_targets.reshape(len(self.dataset), -1,
                                                     1))
        cfg = FitConfig(num_steps=num_steps, lr=lr, fused=fused,
                        flow_weight_decay=flow_weight_decay,
                        nan_guard_grads=False)
        warm = dataclasses.replace(cfg, num_steps=reuse_state_steps)
        stacked, aux = fit_priors_sequential(model, params, pts, targets,
                                             cfg, warm_cfg=warm)
        self.joint_prior_init = stacked
        return {"cold_loss": float(aux["first_aux"]["loss_hist"][-1])}

    def evaluate_joint(self, compute_crf: bool = False) -> Dict[str, float]:
        """Seg + prior IoU + pixel accuracy of the trained joint model on
        GT frames; ``compute_crf`` adds the CRF-refined seg metrics (the
        `eval/epoch/MeanCRF*` columns of `notebooks/fbms_eval_icml.ipynb`),
        one batched CRF call over the GT frames. Spec:
        `run/handles.py:339-477` get_compute_eval_metrics for the joint
        pipeline. The GT frames, their features and GT masks stay on the
        device between calls (the in-training cadence calls this every nth
        epoch)."""
        from awesome_tpu_torch.measures.metrics import iou, pixel_accuracy

        state = self.joint_state
        wrapper = self.joint_wrapper
        cache = getattr(self, "_eval_joint_cache", None)
        if cache is None or cache["wrapper"] is not wrapper:
            indices, gts = [], []
            for idx in self.dataset.get_ground_truth_indices():
                gt = self.dataset.load_ground_truth(idx)
                if gt is not None:
                    indices.append(idx)
                    gts.append(gt)
            imgs, fts = (self._frames_and_features(indices) if indices
                         else (None, None))
            cache = {
                "wrapper": wrapper, "grid": self._grid(), "idx": indices,
                "imgs": None if imgs is None else self._tensor(imgs),
                "fts": None if fts is None else self._tensor(fts),
                "gts": self._tensor(np.stack(gts).astype(np.float32))
                if gts else None,
            }
            self._eval_joint_cache = cache
        seg_ious = prior_ious = accs = prior_accs = []
        crf_ious, crf_accs = [], []
        if cache["idx"]:
            rows, bg_probs = [], []
            with torch.no_grad():
                for k, frame_idx in enumerate(cache["idx"]):
                    params = {"seg": state.seg_params}
                    if wrapper.prior_module is not None:
                        params["prior"] = T.tree_select(state.prior_params,
                                                        frame_idx)
                    out, _ = wrapper.apply(
                        params, cache["imgs"][k:k + 1],
                        features=cache["fts"][k:k + 1], grid=cache["grid"],
                        seg_state=state.seg_state, train=False)
                    gt = cache["gts"][k]
                    bg_probs.append(out[0, ..., 0])
                    row = []
                    for c in range(out.shape[-1]):
                        prob = out[0, ..., c]
                        row += [iou(prob < 0.5, gt < 0.5),
                                pixel_accuracy(prob, gt)]
                    rows.append(torch.stack(row))
            table = torch.stack(rows).cpu().numpy()  # one host transfer
            seg_ious, accs = table[:, 0], table[:, 1]
            if table.shape[1] > 2:
                prior_ious, prior_accs = table[:, 2], table[:, 3]
            if compute_crf:
                from awesome_tpu_torch.ops.crf import dense_crf_batched

                # the seg output is the BACKGROUND probability (fg = 0)
                refined = self._tensor(dense_crf_batched(
                    cache["imgs"], torch.stack(bg_probs),
                    is_softmax_unaries=True, device=self.device))[..., 0]
                crf = torch.stack([
                    torch.stack([iou(p < 0.5, g < 0.5), pixel_accuracy(p, g)])
                    for p, g in zip(refined, cache["gts"])]).cpu().numpy()
                crf_ious, crf_accs = crf[:, 0], crf[:, 1]
        metrics = {
            "MeanForegroundBinaryMIOU": float(np.mean(seg_ious))
            if len(seg_ious) else 0.0,
            "PriorMeanForegroundBinaryMIOU": float(np.mean(prior_ious))
            if len(prior_ious) else 0.0,
            "MeanPixelAccuracy": float(np.mean(accs)) if len(accs) else 0.0,
            "num_gt_frames": len(seg_ious),
        }
        if len(prior_accs):
            metrics["PriorMeanPixelAccuracy"] = float(np.mean(prior_accs))
        if len(crf_ious):
            metrics["CRFMeanForegroundBinaryMIOU"] = float(np.mean(crf_ious))
            metrics["CRFMeanPixelAccuracy"] = float(np.mean(crf_accs))
        return metrics

    def _run_with_emergency(self, fn, state_attr: str, kwargs: Dict):
        """Emergency-dump wrapper for the joint loops: a thin adapter over
        the shared `fit/checkpoint.py:run_with_emergency` (reference
        `awesome/agent/torch_agent.py:1063` emergency_save)."""
        from awesome_tpu_torch.fit.checkpoint import run_with_emergency

        ckdir = kwargs.get("checkpoint_dir")

        def _state():
            st = getattr(self, state_attr, None)
            return tuple(st) if st is not None else None

        return run_with_emergency(
            lambda: fn(**kwargs),
            os.path.join(ckdir, "emergency") if ckdir and self.is_root
            else None,
            _state,
        )

    def train_joint_multi_object(self, **kwargs) -> Dict:
        """Emergency-dump wrapper around
        :meth:`_train_joint_multi_object_impl` (see its docstring)."""
        return self._run_with_emergency(
            self._train_joint_multi_object_impl, "multi_state", kwargs
        )

    def _train_joint_multi_object_impl(
        self,
        max_objects: int = 2,
        initial_count: Optional[int] = None,
        grow_at_epoch: Optional[Dict[int, int]] = None,
        num_epochs: int = 15,
        lr: float = 1e-4,
        prior_lr: float = 1e-4,
        batch_size: Optional[int] = None,
        seed: int = 0,
        train_segmentation: bool = True,
        alpha: float = 1.0,
        beta: float = 1.0,
        pretrain_steps: int = 0,
        refit_grown_steps: Optional[int] = None,
        pretrain_weight_mode: str = "equal",
        scheduler: Optional[Dict] = None,
        watchdog_lr: Optional[float] = None,
        eval_nth_epoch: Optional[int] = None,
        eval_epoch0: bool = False,
        checkpoint_dir: Optional[str] = None,
        resume: bool = False,  # continue from checkpoint_dir's newest state
        checkpoint_nth_epoch: int = 1,  # 'latest' full-state save cadence
    ) -> Dict:
        """Multi-object joint training: a shared UNet with one output
        channel per object slot + per-frame child priors
        (``nn.multi_prior.MultiPriorModule``), per-object unaries from the
        trajectory weak labels, dynamic growth between epochs.

        ``pretrain_steps`` > 0 first fits every ACTIVE child against its
        object's weak unaries via the batched multi-object engine
        (``fit.prior_fit.fit_multi_object_priors``, the autograd route as
        in the JAX runner); the reference always pretrains children before
        joint training (`multiple_object_aware_path_connected_net.py:68-370`).

        ``grow_at_epoch``: {epoch_index: new_count} growth events: fresh
        child slots + zeroed optimizer moments, the reference's dynamic
        prior->optimizer sync (`awesome/run/awesome_runner.py:460-490`);
        grown slots are refitted against their object's unaries for
        ``refit_grown_steps`` (defaults to ``pretrain_steps``).
        """
        from awesome_tpu_torch.fit.prior_fit import (
            FitConfig,
            fit_multi_object_priors,
        )
        from awesome_tpu_torch.fit.tracker import Tracker
        from awesome_tpu_torch.fit.trainer import (
            JointTrainConfig,
            assure_multi_prior_count,
            epoch_batches,
            make_multi_object_epoch_fn,
        )
        from awesome_tpu_torch.nn.multi_prior import MultiPriorModule
        from awesome_tpu_torch.nn.seg import UNet
        from awesome_tpu_torch.nn.wrapper import WrapperModule

        t = len(self.dataset)
        h, w = self.shape
        images, feats = self._frames_and_features(range(t))
        target_obj = np.ones((t, h, w, max_objects), np.float32)
        labeled = np.zeros((t, h, w), bool)
        for i in range(t):
            s = self.dataset.sample_multi(i, max_objects=max_objects)
            target_obj[i] = np.moveaxis(s["object_unaries"], 0, -1)
            labeled[i] = s["labeled"]

        mp = MultiPriorModule(
            child=self._joint_prior_model(), max_priors=max_objects
        )
        wrapper = WrapperModule(
            segmentation_module=UNet(in_chn=4, out_chn=max_objects,
                                     device=self.device),
            prior_module=mp,
            input_mode="image",
            prior_arg_mode="param_clean_grid",
            seg_stateful=True,
        )
        cfg = JointTrainConfig(
            lr=lr, prior_lr=prior_lr, alpha=alpha, beta=beta,
            train_segmentation=train_segmentation,
        )
        state = multi_object_train_init(
            wrapper, self._gen(seed), t, cfg,
            initial_count=initial_count or max_objects,
        )
        grid_pts = self._grid()
        # per-object point targets for the child fits: unlabeled -> bg
        obj_pt_targets = self._tensor(
            np.where(
                labeled[:, None], np.moveaxis(target_obj, -1, 1), 1.0
            ).reshape(t, max_objects, h * w, 1).astype(np.float32)
        )

        def fit_children(state, steps, slots_mask):
            """Fit the masked (frame, slot) children against their
            object's unaries; optimizer moments stay zeroed (the joint
            optimizer is created fresh after pretrain)."""
            # 'equal' class weights: the per-object targets are SPARSE
            # trajectory points (a few % fg), unlike the reference's dense
            # seg unaries; unweighted SE would collapse to all-bg
            # (UnariesWeightedLoss mode knob,
            # `awesome/measures/unaries_weighted_loss.py:34`)
            fitted, _ = fit_multi_object_priors(
                mp.child,
                state.prior_params["children"],
                grid_pts,
                obj_pt_targets,
                FitConfig(num_steps=steps, lr=1e-3,
                          weight_mode=pretrain_weight_mode,
                          nan_guard_grads=False),
                valid_mask=slots_mask,
            )
            return state._replace(
                prior_params=dict(state.prior_params, children=fitted)
            )

        tracker = Tracker(
            primary_metric="MeanForegroundBinaryMIOU"
            if eval_nth_epoch else "Loss",
            primary_mode="eval" if eval_nth_epoch else "train",
            maximize_primary=bool(eval_nth_epoch),
        )
        # multi-object runs feed the SAME tracker slot the single-object
        # joint path uses, so save_joint_results / analytics read either
        self.joint_tracker = tracker
        self.joint_wrapper = wrapper
        self.best_multi_state = None
        sched = _EpochLrSchedule(scheduler)
        # resume BEFORE the child pretrain: a restored state already holds
        # the post-pretrain children, moments, and the active mask
        # (max_priors keeps the tree's shapes fixed through growth, so the
        # freshly-built state is a valid restore template at ANY epoch)
        start_epoch = 0
        resumed_stopped = False
        if resume and checkpoint_dir:
            resumed = self._try_resume_joint(
                checkpoint_dir, state, sched, num_epochs,
                kind="multi", best_attr="best_multi_state",
            )
            if resumed is not None:
                state, start_epoch, rex = resumed
                tracker = self.joint_tracker
                resumed_stopped = bool(rex.get("stopped_early"))
        if pretrain_steps and start_epoch == 0:
            state = fit_children(state, pretrain_steps, state.active)
        epoch_fn = make_multi_object_epoch_fn(wrapper, cfg,
                                              mesh=self._mesh())

        def record_eval(epoch: int, st) -> None:
            """Per-object eval flattened into tracker series (series
            indexed by TRAINING epoch, like the single-object path)."""
            self.multi_state = st
            self.multi_wrapper = wrapper
            self.joint_state = self.multi_state
            ev = self.evaluate_multi_object()
            prior_per = ev["prior_iou_per_object"]
            seg_per = ev["seg_iou_per_object"]
            tracker.epoch = epoch
            if seg_per:
                tracker.epoch_metric(
                    "MeanForegroundBinaryMIOU",
                    float(np.mean(list(seg_per.values()))), "eval")
            if prior_per:
                tracker.epoch_metric(
                    "PriorMeanForegroundBinaryMIOU",
                    float(np.mean(list(prior_per.values()))), "eval")
            for oid, v in sorted(prior_per.items()):
                tracker.epoch_metric(f"PriorIoU/obj{oid}", v, "eval")
            for oid, v in sorted(seg_per.items()):
                tracker.epoch_metric(f"SegIoU/obj{oid}", v, "eval")
            if tracker.is_current_state_best_model():
                self.best_multi_state = st
                if checkpoint_dir:
                    self._save_joint_checkpoint(
                        st, checkpoint_dir, "best", epoch=epoch,
                        sched=sched, kind="multi",
                    )

        if eval_epoch0 and start_epoch == 0:
            record_eval(0, state)
        data = {
            "image": self._tensor(images),
            "features": self._tensor(feats),
            "grid": grid_pts,
            "target_obj": self._tensor(target_obj),
            "labeled": self._tensor(labeled),
        }
        rng = np.random.default_rng(seed)
        bs = min(batch_size or 1, t)
        # fast-forward the batch-plan stream past the already-trained
        # epochs so the resumed trajectory consumes the SAME permutations
        # an uninterrupted run would (bitwise resume)
        for _ in range(start_epoch):
            epoch_batches(t, bs, rng)
        lr_scale = sched.scale
        stopped_early = resumed_stopped  # a stopped run never trains more
        completed = start_epoch
        losses = []
        growth_events = []
        for e in range(start_epoch, num_epochs):
            if stopped_early:
                break
            if grow_at_epoch and e in grow_at_epoch:
                new_count = int(grow_at_epoch[e])
                prev_active = state.active
                state = assure_multi_prior_count(
                    wrapper, state, cfg, new_count, seed + 1000 + e)
                refit = (refit_grown_steps if refit_grown_steps is not None
                         else pretrain_steps)
                if refit:
                    fresh_slots = state.active & ~prev_active
                    state = fit_children(state, refit, fresh_slots)
                growth_events.append((e, new_count))
                # keep the emergency dump current: a crash later in this
                # epoch must capture the GROWN state, not the pre-growth
                self.multi_state = state
            idx_mat, wgt_mat = epoch_batches(t, bs, rng)
            state, metrics = epoch_fn(state, data, idx_mat, wgt_mat,
                                      lr_scale)
            losses.append(metrics["loss"])
            self.multi_state = state  # newest state for the emergency dump
            completed = e + 1
            lr_scale = sched.update(
                e, _mean_loss(metrics) if sched.needs_loss else None)
            watchdog_fired = watchdog_lr is not None and (
                min(lr, prior_lr) * lr_scale <= watchdog_lr
            )
            if eval_nth_epoch and ((e + 1) % eval_nth_epoch == 0
                                   or e + 1 == num_epochs
                                   or watchdog_fired):
                tracker.epoch = e + 1
                tracker.epoch_metric("Loss", _mean_loss(metrics), "train")
                record_eval(e + 1, state)
            if checkpoint_dir and checkpoint_nth_epoch and (
                (e + 1) % checkpoint_nth_epoch == 0
            ):
                # resumable preemption point (post-sched-update, like the
                # single-object path; growth replays only at e >= resume)
                self._save_joint_checkpoint(
                    state, checkpoint_dir, "latest", epoch=e + 1,
                    sched=sched, kind="multi",
                    stopped_early=watchdog_fired,
                )
            if watchdog_fired:
                logger.info("LR watchdog stop at epoch %d", e + 1)
                stopped_early = True
                break
        self.multi_state = state
        self.multi_wrapper = wrapper
        self.joint_state = self.multi_state
        if self.best_multi_state is None:
            self.best_multi_state = self.multi_state
        if checkpoint_dir:
            self._save_joint_checkpoint(
                state, checkpoint_dir, "end", epoch=completed,
                sched=sched, kind="multi", stopped_early=stopped_early,
            )
        return {
            "loss": [float(v) for m in losses
                     for v in m.cpu().numpy().ravel()],
            "growth_events": growth_events,
            "stopped_early": stopped_early,
        }

    def evaluate_multi_object(self) -> Dict[str, Any]:
        """Per-object IoU of the trained multi-object model on GT frames:
        prior channel k scored against the GT region its weak-label object
        maps to (`fbms_sequence_dataset.py:518-554` id mapping)."""
        from awesome_tpu_torch.data.fbms import weak_label_id_gt_mapping
        from awesome_tpu_torch.measures.metrics import iou_np

        state = self.multi_state
        wrapper = self.multi_wrapper
        mp = wrapper.prior_module
        h, w = self.shape
        grid = self._grid()
        per_object: Dict[int, List[float]] = {}
        seg_per_object: Dict[int, List[float]] = {}
        for idx in self.dataset.get_ground_truth_indices():
            gtc, gt_ids = self.dataset.load_ground_truth_channels(idx)
            if gtc.size == 0:
                continue
            mapping = weak_label_id_gt_mapping(
                self.dataset.object_id_mapping(idx)
            )
            s = self.dataset.sample_multi(idx, max_objects=mp.max_priors)
            img, ft = self._frames_and_features([idx])
            children = T.tree_map(lambda x: x[idx],
                                  state.prior_params["children"])
            with torch.no_grad():
                seg_logits, _ = wrapper.segmentation_module.apply(
                    state.seg_params, state.seg_state, self._tensor(img),
                    self._tensor(ft), train=False)
                seg = wrapper.process_segmentation_output(
                    seg_logits).cpu().numpy()[0]
                prior = wrapper.process_prior_output(
                    mp.apply({"children": children}, grid)
                ).cpu().numpy().reshape(h, w, -1)
            active = state.active[idx].cpu().numpy()
            gt_by_id = {int(g): gtc[j] for j, g in enumerate(gt_ids)}
            for k, oid in enumerate(s["object_ids"]):
                if oid < 0 or not active[k]:
                    continue
                gt_id = mapping.get(int(oid))
                if gt_id is None or gt_id == 0 or gt_id not in gt_by_id:
                    continue
                gt_mask = gt_by_id[gt_id]
                per_object.setdefault(int(oid), []).append(iou_np(
                    prior[..., k] < 0.5, gt_mask
                ))
                seg_per_object.setdefault(int(oid), []).append(iou_np(
                    seg[..., k] < 0.5, gt_mask
                ))
        return {
            "prior_iou_per_object": {
                k: float(np.mean(v)) for k, v in per_object.items()
            },
            "seg_iou_per_object": {
                k: float(np.mean(v)) for k, v in seg_per_object.items()
            },
        }

    def train_joint(self, **kwargs) -> Dict:
        """Emergency-dump wrapper around :meth:`_train_joint_impl`
        (see its docstring for the full contract)."""
        return self._run_with_emergency(
            self._train_joint_impl, "joint_state", kwargs
        )

    def _train_joint_impl(
        self,
        num_epochs: int = 15,
        lr: float = 1e-4,
        prior_lr: float = 1e-4,
        batch_size: Optional[int] = None,  # None -> dataset BatchSettings
        seed: int = 0,
        train_segmentation: bool = True,
        alpha: float = 1.0,
        beta: float = 1.0,
        use_segmentation_output_inversion: bool = False,
        use_prior: bool = True,
        compute_dtype: Optional[str] = None,  # 'bfloat16' convs
        eval_nth_epoch: Optional[int] = None,  # in-training eval cadence
        checkpoint_dir: Optional[str] = None,
        scheduler: Optional[Dict] = None,  # {'type': 'step'|'plateau', ...}
        watchdog_lr: Optional[float] = None,  # stop when lr decays to this
        plot_indices: Optional[List[int]] = None,  # frames to dump
        plot_nth_epoch: int = 100,
        plot_dir: Optional[str] = None,
        eval_epoch0: bool = False,  # record the pre-training baseline eval
        eval_crf: bool = False,  # CRF-refined metrics at each eval tick
        resume: bool = False,  # continue from checkpoint_dir's newest state
        checkpoint_nth_epoch: int = 1,  # 'latest' full-state save cadence
    ) -> Dict:
        """The run_fbms_unet_joint experiment: shared UNet segmenting each
        frame (image + edge features), per-frame priors aligned via the
        soft-clipped FBMS joint loss, both trained in one step
        (``fit/trainer.py``).

        Each epoch runs the permuted batch plan (tail batch padded at
        weight 0, so every image trains every epoch); metrics come to the
        host once per epoch, not per step as the reference does
        (`awesome/agent/torch_agent.py:501`).

        ``eval_nth_epoch``: the reference's in-training metric cadence
        (``compute_metrics_during_training_nth_epoch``,
        `run/handles.py:339-477`): GT-frame seg/prior IoU at every nth
        epoch, logged into ``self.joint_tracker`` with best-model capture
        (``self.best_joint_state``). ``checkpoint_dir`` additionally saves
        best/latest/end checkpoints; ``resume`` continues bitwise from the
        newest resumable one.

        Spec: `config/path-connectedness/joint/UNET+...+joint.yaml`
        (15 epochs, lr 1e-4) and `awesome/agent/torch_agent.py:183-527`
        epoch/step loops.
        """
        from awesome_tpu_torch.fit.tracker import Tracker
        from awesome_tpu_torch.fit.trainer import (
            JointTrainConfig,
            epoch_batches,
            make_joint_epoch_fn,
        )
        from awesome_tpu_torch.nn.seg import UNet
        from awesome_tpu_torch.nn.wrapper import WrapperModule

        t = len(self.dataset)
        images, feats = self._frames_and_features(range(t))
        targets = self._joint_frame_targets()

        joint_prior = self._joint_prior_model() if use_prior else None
        wrapper = WrapperModule(
            segmentation_module=UNet(in_chn=4, out_chn=1,
                                     compute_dtype=compute_dtype,
                                     device=self.device),
            prior_module=joint_prior,
            input_mode="image",
            prior_arg_mode="param_clean_grid",
            seg_stateful=True,
            use_segmentation_output_inversion=(
                use_segmentation_output_inversion
            ),
        )
        cfg = JointTrainConfig(
            lr=lr, prior_lr=prior_lr,
            alpha=alpha, beta=beta,
            train_segmentation=train_segmentation,
        )
        state = joint_train_init(
            wrapper, self._gen(seed), t, cfg,
            prior_init=getattr(self, "joint_prior_init", None),
        )
        tracker = Tracker(
            primary_metric="MeanForegroundBinaryMIOU"
            if eval_nth_epoch else "Loss",
            primary_mode="eval" if eval_nth_epoch else "train",
            maximize_primary=bool(eval_nth_epoch),
        )
        self.joint_tracker = tracker
        self.best_joint_state = None
        # epoch-level LR scheduling on the host (the reference steps its
        # schedulers via epoch events, `awesome_runner.py:465-475`); the
        # scale reaches the step as a plain scalar
        sched = _EpochLrSchedule(scheduler)
        # auto-resume: the freshly-built state is the restore template
        start_epoch = 0
        resumed_stopped = False
        if resume and checkpoint_dir:
            resumed = self._try_resume_joint(
                checkpoint_dir, state, sched, num_epochs
            )
            if resumed is not None:
                state, start_epoch, rex = resumed
                tracker = self.joint_tracker
                resumed_stopped = bool(rex.get("stopped_early"))
        # on a mesh: each batch's frames over 'data', points over 'grid'
        epoch_fn = make_joint_epoch_fn(wrapper, cfg, mesh=self._mesh())

        data = {
            "image": self._tensor(images),
            "features": self._tensor(feats),
            "grid": self._grid(),
            "target": self._tensor(targets),
        }
        rng = np.random.default_rng(seed)
        if batch_size is None:
            from awesome_tpu_torch.data.batching import BatchSettings

            batch_size = BatchSettings.of(self.dataset).training_batch_size
        bs = min(batch_size, t)
        # fast-forward the batch-plan stream past the already-trained
        # epochs so the resumed trajectory consumes the SAME permutations
        # an uninterrupted run would (bitwise resume)
        for _ in range(start_epoch):
            epoch_batches(t, bs, rng)
        lr_scale = sched.scale
        stopped_early = resumed_stopped  # a stopped run never trains more
        completed = start_epoch
        epoch_metrics = []
        if eval_epoch0 and start_epoch == 0:
            # epoch-0 "Baseline" row of the paper's Sequential-vs-Joint
            # table: the pretrained priors + untrained UNet, evaluated
            # BEFORE any joint update (`notebooks/fbms_eval_icml.ipynb`
            # index_mapping {0: Baseline, 15: Joint})
            self.joint_state = state
            self.joint_wrapper = wrapper
            tracker.epoch = 0  # series indexed by TRAINING epoch
            for k, v in self.evaluate_joint(compute_crf=eval_crf).items():
                if isinstance(v, float):
                    tracker.epoch_metric(k, v, "eval")
            # the untrained baseline competes for 'best' like any eval
            # tick: otherwise selection='best' could report the baseline
            # value while the saved best checkpoint is a different state
            if eval_nth_epoch and tracker.is_current_state_best_model():
                self.best_joint_state = state
                if checkpoint_dir:
                    self._save_joint_checkpoint(state, checkpoint_dir,
                                                "best", epoch=0,
                                                sched=sched)
        for e in range(start_epoch, num_epochs):
            if stopped_early:
                break
            idx_mat, wgt_mat = epoch_batches(t, bs, rng)
            state, metrics = epoch_fn(state, data, idx_mat, wgt_mat,
                                      lr_scale)
            epoch_metrics.append(metrics)  # device tensors; no sync here
            # keep the newest state reachable for the emergency dump
            self.joint_state = state
            completed = e + 1
            lr_scale = sched.update(
                e, _mean_loss(metrics) if sched.needs_loss else None)
            watchdog_fired = watchdog_lr is not None and (
                min(lr, prior_lr) * lr_scale <= watchdog_lr
            )
            if eval_nth_epoch and ((e + 1) % eval_nth_epoch == 0
                                   or e + 1 == num_epochs
                                   or watchdog_fired):
                self.joint_wrapper = wrapper
                tracker.epoch = e + 1  # true training epoch, not the
                # tick count: metric_at_epoch / the notebook's
                # index_mapping {0: Baseline, 15: Joint} index by epoch
                tracker.epoch_metric("Loss", _mean_loss(metrics), "train")
                for k, v in self.evaluate_joint(
                        compute_crf=eval_crf).items():
                    if isinstance(v, float):
                        tracker.epoch_metric(k, v, "eval")
                if tracker.is_current_state_best_model():
                    self.best_joint_state = state
                    if checkpoint_dir:
                        self._save_joint_checkpoint(
                            state, checkpoint_dir, "best",
                            epoch=e + 1, sched=sched,
                        )
            if plot_indices and plot_dir and (
                (e + 1) % plot_nth_epoch == 0 or e + 1 == num_epochs
            ):
                # periodic qualitative dumps of selected frames
                # (`awesome/run/awesome_runner.py:304-333` _save_image)
                self.joint_wrapper = wrapper
                self._dump_joint_frames(plot_indices, plot_dir, e + 1)
            if checkpoint_dir and checkpoint_nth_epoch and (
                (e + 1) % checkpoint_nth_epoch == 0
            ):
                # resumable preemption point: full state + tracker +
                # schedule; the SAVE happens after the epoch's sched
                # update so sched.scale restores as the next epoch's scale
                self._save_joint_checkpoint(
                    state, checkpoint_dir, "latest", epoch=e + 1,
                    sched=sched, stopped_early=watchdog_fired,
                )
            if watchdog_fired:
                # LearningRateStopTrainingWatchdog: StopTraining once the
                # LR has decayed to the floor, AFTER the stopping epoch
                # has been evaluated / best-model-considered
                # (`event/watchdogs/learning_rate_stop_training_watchdog.py:64`)
                logger.info("LR watchdog stop at epoch %d", e + 1)
                stopped_early = True
                break
        self.joint_state = state
        self.joint_wrapper = wrapper
        if self.best_joint_state is None:
            self.best_joint_state = self.joint_state
        if checkpoint_dir:
            self._save_joint_checkpoint(
                state, checkpoint_dir, "end", epoch=completed,
                sched=sched, stopped_early=stopped_early,
            )
        # single host transfer for the whole history
        losses = [
            float(v)
            for m in epoch_metrics
            for v in m["loss"].cpu().numpy().ravel()
        ]
        return {"loss": losses, "stopped_early": stopped_early,
                "final_lr_scale": lr_scale}

    def _dump_joint_frames(self, indices, out_dir: str, epoch: int):
        """Write seg/prior masks + overlays for selected frames during
        joint training (`awesome/run/awesome_runner.py:304-333`)."""
        from awesome_tpu_torch.runner.functions import save_result

        if not self.is_root:
            return
        state = self.joint_state
        wrapper = self.joint_wrapper
        grid = self._grid()
        for idx in indices:
            if idx >= len(self.dataset):
                continue
            img, ft = self._frames_and_features([idx])
            params = {"seg": state.seg_params}
            if wrapper.prior_module is not None:
                params["prior"] = T.tree_select(state.prior_params, idx)
            with torch.no_grad():
                out, _ = wrapper.apply(
                    params, self._tensor(img), features=self._tensor(ft),
                    grid=grid, seg_state=state.seg_state, train=False)
            out = out[0].cpu().numpy()
            save_result(
                os.path.join(out_dir, f"{idx:03d}", f"e{epoch:05d}"),
                idx,
                img[0],
                out[:, :, 0] < 0.5,  # fg = low values
                prior_mask=(out[:, :, 1] < 0.5) if out.shape[-1] > 1
                else None,
            )

    def _save_joint_checkpoint(self, state, directory: str, tag: str,
                               epoch: Optional[int] = None,
                               sched: Optional[_EpochLrSchedule] = None,
                               kind: str = "joint",
                               stopped_early: bool = False):
        """Agent-checkpoint save of the joint state (params + tracker).
        Spec: `awesome/run/handles.py:195-232` save handles.

        When ``epoch`` is given, the FULL train state (seg/prior params,
        both optimizers' moments, seg batch-norm state) and the host
        schedule state ride along, making the checkpoint RESUMABLE
        (``train_joint(resume=True)``). On a mesh only rank 0 writes."""
        from awesome_tpu_torch.fit.checkpoint import (
            AgentCheckpoint,
            atomic_dir,
            save_pytree,
        )

        if not self.is_root:
            return
        extra = {}
        if epoch is not None:
            extra["epoch"] = int(epoch)
            extra["state_kind"] = kind
            extra["stopped_early"] = bool(stopped_early)
            if sched is not None:
                extra["sched"] = sched.state_dict()
        d = os.path.join(directory, tag)
        # atomic swap: preemption mid-save keeps the previous complete
        # checkpoint (tag or .old twin) instead of tearing this one
        with atomic_dir(d) as tmp:
            AgentCheckpoint(
                name=f"fbms_joint_{tag}",
                params={
                    "seg": state.seg_params,
                    "prior": state.prior_params,
                },
                tracker=self.joint_tracker.to_dict()
                if getattr(self, "joint_tracker", None) else {},
                config={},
                extra=extra,
            ).save(tmp)
            if epoch is not None:
                save_pytree(tuple(state), os.path.join(tmp, "train_state"))

    def _try_resume_joint(self, checkpoint_dir: str, template_state,
                          sched: _EpochLrSchedule, num_epochs: int,
                          kind: str = "joint",
                          best_attr: str = "best_joint_state"):
        """Restore the newest resumable joint checkpoint (latest/end,
        incl. their ``.old`` crash-window twins).
        Returns ``(state, start_epoch, extra_meta)`` or ``None``. A thin
        adapter over `fit/checkpoint.py:restore_resumable` adding the
        joint-loop specifics: the host LR-schedule restore and the best
        state rebuilt as the full NamedTuple; the resumed run equals an
        uninterrupted one bitwise."""
        from awesome_tpu_torch.fit.checkpoint import restore_resumable

        res = restore_resumable(checkpoint_dir, kind, template_state,
                                num_epochs)
        if res is None:
            return None
        if res["tracker"] is not None:
            self.joint_tracker = res["tracker"]
        sched.load_state_dict(res["extra"].get("sched") or {})
        if res["best"] is not None:
            setattr(self, best_attr, type(template_state)(*res["best"]))
        return res["state"], res["epoch"], res["extra"]

    def export_tensorboard(self, log_dir: str) -> str:
        """Write the joint tracker's curves as TensorBoard events (real
        event files when the writer is available, JSONL otherwise): the
        reference's Tensorboard adapter role
        (`awesome/util/tensorboard.py:28-122`)."""
        from awesome_tpu_torch.utils.tensorboard import Tensorboard

        tb = Tensorboard(log_dir)
        if getattr(self, "joint_tracker", None):
            tb.attach_to_tracker(self.joint_tracker)
        if self.awesome_config is not None:
            tb.log_config_markdown(self.awesome_config)
        tb.close()
        return log_dir
