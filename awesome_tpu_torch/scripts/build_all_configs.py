"""Build (or reduced-TRAIN) EVERY reference YAML; counterpart of
``scripts/build_all_configs.py``.

Every YAML under ``--config-root`` is imported, its dataset assembled (the
synthetic replica where the real data is absent), its segmentation and
prior models built at the YAML's declared sizes, its stacked per-image
params initialized and its optimizer state built. ``--train`` goes
further: every config TRAINS end to end through the routing of ``python
-m awesome_tpu_torch.run`` (pretrain -> joint train -> eval), with ONLY
the cost knobs shrunk (step/epoch counts; models, losses, data encodings
and schedulers stay at the YAML's settings), asserting finite losses and
in-range metrics per config.

    python -m awesome_tpu_torch.scripts.build_all_configs \\
        [--config-root DIR] [--limit N] [--train] [--stratified] \\
        [--device cuda|cpu]

``--config-root`` defaults to ``reference/config`` inside this
repository (:data:`REFERENCE_CONFIG`), where the reference's experiment
YAMLs are to be added; a missing directory exits nonzero, naming it. Writes a JSON report
(runs/build_all_torch/report.json, or runs/train_all_torch/report.json
with --train) and exits nonzero on any failure.
"""
import argparse
import json
import os
import sys
import tempfile
import time
import traceback

# the reference's experiment YAMLs, kept inside this repository
REFERENCE_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "reference", "config")


def require_dir(path: str) -> str:
    """``path``, or exit nonzero naming it when it is not a directory."""
    if not os.path.isdir(path):
        raise SystemExit(f"reference config directory {path} not found: "
                         "pass --config-root (the reference's experiment "
                         "YAML directory)")
    return path


def write_sequence(root: str, n_frames: int = 5, h: int = 24, w: int = 32,
                   n_fg: int = 12, n_bg: int = 20):
    """Synthetic moving-disk sequence in FBMS on-disk layout, byte for
    byte the JAX script's (uniform-disk fg labels, velocity scaling for
    long replicas); serialization delegates to
    ``awesome_tpu_torch.data.synthetic.write_fbms_layout``."""
    import numpy as np

    from awesome_tpu_torch.data.synthetic import write_fbms_layout

    rng = np.random.default_rng(0)
    # constant total traversal: 3 px/frame for the standard short replicas,
    # scaled down for longer sequences so the disk stays in frame
    vel = min(3.0, 27.0 / max(n_frames - 1, 1))
    trajs = []
    for oid, n_traj in ((1, n_fg), (0, n_bg)):
        for _ in range(n_traj):
            if oid == 1:
                # uniform over the moving disk (center (7, 12), r 6) so
                # the labels cover the full object incl. its boundary
                r = 5.5 * np.sqrt(rng.uniform())
                a = rng.uniform(0, 2 * np.pi)
                x0, y0 = 7 + r * np.cos(a), 12 + r * np.sin(a)
            else:
                x0, y0 = rng.uniform(0, w - 1), rng.uniform(0, h - 1)
            pts = [
                (min(x0 + (vel * f if oid == 1 else 0), w - 1), y0, f)
                for f in range(n_frames)
            ]
            trajs.append((oid, pts))
    yy, xx = np.mgrid[0:h, 0:w]

    def _disk(i):
        return ((yy - 12) ** 2 + (xx - (7 + vel * i)) ** 2) <= 36

    frames = []
    for i in range(n_frames):
        img = np.zeros((h, w, 3), np.uint8) + 30
        img[_disk(i)] = 200
        frames.append(img)
    gt_masks = {
        i: np.where(_disk(i), 255, 0).astype(np.uint8)
        for i in (0, n_frames - 1)
    }
    return write_fbms_layout(root, "cars99", n_frames, trajs, frames,
                             gt_masks)


def _load(path: str, runs_path: str, device: str):
    from awesome_tpu_torch.runner.reference_import import (
        load_reference_config,
    )

    cfg, extra = load_reference_config(path)
    if extra:
        raise RuntimeError(f"unmapped reference fields: {sorted(extra)}")
    cfg.runs_path = runs_path
    cfg.device = device
    return cfg


def _small_replica(cfg) -> None:
    """Keep the synthetic convexity replica small: a breadth sweep, not a
    fit."""
    cfg.dataset_args = dict(cfg.dataset_args or {})
    cfg.dataset_args.setdefault("n", 2)
    cfg.dataset_args.setdefault("h", 24)
    cfg.dataset_args.setdefault("w", 32)


def build_one(path: str, seq_dir: str, runs_path: str,
              device: str = "cuda") -> None:
    from awesome_tpu_torch.run import _is_fbms

    cfg = _load(path, runs_path, device)
    if _is_fbms(cfg):
        from awesome_tpu_torch.runner.fbms_runner import FBMSRunner

        runner = FBMSRunner.from_awesome_config(cfg, dataset_path=seq_dir)
    else:
        from awesome_tpu_torch.runner.runner import AwesomeRunner

        _small_replica(cfg)
        runner = AwesomeRunner(cfg)
    runner.build()
    # the built artifacts a training step would consume
    has_params = (
        getattr(runner, "stacked_params", None) is not None
        or getattr(runner, "params", None) is not None
        or getattr(runner, "state", None) is not None
    )
    if not has_params:
        raise RuntimeError("build() completed without initialized params")


def _shrink_cost_knobs(cfg, runs_path: str, tag: str) -> None:
    """Reduce ONLY step/epoch budgets (the knobs a user would tune for a
    quick run); everything semantic — models, losses, encodings, noise
    levels, schedulers, weight decays — stays at the YAML's values."""
    pa = dict(cfg.pretrain_args or {})
    if pa:
        pa["num_epochs"] = min(int(pa.get("num_epochs", 2000)), 12)
        pa["reuse_state_epochs"] = min(
            int(pa.get("reuse_state_epochs", 400)), 6)
        pa["prefit_flow_net_identity_num_epochs"] = 6
        pa["prefit_convex_net_num_epochs"] = 6
        if isinstance(pa.get("zoo"), dict):
            pa["zoo"] = {"zoo_folder": os.path.join(runs_path, "zoo")}
        cfg.pretrain_args = pa
    if cfg.pretrain_state_path:
        cfg.pretrain_state_path = os.path.join(
            runs_path, "pretrain_state", tag)
    if cfg.num_epochs:
        cfg.num_epochs = min(int(cfg.num_epochs), 2)


def _finite(x, what: str) -> None:
    import numpy as np

    arr = np.asarray(x, dtype=np.float64)
    if not np.isfinite(arr).all():
        raise RuntimeError(f"non-finite {what}: {arr}")


def _metric_range(metrics) -> None:
    for k, v in metrics.items():
        if isinstance(v, (int, float)) and ("IOU" in k.upper()
                                            or "Accuracy" in k):
            if not 0.0 <= float(v) <= 1.0:
                raise RuntimeError(f"metric {k}={v} out of [0,1]")


def train_one(path: str, seq_dir: str, runs_path: str,
              device: str = "cuda") -> dict:
    """Reduced end-to-end run of one reference YAML: the routing of
    ``python -m awesome_tpu_torch.run`` (FBMS vs convexity;
    spatio-temporal vs pretrain_only vs joint), synthetic replica data,
    shrunk budgets. Raises on any non-finite loss or out-of-range
    metric."""
    from awesome_tpu_torch.run import _is_fbms

    cfg = _load(path, runs_path, device)
    _shrink_cost_knobs(cfg, runs_path,
                       os.path.basename(path).replace(".yaml", ""))
    if _is_fbms(cfg):
        from awesome_tpu_torch.runner.fbms_runner import FBMSRunner

        runner = FBMSRunner.from_awesome_config(cfg, dataset_path=seq_dir)
        if (cfg.dataset_args or {}).get("spatio_temporal") or (
                cfg.prior_model_args or {}).get("channels") == 3:
            # shared (x, y, t) fit (spatio-temporal + noisy families)
            runner.config.num_epochs = min(
                runner.config.num_epochs or 10, 10) or 10
            runner.build()
            res = runner.pretrain()
            _finite(res["epoch_loss"], "spatio-temporal epoch_loss")
            metrics = runner.evaluate()
            _metric_range(metrics)
            return {"mode": "spatio-temporal", "metrics": metrics}
        runner.build()
        out = {"mode": "fbms-joint"}
        if cfg.do_pretraining:
            res = runner.run_pretrain_only_from_config(
                num_steps=10, reuse_state_steps=5,
                prefit_flow_identity_steps=5, prefit_convex_steps=5)
            if "cold_loss" in res:
                _finite(res["cold_loss"], "pretrain cold_loss")
            if cfg.pretrain_only:
                out["mode"] = "fbms-pretrain-only"
                return out
        res = runner.train_joint_from_config(num_epochs=1)
        _finite(res["loss"], "joint loss")
        metrics = runner.evaluate_joint()
        _metric_range(metrics)
        out["metrics"] = metrics
        return out

    from awesome_tpu_torch.runner.runner import AwesomeRunner

    _small_replica(cfg)
    cfg.num_epochs = max(1, min(int(cfg.num_epochs or 2), 2))
    runner = AwesomeRunner(cfg)
    runner.build()
    if cfg.do_pretraining:
        runner.pretrain()
        if cfg.pretrain_only:
            return {"mode": "convexity-pretrain-only"}
    res = runner.train()
    if isinstance(res, dict) and "loss" in res:
        _finite(res["loss"], "train loss")
    metrics = runner.evaluate()
    _metric_range(metrics)
    return {"mode": "convexity", "metrics": metrics}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--config-root", default=REFERENCE_CONFIG)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--stratified", action="store_true",
                   help="one YAML per config directory (fast CI sample)")
    p.add_argument("--train", action="store_true",
                   help="reduced end-to-end TRAIN instead of build-only")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="where every config builds and trains")
    args = p.parse_args(argv)
    if args.out is None:
        args.out = ("runs/train_all_torch" if args.train
                    else "runs/build_all_torch")
    require_dir(args.config_root)

    yamls = []
    for root, _, files in os.walk(args.config_root):
        names = sorted(f for f in files if f.endswith(".yaml"))
        if args.stratified:
            names = names[:1]
        yamls += [os.path.join(root, f) for f in names]
    yamls.sort()
    if args.limit:
        yamls = yamls[: args.limit]

    os.makedirs(args.out, exist_ok=True)
    ok, failures, details = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        seq_dir = write_sequence(tmp)
        runs_path = os.path.join(tmp, "runs")
        for i, y in enumerate(yamls):
            rel = os.path.relpath(y, args.config_root)
            t0 = time.time()
            try:
                if args.train:
                    details[rel] = train_one(y, seq_dir, runs_path,
                                             args.device)
                else:
                    build_one(y, seq_dir, runs_path, args.device)
                ok.append(rel)
                print(f"[{i + 1}/{len(yamls)}] {rel}: OK "
                      f"({time.time() - t0:.1f}s)", flush=True)
            except Exception as e:  # noqa: BLE001 - one config's failure is reported, the sweep goes on
                failures[rel] = repr(e)
                traceback.print_exc()
                print(f"[{i + 1}/{len(yamls)}] {rel}: FAIL {e!r}",
                      flush=True)

    report = {"total": len(yamls), "ok": len(ok), "failures": failures,
              "trained": bool(args.train)}
    if args.train:
        report["details"] = details
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    verb = "trained" if args.train else "built"
    print(f"{verb} {len(ok)}/{len(yamls)}; report -> {args.out}/report.json")
    if failures:
        raise SystemExit(f"{len(failures)} configs failed")


if __name__ == "__main__":
    sys.exit(main())
