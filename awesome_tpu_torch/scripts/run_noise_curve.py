"""Label-noise robustness curve: the full noisy-spatio-temporal family;
counterpart of ``scripts/run_noise_curve.py``.

Replays ALL 21 reference YAMLs
(`config/path-connectedness/noisy-spatio-temporal/*`: 3 seeds x 7 noise
levels 0..0.6) through the port's ``FBMSRunner`` on ``--device`` on the
synthetic moving-disk sequence: dense per-frame unaries, round(T * level)
MIDDLE frames replaced by clamp(N(0.5, 1), 0, 1) garbage (first/last
exempt), shared (x, y, t) prior fit with flow-identity + convex prefits
(`awesome/model/noisy_path_connected_net.py:178-230`), IoU vs GT,
assembled into the noise -> IoU curve via `NoisyUnariesResultModel` —
the `notebooks/fbms_spatio_temporal_noisy_eval.ipynb` pipeline
(published anchor: IoU 0.826 / 0.799 / 0.796 / 0.527 / 0.186 at
0/10/20/30/50% on cars3, SURVEY.md section 6).

    python -m awesome_tpu_torch.scripts.run_noise_curve [--device cpu] \\
        [--config-root DIR] [--out runs/noise_curve_torch]

The YAMLs are read from
``<config-root>/path-connectedness/noisy-spatio-temporal``
(``--config-root`` as in ``build_all_configs``; a missing directory exits
nonzero, naming it). Writes ``noise_curve.md`` and ``noise_curve.json``
under ``--out``.
"""
import argparse
import glob
import json
import os
import sys
import tempfile
import time

METRIC = "MeanForegroundBinaryMIOU"


def summarize(curve):
    """(noise, IoU) points -> (points per level, mean per level, sample
    std per level (n - 1; 0 for one seed)), levels sorted."""
    by_level = {}
    for noise, v in curve:
        by_level.setdefault(noise, []).append(v)
    mean_curve = {
        lvl: sum(vs) / len(vs) for lvl, vs in sorted(by_level.items())
    }
    std_curve = {
        lvl: (sum((v - mean_curve[lvl]) ** 2 for v in vs)
              / max(len(vs) - 1, 1)) ** 0.5
        for lvl, vs in sorted(by_level.items())
    }
    return by_level, mean_curve, std_curve


def write_curve(results, out: str, n_frames: int):
    """The curve of the run folders ``results`` (NoisyUnariesResultModels)
    as ``noise_curve.md`` and ``noise_curve.json`` under ``out``; returns
    (mean per level, std per level)."""
    from awesome_tpu_torch.analytics.result_model import ResultComparison

    cmp = ResultComparison(results)
    curve = cmp.noise_curve(METRIC)
    by_level, mean_curve, std_curve = summarize(curve)
    table = cmp.table(metric_names=[METRIC])
    with open(os.path.join(out, "noise_curve.md"), "w") as f:
        f.write("# Noise robustness curve (noisy-spatio-temporal family)"
                f"\n\nReplica sequence length: {n_frames} frames.\n\n")
        f.write("Reference published anchor (cars3, real data): "
                "0%:0.826 10%:0.799 20%:0.796 30%:0.527 50%:0.186\n\n")
        f.write("| flip | mean IoU | std | seeds |\n|---|---|---|---|\n")
        for lvl, v in mean_curve.items():
            f.write(f"| {lvl:.1f} | {v:.3f} | {std_curve[lvl]:.3f} "
                    f"| {len(by_level[lvl])} |\n")
        f.write("\n\n")
        f.write(table.to_markdown())
        f.write("\n")
    with open(os.path.join(out, "noise_curve.json"), "w") as f:
        json.dump({"n_frames": n_frames,
                   "mean_curve": {str(k): v for k, v in mean_curve.items()},
                   "std_curve": {str(k): v for k, v in std_curve.items()},
                   "points": curve}, f, indent=2)
    return mean_curve, std_curve


def _jobs(yamls, extra_seeds):
    """One replay per YAML, and per (level, extra seed) one of the level's
    first YAML with the seed overridden."""
    jobs = [(y, None) for y in yamls]
    if not extra_seeds:
        return jobs
    seen_levels = set()
    for y in yamls:
        # noise level is the trailing npX_Y token of the name
        lvl_key = os.path.basename(y).split("np")[-1]
        if lvl_key in seen_levels:
            continue
        seen_levels.add(lvl_key)
        jobs += [(y, s) for s in extra_seeds]
    return jobs


def main(argv=None) -> None:
    from awesome_tpu_torch.scripts.build_all_configs import (
        REFERENCE_CONFIG,
        require_dir,
        write_sequence,
    )

    p = argparse.ArgumentParser()
    p.add_argument("--out", default="runs/noise_curve_torch")
    p.add_argument("--epochs", type=int, default=None,
                   help="override pretrain steps (default: the YAML's)")
    p.add_argument("--yaml-glob", default="*.yaml")
    p.add_argument("--n-frames", type=int, default=10,
                   help="replica sequence length (longer sequences probe "
                        "the cliff shape: 30%% of a long sequence is a "
                        "smaller contiguous fraction of the tube)")
    p.add_argument("--extra-seeds", type=int, nargs="*", default=[],
                   help="additional seeds per noise level beyond the "
                        "family's own 3 (each level's first YAML is "
                        "replayed with the seed overridden)")
    p.add_argument("--config-root", default=REFERENCE_CONFIG)
    p.add_argument("--device", default="cuda",
                   help="where every run fits and evaluates")
    args = p.parse_args(argv)
    ref = require_dir(os.path.join(args.config_root, "path-connectedness",
                                   "noisy-spatio-temporal"))

    from awesome_tpu_torch.analytics.result_model import (
        NoisyUnariesResultModel,
    )
    from awesome_tpu_torch.runner.fbms_runner import FBMSRunner
    from awesome_tpu_torch.runner.reference_import import (
        load_reference_config,
    )

    yamls = sorted(glob.glob(os.path.join(ref, args.yaml_glob)))
    os.makedirs(args.out, exist_ok=True)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        seq = write_sequence(tmp, n_frames=args.n_frames, h=48, w=64,
                             n_fg=60, n_bg=140)
        jobs = _jobs(yamls, args.extra_seeds)
        for i, (y, seed_override) in enumerate(jobs):
            name = os.path.splitext(os.path.basename(y))[0]
            cfg, extra = load_reference_config(y)
            if extra:
                raise RuntimeError(f"unmapped reference fields in {y}: "
                                   f"{sorted(extra)}")
            cfg.runs_path = args.out
            if seed_override is not None:
                cfg.seed = seed_override
                name = f"{name}+xseed{seed_override}"
            cfg.name_experiment = name
            if args.epochs:
                # pretrain-only configs budget the fit via pretrain_args
                cfg.num_epochs = args.epochs
                cfg.pretrain_args = dict(cfg.pretrain_args or {},
                                         num_epochs=args.epochs)
            t0 = time.time()
            runner = FBMSRunner.from_awesome_config(cfg, dataset_path=seq,
                                                    device=args.device)
            runner.build()
            runner.pretrain()
            metrics = runner.evaluate()
            out_dir = runner.save_results(metrics)
            results.append(NoisyUnariesResultModel.from_path(
                out_dir, device=args.device))
            print(f"[{i + 1}/{len(jobs)}] {name}: frame-noise "
                  f"{runner.config.frame_noise_percentage} IoU "
                  f"{metrics[METRIC]:.3f} ({time.time() - t0:.0f}s)",
                  flush=True)

    mean_curve, _ = write_curve(results, args.out, args.n_frames)
    print("curve:", {round(k, 2): round(v, 3) for k, v in
                     mean_curve.items()})
    print("wrote", os.path.join(args.out, "noise_curve.md"))


if __name__ == "__main__":
    sys.exit(main())
