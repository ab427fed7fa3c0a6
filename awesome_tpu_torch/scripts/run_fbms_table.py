"""FBMS Sequential-vs-Joint evaluation table (fbms_eval_icml.ipynb);
counterpart of ``scripts/run_fbms_table.py``.

Replays the ICML FBMS evaluation pipeline end to end on the synthetic
FBMS replica (FBMS-59 needs downloads):

1. run the reference's own joint YAMLs (the cars3 flagship across its
   three shipped seed variants) through the port's ``FBMSRunner`` on
   ``--device`` — per-frame prior pretrain, then joint UNet+prior
   training with an epoch-0 baseline eval recorded (the notebook's
   `index_mapping {0: Baseline, 15: Joint}`) and CRF-refined metrics at
   every eval tick (`compute_crf_with_metrics`),
2. persist each run in the ResultModel on-disk layout
   (`FBMSRunner.save_joint_results`),
3. reload ALL runs through the analytics layer (`ResultModel`) and emit
   the summarized Sequential/Joint table — IoU / Prior IoU / Acc. / Prior
   Acc. / CRF IoU / CRF Acc., seed-mean — as markdown and LaTeX
   (`latex_postprocessor`), on the analytics' own ``Table`` (no pandas).

Spec: `notebooks/fbms_eval_icml.ipynb` cells 1-8. Asserts the paper's
headline direction (joint training does not hurt; all metrics in range),
so this is a standing regression.

    python -m awesome_tpu_torch.scripts.run_fbms_table [--device cpu] \\
        [--config-root DIR] [--out runs/fbms_table_torch]

The YAMLs are read from ``<config-root>/path-connectedness/joint``
(``--config-root`` as in ``build_all_configs``; a missing directory exits
nonzero, naming it). Defaults are sized for a quick run; --epochs 15
--pretrain-steps 2000 reproduces the YAML's full budgets.
"""
import argparse
import json
import os
import sys

SEED_YAMLS = [
    "UNET+cars3+edge+diffeo+original+joint.yaml",
    "UNET+cars3+edge+diffeo+original+joint+seed47.yaml",
    "UNET+cars3+edge+diffeo+original+joint+seed131.yaml",
]

# tracker metric -> notebook display column
# (`notebooks/fbms_eval_icml.ipynb` cell 2 col_mapping)
COLS = {
    "MeanForegroundBinaryMIOU": "IoU",
    "PriorMeanForegroundBinaryMIOU": "Prior IoU",
    "MeanPixelAccuracy": "Acc.",
    "PriorMeanPixelAccuracy": "Prior Acc.",
    "CRFMeanForegroundBinaryMIOU": "CRF IoU",
    "CRFMeanPixelAccuracy": "CRF Acc.",
}
ROWS = ("Sequential", "Joint")


def run_one(yaml_path: str, seq: str, runs_root: str, args) -> str:
    from awesome_tpu_torch.runner.fbms_runner import FBMSRunner
    from awesome_tpu_torch.runner.reference_import import (
        load_reference_config,
    )

    cfg, extra = load_reference_config(yaml_path)
    if extra:
        raise RuntimeError(f"unmapped reference fields: {sorted(extra)}")
    tag = os.path.basename(yaml_path).replace(".yaml", "")
    cfg.runs_path = runs_root
    cfg.compute_crf_with_metrics = True
    cfg.compute_metrics_during_training_nth_epoch = max(
        1, args.epochs // 3)
    cfg.pretrain_state_path = os.path.join(runs_root, f"pretrain_{tag}")
    # the YAML's zoo_folder is the relative ./data/zoo — keep the cache
    # (warm prefits across the three seed runs) but inside the run dir
    pa = dict(cfg.pretrain_args or {})
    if isinstance(pa.get("zoo"), dict):
        pa["zoo"] = {"zoo_folder": os.path.join(runs_root, "zoo")}
        cfg.pretrain_args = pa
    runner = FBMSRunner.from_awesome_config(cfg, dataset_path=seq,
                                            device=args.device)
    runner.build()
    runner.run_pretrain_only_from_config(
        num_steps=args.pretrain_steps,
        reuse_state_steps=args.reuse_steps,
        prefit_flow_identity_steps=args.prefit_steps,
        prefit_convex_steps=args.prefit_steps,
    )
    runner.train_joint_from_config(num_epochs=args.epochs,
                                   eval_epoch0=True)
    return runner.save_joint_results(os.path.join(runs_root, tag))


def _mean(values) -> float:
    """Mean over the values that are there (pandas' ``skipna``)."""
    from awesome_tpu_torch.analytics.result_model import _is_missing

    vals = [float(v) for v in values if not _is_missing(v)]
    return sum(vals) / len(vals) if vals else float("nan")


def assemble_table(run_dirs, out_dir: str, device=None):
    """Per-run rows and the seed-mean Sequential/Joint summary of the run
    folders ``run_dirs``, written as ``fbms_table.md`` and
    ``fbms_table.tex`` under ``out_dir``. Returns ``(per_run, summary)``:
    two ``Table``s, the summary's first column ``""`` naming its row.
    The runs load on ``device`` (``None``: the card)."""
    from awesome_tpu_torch.analytics.result_model import (
        ResultModel,
        Table,
        _is_missing,
    )
    from awesome_tpu_torch.utils.format import latex_postprocessor

    rows = []
    for d in run_dirs:
        m = ResultModel.from_path(d, device=device)
        row = {"run": m.name,
               "seed": m.config.seed if m.config else None}
        for name, label in COLS.items():
            row[f"{label} Baseline"] = m.metric_at_epoch(name, 0)
            row[f"{label} Joint"] = m.metric(name, selection="last")
        rows.append(row)
    per_run = Table(rows)

    # the notebook's summarized frame: seed-mean, rows Sequential/Joint
    # (cell 8 renames Baseline -> Sequential)
    order = [c for c in COLS.values()
             if any(not _is_missing(v) for v in per_run[f"{c} Baseline"])]
    summary = Table([
        {"": row, **{c: _mean(per_run[f"{c} {part}"]) for c in order}}
        for row, part in zip(ROWS, ("Baseline", "Joint"))])

    os.makedirs(out_dir, exist_ok=True)
    md = ("# FBMS Sequential vs Joint (fbms_eval_icml replay)\n\n"
          "Per-run (one row per reference seed YAML):\n\n"
          + per_run.to_markdown()
          + "\n\nSummarized (seed mean — the notebook's cell-8 frame):\n\n"
          + summary.to_markdown() + "\n")
    with open(os.path.join(out_dir, "fbms_table.md"), "w") as f:
        f.write(md)
    with open(os.path.join(out_dir, "fbms_table.tex"), "w") as f:
        f.write(latex_postprocessor(summary.to_latex()))
    return per_run, summary


def check_summary(summary) -> None:
    """The standing assertions: every value in [0, 1], and joint training
    did not degrade the segmentation (the paper's headline direction)."""
    vals = {r[""]: {c: v for c, v in r.items() if c} for r in summary.rows}
    flat = [v for r in vals.values() for v in r.values()]
    if not all(0.0 <= v <= 1.0 for v in flat):
        raise AssertionError(f"FBMS table values out of [0, 1]: {vals}")
    if not vals["Joint"]["IoU"] >= vals["Sequential"]["IoU"] - 0.02:
        raise AssertionError(f"joint IoU below sequential - 0.02: {vals}")


def main(argv=None) -> None:
    from awesome_tpu_torch.scripts.build_all_configs import (
        REFERENCE_CONFIG,
        require_dir,
        write_sequence,
    )

    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--pretrain-steps", type=int, default=300)
    p.add_argument("--reuse-steps", type=int, default=100)
    p.add_argument("--prefit-steps", type=int, default=50)
    p.add_argument("--n-frames", type=int, default=8)
    p.add_argument("--hw", type=int, nargs=2, default=(48, 64))
    p.add_argument("--out", default="runs/fbms_table_torch")
    p.add_argument("--config-root", default=REFERENCE_CONFIG)
    p.add_argument("--device", default="cuda",
                   help="where every run trains and evaluates")
    args = p.parse_args(argv)
    joint_dir = require_dir(os.path.join(args.config_root,
                                         "path-connectedness", "joint"))

    import tempfile

    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        seq = write_sequence(tmp, n_frames=args.n_frames,
                             h=args.hw[0], w=args.hw[1])
        run_dirs = [
            run_one(os.path.join(joint_dir, y), seq,
                    os.path.join(args.out, "runs"), args)
            for y in SEED_YAMLS
        ]
    per_run, summary = assemble_table(run_dirs, args.out, args.device)
    print(summary.to_markdown())
    check_summary(summary)
    report = {"per_run": per_run.rows,
              "summary": {c: {r[""]: r[c] for r in summary.rows}
                          for c in summary.columns if c}}
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(f"table -> {args.out}/fbms_table.md")


if __name__ == "__main__":
    sys.exit(main())
