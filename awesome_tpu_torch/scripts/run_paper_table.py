"""Standing paper-table regression: the evaluation-notebook variant grid
on the synthetic convexity benchmark; counterpart of
``scripts/run_paper_table.py``.

Reproduces the STRUCTURE of the reference's result tables
(`notebooks/evaluation.ipynb` cells 13/16: rows = segmentation model x
xytype x +/-prior, columns = last- and best-epoch metric selections) on
the synthetic convexity dataset (the real convexity-51 images need
downloads).

Grid: {Net, FCNet, CNNNet} x {xy, feat, featxy} x {prior, no-prior}; each
cell is trained and evaluated through the full runner on ``--device``
(the card by default), then the cells are merged into ONE
ResultComparison markdown table (last + best epoch) written to --out.
Per-cell floors are asserted, so this is a standing regression, not just
a report. Each cell's line on stdout gives its seg and prior MIOU and its
seconds.

Defaults are sized for a quick run (12 images, 64x64, 800 epochs);
--n 51 --hw 96 --epochs 3000 is the full-scale protocol.

Standing invocation (hard benchmark + pinned per-cell floors):
    python -m awesome_tpu_torch.scripts.run_paper_table \\
        --cell-floors runs/paper_table/cell_floors.json
Regression demo (must FAIL: broken CNNNet under its floors, Net above):
    python -m awesome_tpu_torch.scripts.run_paper_table --sabotage cnnnet \\
        --cell-floors runs/paper_table/cell_floors.json
On the CPU add ``--device cpu``.
"""
import argparse
import json
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=12)
    p.add_argument("--hw", type=int, default=64)
    p.add_argument("--epochs", type=int, default=800)
    p.add_argument("--out", default="runs/paper_table_torch")
    p.add_argument("--device", default="cuda",
                   help="where every cell trains and evaluates")
    p.add_argument("--hard", type=float, default=1.0,
                   help="benchmark hardness in [0,1] (data/synthetic.py: "
                        "textured bg, color-ambiguous distractors, noisy "
                        "scribbles); 0 is the saturated benchmark where "
                        "every model family ties")
    p.add_argument("--hard-spread", action="store_true", default=True,
                   help="ramp per-image difficulty 0..hard across the "
                        "dataset (per-image difficulty spread)")
    p.add_argument("--no-hard-spread", dest="hard_spread",
                   action="store_false")
    p.add_argument("--eval-cadence", type=int, default=None,
                   help="compute the full eval-metric grid every N "
                        "epochs DURING training (default epochs//4) so "
                        "the best-epoch selection searches a real "
                        "multi-epoch series; 0 disables mid-training "
                        "evals")
    p.add_argument("--sabotage", default=None,
                   help="deliberately break this model family's cells "
                        "(lr x 1e-4) to demonstrate the floors catch a "
                        "regression: the run must FAIL")
    p.add_argument("--floor", type=float, default=0.5,
                   help="per-cell segmentation MIOU floor")
    p.add_argument("--cell-floors", default=None,
                   help="JSON file of per-cell {name: {seg, prior}} "
                        "floors (overrides --floor; see "
                        "runs/paper_table/cell_floors.json)")
    p.add_argument("--prior-floor", type=float, default=0.5,
                   help="prior-output MIOU floor (prior cells)")
    p.add_argument("--prior-floor-feat", type=float, default=0.2,
                   help="prior floor for 'feat' cells: the prior fits in "
                        "SSS feature space there, and the proxy features "
                        "are weaker than the reference's TF1 embeddings")
    p.add_argument("--models", nargs="*",
                   default=["net", "fcnet", "cnnnet"])
    p.add_argument("--xytypes", nargs="*", default=["xy", "feat", "featxy"])
    p.add_argument("--cells", nargs="*", default=None,
                   help="run only these cells of the grid (names as "
                        "'cnnnet+xy+prior')")
    p.add_argument("--sss-proxy", default="spectral",
                   choices=["spectral", "spectral_device", "pyramid",
                            "sss_fused"],
                   help="SSS feature proxy for the 'feat'/'featxy' cells "
                        "(runner/sss_extractor.py; 'spectral_device' = "
                        "the eigensolve on --device, ops/spectral.py; "
                        "'sss_fused' = semantic-affinity fusion before "
                        "the eigendecomposition)")
    return p.parse_args(argv)


MODEL_TYPES = {
    "net": None,  # runner default Net (y,x,r,g,b pointwise MLP)
    "fcnet": "awesome_tpu_torch.nn.seg.FCNet",
    "cnnnet": "awesome_tpu_torch.nn.seg.CNNNet",
}


def cell_config(args, m: str, xyt: str, use_prior: bool):
    """The runner config of one grid cell."""
    from awesome_tpu_torch.runner.config import AwesomeConfig

    name = f"{m}+{xyt}+{'prior' if use_prior else 'noprior'}"
    dataset_args = {"n": args.n, "h": args.hw, "w": args.hw,
                    "xytype": xyt, "hard": args.hard,
                    "hard_spread": args.hard_spread}
    if xyt in ("feat", "featxy") and args.sss_proxy != "spectral":
        dataset_args["sss_proxy"] = args.sss_proxy
    # reference FCNET/CNNET benchmark widths
    # (`config/convexity/sequential/FCNET_benchmark+*.yaml`)
    seg_args = {"width": 130, "depth": 2} if m == "fcnet" else {}
    if m == "cnnnet":
        # conv net -> image mode ('3d'), like the reference's CNNET
        # benchmark configs (`config/convexity/sequential/CNNET_*`)
        dataset_args["dimension"] = "3d"
    return AwesomeConfig(
        name_experiment=name,
        dataset_args=dataset_args,
        segmentation_model_type=MODEL_TYPES[m],
        segmentation_model_args=seg_args,
        prior_model_args={"n_hidden": 64, "n_hidden_layers": 1},
        use_prior_model=use_prior,
        optimizer_type="adam",
        optimizer_args={"lr": (0.02 if m != "cnnnet" else 1e-3)
                        * (1e-4 if m == args.sabotage else 1.0)},
        num_epochs=args.epochs,
        use_extra_penalty_hook=(m != "cnnnet"),
        extra_penalty_after_n_epochs=max(args.epochs - 200, 50),
        compute_metrics_during_training_nth_epoch=(
            args.eval_cadence if args.eval_cadence is not None
            else max(args.epochs // 4, 1)) or None,
        validation_each_nth_epoch=max(args.epochs // 4, 1),
        runs_path=args.out,
        seed=7,
        device=args.device,
    )


def main(argv=None):
    args = parse_args(argv)
    from awesome_tpu_torch.analytics.result_model import (
        ResultComparison,
        ResultModel,
    )
    from awesome_tpu_torch.runner.runner import AwesomeRunner

    os.makedirs(args.out, exist_ok=True)
    run_dirs, failures = [], []
    cells = [(m, xyt, use_prior) for m in args.models
             for xyt in args.xytypes for use_prior in (True, False)]
    if args.cells is not None:
        cells = [c for c in cells
                 if f"{c[0]}+{c[1]}+{'prior' if c[2] else 'noprior'}"
                 in args.cells]
    t_all = time.perf_counter()
    for m, xyt, use_prior in cells:
        cfg = cell_config(args, m, xyt, use_prior)
        name = cfg.name_experiment
        t0 = time.perf_counter()
        try:
            r = AwesomeRunner(cfg)
            r.build()
            r.train()
            metrics = r.evaluate()
            run_dirs.append(r.save_results())
            secs = time.perf_counter() - t0
            miou = metrics.get("MeanForegroundBinaryMIOU", 0.0)
            prior = metrics.get("PriorMeanForegroundBinaryMIOU")
            prior_s = "-" if prior is None else f"{prior:.3f}"
            print(f"{name}: MIOU {miou:.3f} prior MIOU {prior_s} "
                  f"seconds {secs:.3f}", flush=True)
        except Exception as e:  # noqa: BLE001
            failures.append((name, repr(e)))
            print(f"{name}: FAILED {e!r}", flush=True)
    print(f"grid seconds {time.perf_counter() - t_all:.3f}", flush=True)

    results = [ResultModel.from_path(d, device=args.device)
               for d in run_dirs]
    table_path = os.path.join(args.out, "paper_table.md")
    floors_report = {}
    with open(table_path, "w") as f:
        f.write("# Evaluation-grid table (synthetic convexity benchmark)\n"
                f"\nn={args.n} images {args.hw}x{args.hw}, "
                f"{args.epochs} epochs. Structure: "
                "notebooks/evaluation.ipynb cells 13/16.\n\n")
        for selection in ("last", "best"):
            f.write(f"## {selection}-epoch selection\n\n")
            t = ResultComparison(results).table(
                metric_names=["MeanForegroundBinaryMIOU",
                              "PriorMeanForegroundBinaryMIOU",
                              "MeanPixelAccuracy"],
                selection=selection,
            )
            f.write(t.to_markdown(index=False))
            f.write("\n\n")
    for r in results:
        m = r.metrics("eval", selection="best", maximize=True)
        # strip the timestamp prefix -> stable cell name
        cell = r.name.split("_", 2)[-1]
        floors_report[cell] = {
            "seg": m.get("MeanForegroundBinaryMIOU"),
            "prior": m.get("PriorMeanForegroundBinaryMIOU"),
        }
    with open(os.path.join(args.out, "floors.json"), "w") as f:
        json.dump({"cells": floors_report, "failures": failures}, f,
                  indent=2)
    # suggested per-cell floors for the NEXT pin: measured minus margin
    with open(os.path.join(args.out, "cell_floors_suggested.json"),
              "w") as f:
        json.dump({
            c: {k: (None if v is None else round(max(v - 0.06, 0.0), 3))
                for k, v in vv.items()}
            for c, vv in floors_report.items()
        }, f, indent=2)
    print("wrote", table_path)

    cell_floors = None
    if args.cell_floors:
        with open(args.cell_floors) as f:
            cell_floors = json.load(f)

    bad = []
    for n, v in floors_report.items():
        if cell_floors is not None and n in cell_floors:
            cf = cell_floors[n] or {}
            sf, pf = cf.get("seg"), cf.get("prior")
            if sf is not None and (v["seg"] is None or v["seg"] < sf):
                bad.append((n, "seg", v["seg"], f"floor {sf}"))
            if (pf is not None and "+prior" in n
                    and (v["prior"] is None or v["prior"] < pf)):
                bad.append((n, "prior", v["prior"], f"floor {pf}"))
            continue
        # a cell absent from the pinned floors file (grid drift, renamed
        # or newly added cell) still gets the global-floor gate: never
        # silently unchecked
        if v["seg"] is None or v["seg"] < args.floor:
            bad.append((n, "seg", v["seg"], f"floor {args.floor}"))
        if "+prior" in n:
            pf = (args.prior_floor_feat if "+feat+" in n
                  else args.prior_floor)
            if v["prior"] is None or v["prior"] < pf:
                bad.append((n, "prior", v["prior"], f"floor {pf}"))
    if failures or bad:
        raise SystemExit(f"paper-table regression: failures={failures} "
                         f"below-floor={bad}")


if __name__ == "__main__":
    main()
