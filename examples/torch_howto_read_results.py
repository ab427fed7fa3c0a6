#!/usr/bin/env python
"""How-To: Read Results on the PyTorch port — the analytics-layer demo;
counterpart of ``examples/howto_read_results.py``.

Script equivalent of the reference's third how-to notebook
(`notebooks/how_to/read_results.ipynb`): run (or point at) experiments,
load each run dir through ``ResultModel``, list the tracked metrics,
read their per-epoch curves, and compare runs with ``ResultComparison``
(a table, and a line and a bar chart drawn through PIL, since the card's
machine has no matplotlib) — the notebook's cells 2-11.

With no arguments, two tiny synthetic convexity runs are trained first
(on the card unless ``--device cpu``) so the script is self-contained;
pass --runs <dir> to read any existing runs folder (e.g. the output of
``python -m awesome_tpu_torch.run``).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
          (148, 103, 189), (140, 86, 75))


def make_demo_runs(out: str, epochs: int, device: str):
    """Two short runs differing only in prior width — something for the
    comparison to compare (the notebook assumes archived runs exist)."""
    from awesome_tpu_torch.runner.config import AwesomeConfig
    from awesome_tpu_torch.runner.runner import AwesomeRunner

    dirs = []
    for name, width in (("narrow", 12), ("wide", 32)):
        cfg = AwesomeConfig(
            name_experiment=name,
            dataset_args={"n": 2, "h": 32, "w": 32},
            segmentation_model_args={"n_hidden": 16},
            prior_model_args={"n_hidden": width, "n_hidden_layers": 1},
            optimizer_args={"lr": 0.02},
            num_epochs=epochs,
            runs_path=out,
            seed=1,
            device=device,
        )
        r = AwesomeRunner(cfg)
        r.build()
        r.train()
        r.evaluate()
        dirs.append(r.save_results())
    return dirs


def _chart(series, path: str, bars: bool = False, size=(560, 320),
           pad: int = 30) -> str:
    """``series``: (label, xs, ys) per run; a polyline each, or one bar
    each (its last value) with ``bars``. The legend is the colour order of
    the runs as printed."""
    from PIL import Image, ImageDraw

    w, h = size
    im = Image.new("RGB", size, "white")
    draw = ImageDraw.Draw(im)
    draw.rectangle((pad, pad, w - pad, h - pad), outline="black")
    ys = [y for _, _, v in series for y in v]
    lo, hi = min(ys + [0.0]), max(ys + [1e-9])
    span = hi - lo or 1.0

    def py(v):
        return h - pad - (v - lo) / span * (h - 2 * pad)

    for i, (label, xs, vals) in enumerate(series):
        color = COLORS[i % len(COLORS)]
        if bars:
            bw = (w - 2 * pad) / len(series)
            x0 = pad + i * bw + 0.2 * bw
            draw.rectangle((x0, py(vals[-1]), x0 + 0.6 * bw, py(lo)),
                           fill=color)
        else:
            x_lo, x_hi = min(xs), max(xs)
            xspan = (x_hi - x_lo) or 1.0
            pts = [(pad + (x - x_lo) / xspan * (w - 2 * pad), py(v))
                   for x, v in zip(xs, vals)]
            if len(pts) > 1:
                draw.line(pts, fill=color, width=2)
            for x, y in pts:
                draw.ellipse((x - 2, y - 2, x + 2, y + 2), fill=color)
        draw.text((pad + 4, pad + 4 + 12 * i), label, fill=color)
    im.save(path)
    return path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--runs", type=str, default=None,
                   help="existing runs folder; default trains two demo runs")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--out", type=str, default=".")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the demo runs train")
    args = p.parse_args(argv)

    from awesome_tpu_torch.analytics.result_model import (
        ResultComparison,
        ResultModel,
    )

    runs_dir = args.runs
    if runs_dir is None:
        runs_dir = os.path.join(args.out, "demo_runs")
        print(f"training two demo runs into {runs_dir} ...")
        make_demo_runs(runs_dir, args.epochs, args.device)

    # --- notebook cell 2: load one run ---
    results = ResultModel.scan_result_directory(runs_dir)
    if not results:
        raise SystemExit(f"no run dirs found under {runs_dir}")
    result_model = results[0]
    print(f"\nloaded {len(results)} run(s); first: {result_model.name}")

    # --- cell 4: the tracked metrics ---
    names = result_model.get_tracked_metrics()
    print("tracked metrics:", ", ".join(names))

    # --- cell 5: per-epoch values of the MIOU series ---
    for name in [n for n in names if "miou" in n.lower()]:
        series = result_model.metric_series(name)
        if series:
            epochs, values = series
            print(f"{name}: epochs {epochs} -> "
                  + ", ".join(f"{v:.4f}" for v in values))

    # --- cells 7-11: compare runs ---
    comp = ResultComparison(results)
    metric = "MeanForegroundBinaryMIOU"
    print("\ncomparison table:\n")
    print(comp.to_markdown())

    curves = [(r.name, *r.metric_series(metric)) for r in results
              if r.metric_series(metric)]
    line_png = _chart(curves, os.path.join(args.out, "metric_curve.png"))
    bar_png = _chart(curves, os.path.join(args.out, "metric_bar.png"),
                     bars=True)
    print(f"\nplots -> {line_png}, {bar_png}")

    best = comp.best(metric)
    print(f"best run by {metric}: {best.name}: "
          f"{best.metric(metric):.4f}")


if __name__ == "__main__":
    main()
