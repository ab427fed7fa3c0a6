"""Post-hoc analytics: load finished run directories back into objects and
build cross-run comparison tables; counterpart of
``awesome_tpu/analytics/result_model.py``.

Behavior port of `awesome/analytics/result_model.py:71-668` (ResultModel:
scan a run dir, reload config/tracker/checkpoints/params) and
`awesome/analytics/result_comparison.py` (ResultComparison: the paper's
metric tables, as markdown or latex). A run folder of either package
reads the same (the port writes the JAX package's layout). The tables are
a small :class:`Table` of this module, with its own markdown and latex
writers: no pandas or tabulate is needed. The plot helpers import
matplotlib when called.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from awesome_tpu_torch.device import DeviceLike


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and (
        not isinstance(v, bool))


class Table:
    """Rows of named values, columns in order of first appearance (what
    ``pandas.DataFrame(rows)`` makes of a list of dicts); a value a row
    lacks reads as NaN."""

    def __init__(self, rows: Sequence[Dict[str, Any]]):
        self.columns: List[str] = []
        for r in rows:
            for k in r:
                if k not in self.columns:
                    self.columns.append(k)
        self.rows = [{c: r.get(c, float("nan")) for c in self.columns}
                     for r in rows]

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, column: str) -> List[Any]:
        return [r[column] for r in self.rows]

    @staticmethod
    def _cell(v) -> str:
        if _is_missing(v):
            return "nan"
        if isinstance(v, (float, np.floating)):
            return f"{float(v):g}"
        return str(v)

    def _numeric(self, column: str) -> bool:
        vals = [v for v in self[column] if not _is_missing(v)]
        return bool(vals) and all(_is_number(v) for v in vals)

    def to_markdown(self, index: bool = False) -> str:
        """A pipe table: numeric columns right-aligned, others left."""
        del index  # rows carry no index
        cells = [[self._cell(r[c]) for c in self.columns] for r in self.rows]
        widths = [max([len(c)] + [len(row[i]) for row in cells])
                  for i, c in enumerate(self.columns)]
        num = [self._numeric(c) for c in self.columns]

        def line(vals):
            return "| " + " | ".join(
                v.rjust(w) if n else v.ljust(w)
                for v, w, n in zip(vals, widths, num)) + " |"

        rule = "|" + "|".join(
            ("-" * (w + 1) + ":") if n else (":" + "-" * (w + 1))
            for w, n in zip(widths, num)) + "|"
        return "\n".join([line(self.columns), rule]
                         + [line(row) for row in cells])

    def to_latex(self, index: bool = False) -> str:
        del index
        align = "".join("r" if self._numeric(c) else "l"
                        for c in self.columns)

        def esc(v: str) -> str:
            return v.replace("_", "\\_").replace("&", "\\&")

        out = [f"\\begin{{tabular}}{{{align}}}", "\\toprule",
               " & ".join(esc(c) for c in self.columns) + " \\\\",
               "\\midrule"]
        for r in self.rows:
            out.append(" & ".join(esc(self._cell(r[c]))
                                  for c in self.columns) + " \\\\")
        out += ["\\bottomrule", "\\end{tabular}"]
        return "\n".join(out) + "\n"


class ResultModel:
    """A finished run, reloaded."""

    def __init__(self, path: str, device: DeviceLike = None):
        self.path = path
        # where modules inside the config (and reloaded params) are built:
        # None = the config's own device field
        self.device = device
        self._config = None
        self._tracker = None

    @classmethod
    def from_path(cls, path: str, device: DeviceLike = None
                  ) -> "ResultModel":
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        return cls(path, device)

    @property
    def name(self) -> str:
        return os.path.basename(os.path.normpath(self.path))

    @property
    def config(self):
        if self._config is None:
            from awesome_tpu_torch.runner.config import AwesomeConfig

            p = os.path.join(self.path, "config.yaml")
            dev = None if self.device is None else str(self.device)
            self._config = (AwesomeConfig.load(p, device=dev)
                            if os.path.exists(p) else None)
        return self._config

    @property
    def tracker(self):
        if self._tracker is None:
            from awesome_tpu_torch.fit.tracker import Tracker

            p = os.path.join(self.path, "tracker.json")
            self._tracker = Tracker.load(p) if os.path.exists(p) else None
        return self._tracker

    def get_params(self, template: Optional[Any] = None,
                   stacked: Union[int, Dict[str, int]] = 0):
        """Reload the stacked params saved by the runner (params.npz, the
        JAX package's leaf order and layout) or an AgentCheckpoint
        directory. Without ``template``: the leaves as numpy arrays.
        With one (a param tree of this package): that tree's structure
        with the saved leaves, in this package's layout on
        ``self.device`` (else the template's device); ``stacked`` counts
        the leading image axes, or maps each top-level key to its count
        (``AwesomeRunner._stacked_axes()``)."""
        from awesome_tpu_torch.bridge import params_from_jax
        from awesome_tpu_torch.core import tree as T
        from awesome_tpu_torch.runner.runner import _jax_order

        npz = os.path.join(self.path, "params.npz")
        if os.path.exists(npz):
            data = np.load(npz)
            leaves = [data[k] for k in data.files]
            if template is None:
                return leaves
            dev = self.device or T.tree_leaves(template)[0].device
            paths = [p for p, _ in _jax_order(template)]
            if len(paths) != len(leaves):
                raise ValueError(f"{npz} holds {len(leaves)} leaves, the "
                                 f"template {len(paths)}")
            host = T.tree_map(lambda x: None, template)
            for path, leaf in zip(paths, leaves):
                node = host
                for k in path[:-1]:
                    node = node[k]
                if isinstance(node, tuple):
                    raise TypeError("tuple nodes are not supported")
                node[path[-1]] = leaf
            if isinstance(stacked, dict):
                return {k: params_from_jax(v, dev, stacked[k])
                        for k, v in host.items()}
            return params_from_jax(host, dev, stacked)
        ckpt_dir = os.path.join(self.path, "checkpoint")
        if os.path.isdir(ckpt_dir):
            from awesome_tpu_torch.fit.checkpoint import AgentCheckpoint

            return AgentCheckpoint.load(ckpt_dir, template,
                                        device=self.device).params
        raise FileNotFoundError(f"no params in {self.path}")

    def scan_checkpoints(self) -> Dict[str, str]:
        """Tag -> directory for every checkpoint saved during the run
        ('best'/'latest'/'end' + any per-epoch tags).

        Spec: `analytics/result_model.py:450` scan_checkpoints.
        """
        root = os.path.join(self.path, "checkpoints")
        if not os.path.isdir(root):
            return {}
        return {
            d: os.path.join(root, d)
            for d in sorted(os.listdir(root))
            if os.path.isdir(os.path.join(root, d))
        }

    def get_checkpoint(self, tag: str = "end", template: Optional[Any] = None):
        """Reload one saved AgentCheckpoint (params + tracker snapshot +
        config). Spec: `agent/torch_agent.py:1090` from_acc."""
        from awesome_tpu_torch.fit.checkpoint import AgentCheckpoint

        ckpts = self.scan_checkpoints()
        if tag not in ckpts:
            raise FileNotFoundError(
                f"no checkpoint '{tag}' in {self.path} (have {list(ckpts)})"
            )
        return AgentCheckpoint.load(ckpts[tag], params_template=template,
                                    device=self.device)

    def get_runner(self, checkpoint: Optional[str] = None):
        """Rebuild a runnable AwesomeRunner from this finished run: config
        -> build (dataset + models) -> restore the saved stacked params
        (from ``checkpoint`` tag when given, e.g. 'best', else the final
        params.npz).

        The reference's equivalent is ``get_agent`` -> TorchAgent.from_acc
        (`analytics/result_model.py:571`, `agent/torch_agent.py:1090`).
        Enables continued training / re-evaluation of an archived run.
        """
        from awesome_tpu_torch.runner.runner import AwesomeRunner

        cfg = self.config
        if cfg is None:
            raise FileNotFoundError(f"no config.yaml in {self.path}")
        runner = AwesomeRunner(cfg)
        runner.build()
        if checkpoint is not None:
            ckpt = self.get_checkpoint(
                checkpoint, template=runner.stacked_params
            )
            runner.stacked_params = ckpt.params
        else:
            runner.stacked_params = self.get_params(
                template=runner.stacked_params,
                stacked=runner._stacked_axes())
        if self.tracker is not None:
            runner.tracker = self.tracker
        return runner

    def metric(self, name: str, mode: str = "eval",
               scope: str = "epoch",
               selection: str = "last",
               maximize: bool = True) -> Optional[float]:
        """One metric under a selection rule: 'last' (final epoch) or
        'best' (best value over all recorded epochs — the evaluation
        notebook's cell-16 'best' selection)."""
        t = self.tracker
        if t is None:
            return None
        s = t.series.get((name, scope, mode))
        if not s:
            return None
        if selection == "best":
            best = s.best(maximize)
            return best[1] if best else None
        return s.last

    def metric_at_epoch(self, name: str, epoch: int, mode: str = "eval",
                        scope: str = "epoch") -> Optional[float]:
        """Metric value recorded at a specific epoch — the
        fbms_eval_icml notebook's Baseline(0)/Joint(15) indexing."""
        t = self.tracker
        if t is None:
            return None
        s = t.series.get((name, scope, mode))
        return s.at(epoch) if s else None

    def metric_best_epoch(self, name: str, mode: str = "eval",
                          scope: str = "epoch",
                          maximize: bool = True):
        """(epoch, value) of the best recorded value."""
        t = self.tracker
        if t is None:
            return None
        s = t.series.get((name, scope, mode))
        return s.best(maximize) if s else None

    def get_tracked_metrics(self, mode: Optional[str] = None,
                            scope: str = "epoch") -> List[str]:
        """Names of every tracked metric series (the read_results
        notebook's ``result_model.get_tracked_metrics()``,
        `notebooks/how_to/read_results.ipynb` cell 4)."""
        t = self.tracker
        if t is None:
            return []
        return sorted({
            name for (name, sc, m) in t.series
            if sc == scope and (mode is None or m == mode)
        })

    def metric_series(self, name: str, mode: str = "eval",
                      scope: str = "epoch"):
        """(epochs, values) of one tracked series (the notebook's
        ``tracker.metrics[...].values`` view)."""
        t = self.tracker
        if t is None:
            return None
        s = t.series.get((name, scope, mode))
        return (list(s.steps), list(s.values)) if s else None

    def metrics(self, mode: str = "eval", selection: str = "last",
                maximize: bool = True) -> Dict[str, float]:
        t = self.tracker
        if t is None:
            return {}
        out = {}
        for (name, scope, m), series in t.series.items():
            if m != mode or scope != "epoch":
                continue
            v = self.metric(name, mode, scope, selection, maximize)
            if v is not None:
                out[name] = v
        return out

    @staticmethod
    def scan_result_directory(runs_path: str) -> List["ResultModel"]:
        """All run dirs under a runs folder.

        Spec: `analytics/result_model.py:411` scan_result_directory.
        """
        out = []
        for d in sorted(os.listdir(runs_path)):
            full = os.path.join(runs_path, d)
            if os.path.isdir(full) and (
                os.path.exists(os.path.join(full, "config.yaml"))
                or os.path.exists(os.path.join(full, "tracker.json"))
            ):
                out.append(ResultModel(full))
        return out


class NoisyUnariesResultModel(ResultModel):
    """ResultModel for the noisy weak-label experiments: knows its label
    noise level so runs line up into a noise -> metric curve (the
    fbms_spatio_temporal_noisy_eval table).

    Spec: `awesome/analytics/result_model.py:668` NoisyUnariesResultModel.
    """

    @property
    def noise_level(self) -> Optional[float]:
        cfg = self.config
        if cfg is None:
            return None
        for source in (cfg.dataset_args or {}, getattr(cfg, "pretrain_args",
                                                       {}) or {}):
            # 'noisy_percentage' is the key the reference's own
            # noisy-spatio-temporal YAMLs carry (pretrain_args)
            for key in ("flip_probability", "noise", "noise_level",
                        "noisy_percentage"):
                if key in source:
                    return float(source[key])
            inner = source.get("dataset")
            if isinstance(inner, dict):
                for key in ("flip_probability", "noise"):
                    if key in inner:
                        return float(inner[key])
        return None


class ResultComparison:
    """Cross-run metric tables (the paper-table generator)."""

    def __init__(self, results: List[ResultModel]):
        self.results = results

    def table(self, metric_names: Optional[List[str]] = None,
              mode: str = "eval", selection: str = "last",
              maximize: bool = True) -> Table:
        """One row per run. ``selection='best'`` reproduces the notebook's
        best-epoch table (evaluation.ipynb cell 16) from archived runs."""
        rows = []
        for r in self.results:
            row = {"run": r.name}
            m = r.metrics(mode, selection=selection, maximize=maximize)
            if metric_names:
                m = {k: v for k, v in m.items() if k in metric_names}
            row.update(m)
            if selection == "best" and metric_names:
                for k in metric_names:
                    best = r.metric_best_epoch(k, mode, maximize=maximize)
                    if best:
                        row[f"{k}:epoch"] = best[0]
            if isinstance(r, NoisyUnariesResultModel):
                row["noise"] = r.noise_level
            if r.config is not None and r.config.diff_config:
                for k, v in r.config.diff_config.items():
                    row[f"cfg:{k}"] = v
            rows.append(row)
        return Table(rows)

    def grouped_table(self, metric_names: List[str],
                      group_by: Optional[List[str]] = None,
                      mode: str = "eval", selection: str = "last",
                      maximize: bool = True, fmt: str = "{:.3f}") -> Table:
        """Seed-grouped "mean ± std" table (the unireps evaluation
        notebook's cells 2-5: runs grouped by everything except the
        seed, metrics aggregated over the seed group;
        `notebooks/unireps_evaluation.ipynb`). ``group_by`` defaults to
        all cfg:* columns except cfg:seed."""
        rows_in = []
        for r in self.results:
            row = {"experiment": (r.config.name_experiment
                                  if r.config is not None else r.name),
                   "cfg:seed": (r.config.seed
                                if r.config is not None else None)}
            if r.config is not None and r.config.diff_config:
                for k, v in r.config.diff_config.items():
                    # grid sweeps put list/dict values into diff_config
                    # (e.g. mesh_shape, plot_indices); group on the repr
                    # of an unhashable value
                    row[f"cfg:{k}"] = (repr(v)
                                       if isinstance(v, (list, dict, set))
                                       else v)
            for m in metric_names:
                row[m] = r.metric(m, mode, selection=selection,
                                  maximize=maximize)
            rows_in.append(row)
        df = Table(rows_in)
        if group_by is None:
            group_by = ["experiment"] + [
                c for c in df.columns
                if c.startswith("cfg:") and c != "cfg:seed"
            ]
        present = [m for m in metric_names if m in df.columns]
        groups: Dict[tuple, List[Dict[str, Any]]] = {}
        for row in df.rows:
            # NaN != NaN: missing keys group together under None
            key = tuple(None if _is_missing(row[g]) else row[g]
                        for g in group_by)
            groups.setdefault(key, []).append(row)
        rows = []
        for keys in sorted(groups, key=lambda t: tuple(
                (x is None, str(type(x)), x if x is not None else 0)
                for x in t)):
            g = groups[keys]
            row = dict(zip(group_by,
                           [float("nan") if k is None else k for k in keys]))
            row["n_runs"] = len(g)
            if "cfg:seed" in df.columns:
                row["seeds"] = ", ".join(str(s) for s in sorted(
                    r["cfg:seed"] for r in g
                    if not _is_missing(r["cfg:seed"])))
            for m in present:
                vals = np.asarray([r[m] for r in g if not _is_missing(r[m])],
                                  np.float64)
                if len(vals) == 0:
                    row[m] = ""
                elif len(vals) == 1:
                    row[m] = fmt.format(vals[0])
                else:
                    # pandas' std: the sample (n - 1) standard deviation
                    row[m] = (fmt.format(vals.mean()) + " ± "
                              + fmt.format(vals.std(ddof=1)))
            rows.append(row)
        return Table(rows)

    def noise_curve(self, metric: str, mode: str = "eval"):
        """noise level -> metric (sorted), for NoisyUnariesResultModels."""
        pts = [
            (r.noise_level, r.metric(metric, mode))
            for r in self.results
            if isinstance(r, NoisyUnariesResultModel)
            and r.noise_level is not None
            and r.metric(metric, mode) is not None
        ]
        return sorted(pts)

    def plot_metric(self, name: str, mode: str = "eval",
                    scope: str = "epoch"):
        """Epoch-curve line chart across runs (the read_results
        notebook's ``comp.plot_metric``,
        `notebooks/how_to/read_results.ipynb` cell 9). Returns the mpl
        Figure (Agg-safe; caller saves/shows)."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        for r in self.results:
            s = r.metric_series(name, mode, scope)
            if s:
                ax.plot(s[0], s[1], marker="o", markersize=3,
                        label=r.name)
        ax.set_xlabel(scope)
        ax.set_ylabel(name)
        ax.legend(fontsize=7)
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        return fig

    def plot_metric_bar(self, name: str, mode: str = "eval",
                        selection: str = "last", maximize: bool = True):
        """Final/best-value bar chart across runs (the notebook's
        ``comp.plot_metric_bar``)."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        labels, vals = [], []
        for r in self.results:
            v = r.metric(name, mode, selection=selection,
                         maximize=maximize)
            if v is not None:
                labels.append(r.name)
                vals.append(v)
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.bar(range(len(vals)), vals)
        ax.set_xticks(range(len(vals)))
        ax.set_xticklabels(labels, rotation=30, ha="right", fontsize=7)
        ax.set_ylabel(f"{name} ({selection})")
        fig.tight_layout()
        return fig

    def to_markdown(self, **kwargs) -> str:
        return self.table(**kwargs).to_markdown(index=False)

    def to_latex(self, **kwargs) -> str:
        return self.table(**kwargs).to_latex(index=False)

    def best(self, metric: str, maximize: bool = True,
             mode: str = "eval") -> Optional[ResultModel]:
        scored = [
            (r.metric(metric, mode), r)
            for r in self.results
            if r.metric(metric, mode) is not None
        ]
        if not scored:
            return None
        return (max if maximize else min)(scored, key=lambda t: t[0])[1]
