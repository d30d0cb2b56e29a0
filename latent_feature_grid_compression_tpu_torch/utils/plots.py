"""Figures of experiment analysis (port of the JAX package's
``utils/plots.py``), on matplotlib's Agg backend, written as png: PSNR
against compression ratio a method (with the spread over repeated searches),
a hyperparameter against an objective, parallel coordinates, the
quality-control law, the pruned share with and without wavelets, and the
coefficients' histograms; ``save_pgf`` exports a figure for LaTeX, and
``mlflow_best_run`` queries an MLflow server where one exists.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .analysis import collect_experiments, fit_log_linear, pareto_frontier
def _plt():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def plot_pareto_comparison(method_dirs: Dict[str, str], out_path: str,
                           x_key: str = 'compression_ratio',
                           y_key: str = 'psnr') -> str:
    """One PSNR-vs-ratio frontier curve per method directory."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, base in method_dirs.items():
        runs = collect_experiments(base)
        xs = [float(r['info'][x_key]) for r in runs if x_key in r['info']]
        ys = [float(r['info'][y_key]) for r in runs if y_key in r['info']]
        if not xs:
            continue
        ax.scatter(xs, ys, s=12, alpha=0.4)
        if len(xs) >= 2:
            fx, fy = pareto_frontier(xs, ys)
            order = np.argsort(fx)
            ax.plot(np.asarray(fx)[order], np.asarray(fy)[order],
                    marker='o', label=label)
        else:
            ax.plot(xs, ys, marker='o', label=label)
    ax.set_xlabel('compression ratio')
    ax.set_ylabel('PSNR [dB]')
    ax.set_xscale('log')
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_hyperparam_analysis(base_dir: str, param_key: str, out_path: str,
                             y_key: str = 'compression_ratio') -> str:
    """Scatter of one hyperparameter vs an objective over all runs."""
    plt = _plt()
    runs = collect_experiments(base_dir)
    xs = [float(r['config'][param_key]) for r in runs
          if param_key in r['config'] and y_key in r['info']]
    ys = [float(r['info'][y_key]) for r in runs
          if param_key in r['config'] and y_key in r['info']]
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.scatter(xs, ys)
    ax.set_xlabel(param_key)
    ax.set_ylabel(y_key)
    if xs and min(xs) > 0 and max(xs) / max(min(xs), 1e-30) > 100:
        ax.set_xscale('log')
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_parallel_coordinates(base_dir: str, param_keys, out_path: str,
                              color_key: str = 'psnr') -> str:
    """Parallel-coordinates view of hyperparameters across runs, colored by an
    objective."""
    plt = _plt()
    import matplotlib as mpl
    runs = collect_experiments(base_dir)
    rows, colors = [], []
    for r in runs:
        try:
            rows.append([float(r['config'][k]) for k in param_keys])
            colors.append(float(r['info'].get(color_key, 0.0)))
        except (KeyError, ValueError, TypeError):
            continue
    if not rows:
        raise ValueError('no complete runs found')
    data = np.asarray(rows)
    # normalize each column to [0, 1]
    lo, hi = data.min(0), data.max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    norm = (data - lo) / span
    cmap = mpl.colormaps['viridis']
    cn = mpl.colors.Normalize(min(colors), max(colors))
    fig, ax = plt.subplots(figsize=(1.5 * len(param_keys) + 2, 4))
    for row, c in zip(norm, colors):
        ax.plot(range(len(param_keys)), row, color=cmap(cn(c)), alpha=0.7)
    ax.set_xticks(range(len(param_keys)))
    ax.set_xticklabels(param_keys, rotation=30, ha='right')
    for i, (l, h) in enumerate(zip(lo, hi)):
        ax.text(i, -0.06, f'{l:.3g}', ha='center', va='top', fontsize=7)
        ax.text(i, 1.02, f'{h:.3g}', ha='center', va='bottom', fontsize=7)
    fig.colorbar(mpl.cm.ScalarMappable(norm=cn, cmap=cmap), ax=ax,
                 label=color_key)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_pareto_with_variance(method_repeat_dirs: Dict[str, Sequence[str]],
                              out_path: str,
                              x_key: str = 'compression_ratio',
                              y_key: str = 'psnr',
                              n_bins: int = 12) -> str:
    """Pareto frontiers over repeated NAS runs with a min/max variance band
    per method.

    ``method_repeat_dirs`` maps a method label to the experiment base dirs of
    its repeated searches. Each
    repeat contributes its own frontier; the band is the min..max envelope of
    the repeats' frontiers interpolated on a common log-ratio lattice, the
    line is their mean."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, dirs in method_repeat_dirs.items():
        fronts = []
        for base in dirs:
            runs = collect_experiments(base)
            xs = [float(r['info'][x_key]) for r in runs if x_key in r['info']]
            ys = [float(r['info'][y_key]) for r in runs if y_key in r['info']]
            if len(xs) >= 2:
                fx, fy = pareto_frontier(xs, ys)
                order = np.argsort(fx)
                fronts.append((np.asarray(fx)[order], np.asarray(fy)[order]))
        if not fronts:
            continue
        lo = max(f[0].min() for f in fronts)
        hi = min(f[0].max() for f in fronts)
        if hi <= lo:  # disjoint ranges: plot raw frontiers, no band
            for fx, fy in fronts:
                ax.plot(fx, fy, alpha=0.6, label=label)
                label = None
            continue
        lattice = np.geomspace(lo, hi, n_bins)
        interp = np.stack([np.interp(np.log(lattice), np.log(fx), fy)
                           for fx, fy in fronts])
        line = ax.plot(lattice, interp.mean(0), marker='o', label=label)[0]
        ax.fill_between(lattice, interp.min(0), interp.max(0),
                        alpha=0.25, color=line.get_color())
    ax.set_xlabel('compression ratio')
    ax.set_ylabel('PSNR [dB]')
    ax.set_xscale('log')
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_quality_control(base_dir: str, param_key: str, out_path: str,
                         target_ratios: Sequence[float] = (100, 200, 300,
                                                           400, 500, 600)
                         ) -> str:
    """Hyperparameter-vs-achieved-ratio scatter in log-log space with the
    fitted log-linear control law overlaid."""
    plt = _plt()
    runs = collect_experiments(base_dir)
    xs = [float(r['config'][param_key]) for r in runs
          if param_key in r['config'] and 'compression_ratio' in r['info']]
    ys = [float(r['info']['compression_ratio']) for r in runs
          if param_key in r['config'] and 'compression_ratio' in r['info']]
    if len(xs) < 2:
        raise ValueError('need >= 2 completed runs to fit the control law')
    a, b = fit_log_linear(xs, ys)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.scatter(np.log(ys), np.log(xs), alpha=0.5, label='ground-truth runs',
               color='steelblue')
    ratio_line = np.linspace(min(target_ratios), max(target_ratios) * 4 / 3,
                             20)
    # invert the fitted law: log(param) = (log(ratio) - b) / a
    ax.plot(np.log(ratio_line), (np.log(ratio_line) - b) / a,
            label='fitted curve', color='forestgreen')
    for t in target_ratios:
        ax.axvline(np.log(t), color='gray', lw=0.5, alpha=0.5)
    ax.set_xlabel('log compression_ratio')
    ax.set_ylabel(f'log {param_key}')
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_pruned_ratio_comparison(method_dirs: Dict[str, str], out_path: str,
                                 upper_limit: float = 600.0) -> str:
    """Percentage of pruned parameters vs compression ratio per method —
    the with/without-wavelet pruning comparison."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, base in method_dirs.items():
        runs = collect_experiments(base)
        pts = []
        for r in runs:
            info = r['info']
            if not {'compression_ratio', 'num_zeros',
                    'num_parameters'} <= set(info):
                continue
            ratio = float(info['compression_ratio'])
            if ratio < upper_limit:
                pts.append((ratio, 100.0 * float(info['num_zeros'])
                            / float(info['num_parameters'])))
        if not pts:
            continue
        pts.sort()
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker='o',
                label=label)
    ax.set_xlabel('compression ratio')
    ax.set_ylabel('pruned [%]')
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_weight_histograms(model, out_path: str) -> str:
    """Histograms of a model's wavelet coefficients, one panel a pyramid
    level (the coefficients are copied to the host)."""
    plt = _plt()
    n = len(model.coeffs)
    fig, axes = plt.subplots(1, n, figsize=(3 * n, 3))
    if n == 1:
        axes = [axes]
    for i, (ax, c) in enumerate(zip(axes, model.coeffs)):
        vals = c.detach().cpu().numpy().ravel()
        ax.hist(vals, bins=80)
        ax.set_title(f'level {i} ({vals.size} coeffs)')
        ax.set_yscale('log')
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def save_pgf(fig, out_path: str) -> str:
    """Export a figure as LaTeX .pgf through matplotlib's pgf backend.

    Requires a TeX engine on PATH (the pgf backend shells out for text
    metrics); raises a clear error otherwise."""
    import shutil
    if not any(shutil.which(t) for t in ('xelatex', 'lualatex', 'pdflatex')):
        raise RuntimeError(
            'save_pgf needs a TeX engine (xelatex/lualatex/pdflatex) on '
            'PATH for matplotlib\'s pgf backend; none found')
    if not out_path.endswith('.pgf'):
        out_path += '.pgf'
    fig.savefig(out_path, backend='pgf')
    return out_path


def mlflow_best_run(metric: str, experiment_name: str, maximize: bool = True):
    """The best run of an MLflow experiment by ``metric``.

    Training writes nothing to MLflow, so this reads a tracking server
    filled by other means; ``mlflow`` is an optional dependency, and its
    absence raises ``ImportError``.
    """
    try:
        from mlflow.tracking import MlflowClient
    except ImportError as e:
        raise ImportError(
            'mlflow is not installed; mlflow_best_run needs it and an '
            'MLflow tracking server filled by other means') from e
    client = MlflowClient()
    exp = client.get_experiment_by_name(experiment_name)
    if exp is None:
        raise ValueError(f'no MLflow experiment named {experiment_name!r}')
    order = 'DESC' if maximize else 'ASC'
    runs = client.search_runs([exp.experiment_id],
                              order_by=[f'metrics.{metric} {order}'],
                              max_results=1)
    return runs[0] if runs else None
