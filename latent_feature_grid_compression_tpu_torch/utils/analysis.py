"""Experiment analysis (port of the JAX package's ``utils/analysis.py``).

* experiment-folder readers (``info.txt`` / ``config.txt`` through
  ``config.dict_from_file``);
* Pareto-frontier extraction;
* the hyperparameter -> compression-ratio law (log-linear) that the
  quality-control runner inverts to hit target compression ratios.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import dict_from_file


def load_experiment(experiment_path: str) -> Dict[str, dict]:
    """The {info, config} dicts of one experiment folder ({} where a file
    is missing)."""
    out = {}
    for name in ('info', 'config'):
        p = os.path.join(experiment_path, f'{name}.txt')
        out[name] = dict_from_file(p) if os.path.exists(p) else {}
    return out


def collect_experiments(base_dir: str, pattern: str = '*') -> List[Dict[str, dict]]:
    """Every experiment folder under ``base_dir`` matching ``pattern`` that
    has an ``info.txt``, sorted by path (each dict also holds its ``path``)."""
    runs = []
    for d in sorted(glob.glob(os.path.join(base_dir, pattern))):
        if os.path.isdir(d):
            e = load_experiment(d)
            if e['info']:
                e['path'] = d
                runs.append(e)
    return runs


def pareto_frontier(xs: Sequence[float], ys: Sequence[float],
                    max_x: bool = True, max_y: bool = True
                    ) -> Tuple[List[float], List[float]]:
    """The Pareto frontier of (x, y) points."""
    pts = sorted(zip(xs, ys), reverse=max_x)
    front = [pts[0]]
    for x, y in pts[1:]:
        if (y >= front[-1][1]) == max_y and y != front[-1][1]:
            front.append((x, y))
    fx, fy = zip(*front)
    return list(fx), list(fy)


def fit_log_linear(param_values: Sequence[float],
                   ratios: Sequence[float]) -> Tuple[float, float]:
    """Fit ratio = exp(a * log(param) + b); returns (a, b)."""
    lx = np.log(np.asarray(param_values, dtype=np.float64))
    ly = np.log(np.asarray(ratios, dtype=np.float64))
    a, b = np.polyfit(lx, ly, 1)
    return float(a), float(b)


def param_for_target_ratio(a: float, b: float, target_ratio: float) -> float:
    """Invert the fitted law: the parameter that gives ``target_ratio``."""
    return float(math.exp((math.log(target_ratio) - b) / a))


def targets_from_frontier(runs: List[Dict[str, dict]],
                          param_key: str = 'lambda_drop_loss',
                          target_ratios: Sequence[float] = (100, 200, 300,
                                                            400, 500, 600)
                          ) -> Dict[float, float]:
    """Fit the parameter -> ratio law over the finished runs and solve it
    for each target ratio."""
    done = [r for r in runs
            if param_key in r['config'] and 'compression_ratio' in r['info']]
    if len(done) < 2:
        raise ValueError('need >= 2 completed runs to fit the curve')
    a, b = fit_log_linear([float(r['config'][param_key]) for r in done],
                          [float(r['info']['compression_ratio']) for r in done])
    return {t: param_for_target_ratio(a, b, t) for t in target_ratios}
