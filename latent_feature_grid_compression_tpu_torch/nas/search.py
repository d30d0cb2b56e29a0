"""Multi-objective NAS over training hyperparameters (port of the JAX
package's ``nas/search.py``).

* Quasi-random exploration, then either perturbation of the Pareto front
  ('sobol') or GP surrogates with expected hypervolume improvement
  ('gp_ehvi', ``nas.bayesopt``).
* Each trial is a training subprocess (``python train_torch.py --config
  ... --<overrides>``), at most ``parallelism`` in flight, its output
  discarded.
* Objectives: maximize (compression_ratio, psnr), with the acceptance
  thresholds compression_ratio >= 100 and psnr >= 30 dB.
* A trial's metrics are the last point of each objective curve in its
  TensorBoard log (``runs/<expname>``), else its ``info.txt``; a trial with
  neither has failed and is reported without metrics.

The random draws are Python's ``random`` and numpy's, as in the JAX
package, so the same seed and the same observed metrics give the same
suggestions there and here.
"""

from __future__ import annotations

import dataclasses
import math
import os
import random
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import dict_from_file
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    name: str
    low: float
    high: float
    log: bool = False
    integer: bool = False

    def sample(self, rng: random.Random) -> float:
        if self.log:
            v = math.exp(rng.uniform(math.log(self.low), math.log(self.high)))
        else:
            v = rng.uniform(self.low, self.high)
        return int(round(v)) if self.integer else v

    def perturb(self, value: float, rng: random.Random, scale=0.3) -> float:
        if self.log:
            lv = math.log(value) + rng.gauss(0, scale) * (
                math.log(self.high) - math.log(self.low)) * 0.1
            v = math.exp(min(max(lv, math.log(self.low)), math.log(self.high)))
        else:
            v = value + rng.gauss(0, scale) * (self.high - self.low) * 0.1
            v = min(max(v, self.low), self.high)
        return int(round(v)) if self.integer else v


# Search spaces: smallify-type, the unpruned baseline, variational
SMALLIFY_SPACE = [
    ParamSpec('lambda_drop_loss', 1e-10, 1e-2, log=True),
    ParamSpec('lambda_weight_loss', 1e-10, 1e-2, log=True),
    ParamSpec('drop_threshold', 0.6, 0.95),
    ParamSpec('drop_momentum', 0.005, 0.1),
    ParamSpec('n_hidden_size', 4, 32, integer=True),
    ParamSpec('grid_size', 4, 32, integer=True),
    ParamSpec('grid_features', 4, 24, integer=True),
]

BASELINE_SPACE = [
    ParamSpec('n_hidden_size', 4, 32, integer=True),
    ParamSpec('grid_size', 8, 62, integer=True),
    ParamSpec('grid_features', 4, 32, integer=True),
    ParamSpec('lr', 1e-4, 5e-2, log=True),
]

VARIATIONAL_SPACE = [
    ParamSpec('lambda_drop_loss', 1e-10, 1e-2, log=True),
    ParamSpec('lambda_weight_loss', 1e-10, 1e-2, log=True),
    ParamSpec('drop_threshold', 0.6, 0.95),
    ParamSpec('weight_dkl_multiplier', 1e-6, 1e-3, log=True),
    ParamSpec('variational_sigma', -9.0, -1.0),
    ParamSpec('n_hidden_size', 4, 32, integer=True),
    ParamSpec('grid_size', 8, 62, integer=True),
    ParamSpec('grid_features', 4, 32, integer=True),
]


@dataclasses.dataclass
class Trial:
    index: int
    params: Dict[str, float]
    expname: str
    proc: Optional[subprocess.Popen] = None
    metrics: Optional[Dict[str, float]] = None

    @property
    def objective(self) -> Optional[Tuple[float, float]]:
        if not self.metrics:
            return None
        return (self.metrics.get('compression_ratio', 0.0),
                self.metrics.get('psnr', 0.0))


def pareto_front(points: Sequence[Tuple[float, float]]) -> List[int]:
    """Indices of the maximization Pareto frontier."""
    idx = sorted(range(len(points)), key=lambda i: points[i], reverse=True)
    front, best_y = [], -float('inf')
    for i in idx:
        if points[i][1] > best_y:
            front.append(i)
            best_y = points[i][1]
    return front


def hypervolume_2d(points, ref=(0.0, 0.0)) -> float:
    """2-D dominated hypervolume wrt a reference point (for reporting)."""
    pts = sorted({(max(p[0], ref[0]), max(p[1], ref[1])) for p in points},
                 reverse=True)
    hv, prev_y = 0.0, ref[1]
    for x, y in pts:
        if y > prev_y:
            hv += (x - ref[0]) * (y - prev_y)
            prev_y = y
    return hv


class MultiObjectiveSearch:
    """Exploration then model-guided exploitation.

    ``generation_strategy``:
      * 'sobol'   — quasi-random exploration + Pareto-frontier perturbation
        (cheap, zero dependencies);
      * 'gp_ehvi' — Gaussian-process surrogates + Monte-Carlo expected
        hypervolume improvement (nas.bayesopt).
    """

    def __init__(self, space: Sequence[ParamSpec], total_trials: int = 20,
                 exploration_fraction: float = 0.5, seed: int = 0,
                 generation_strategy: str = 'gp_ehvi',
                 thresholds: Tuple[float, float] = (100.0, 30.0)):
        if generation_strategy not in ('sobol', 'gp_ehvi'):
            raise ValueError(f'unknown generation_strategy '
                             f'{generation_strategy!r}')
        self.space = list(space)
        self.total_trials = total_trials
        self.n_explore = max(1, int(total_trials * exploration_fraction))
        self.rng = random.Random(seed)
        self.completed: List[Trial] = []
        self.generation_strategy = generation_strategy
        self._gen = None
        if generation_strategy == 'gp_ehvi':
            from .bayesopt import GPEHVIGenerator
            self._gen = GPEHVIGenerator(space, seed=seed,
                                        thresholds=thresholds)

    def suggest(self, trial_index: int) -> Dict[str, float]:
        if trial_index < self.n_explore or not self._front():
            return {p.name: p.sample(self.rng) for p in self.space}
        if self._gen is not None:
            observed = [(t.params, t.objective) for t in self.completed
                        if t.objective is not None]
            return self._gen.suggest(observed)
        # exploit: perturb a random Pareto-frontier config
        parent = self.rng.choice(self._front())
        return {p.name: p.perturb(parent.params[p.name], self.rng)
                for p in self.space}

    def _front(self) -> List[Trial]:
        done = [t for t in self.completed if t.objective is not None]
        if not done:
            return []
        front_idx = pareto_front([t.objective for t in done])
        return [done[i] for i in front_idx]

    def report(self, trial: Trial):
        self.completed.append(trial)


# the objective curves; training() writes them as add_scalar calls without
# a step at its evaluation
_TB_TAGS = ('compression_ratio', 'psnr', 'rmse', 'mse', 'zeroes',
            'compr_rmse')


def read_trial_metrics_tb(log_dir: str) -> Optional[Dict[str, float]]:
    """The last point of each objective curve in a trial's TensorBoard
    event files; None when the ``tensorboard`` reader is not installed, the
    log dir does not exist, or no objective tag was written (a failed
    trial)."""
    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator)
    except ImportError:
        return None
    if not os.path.isdir(log_dir):
        return None
    acc = EventAccumulator(log_dir, size_guidance={'scalars': 0})
    acc.Reload()
    out = {}
    for tag in _TB_TAGS:
        if tag in acc.Tags().get('scalars', ()):
            events = acc.Scalars(tag)
            if events:
                out[tag] = float(events[-1].value)
    return out or None


def read_trial_metrics(experiment_path: str,
                       tb_log_dir: Optional[str] = None
                       ) -> Optional[Dict[str, float]]:
    """A trial's metrics: its TensorBoard curves, else its info.txt."""
    if tb_log_dir is not None:
        tb = read_trial_metrics_tb(tb_log_dir)
        if tb is not None:
            return tb
    info = os.path.join(experiment_path, 'info.txt')
    if not os.path.exists(info):
        return None
    d = dict_from_file(info)
    return {k: float(v) for k, v in d.items()
            if isinstance(v, (int, float))}


def _format_value(v):
    return repr(v) if isinstance(v, str) else str(v)


def run_search(config_path: str, drop_type: str = 'smallify',
               total_trials: int = 20, parallelism: int = 3,
               basedir: str = '/experiments/NAS/', seed: int = 0,
               train_script: str = 'train_torch.py',
               psnr_threshold: float = 30.0,
               ratio_threshold: float = 100.0,
               extra_overrides: Optional[Dict] = None,
               poll_interval: float = 2.0,
               generation_strategy: str = 'gp_ehvi',
               dry_run_cmd=None) -> List[Trial]:
    """Run the full NAS loop; returns all trials (metrics attached).

    ``dry_run_cmd`` (tests): callable(cmd, expdir) run instead of Popen.
    """
    if drop_type == 'smallify':
        space = SMALLIFY_SPACE
    elif 'variational' in drop_type:
        space = VARIATIONAL_SPACE
    elif drop_type in ('', 'baseline', None):
        space, drop_type = BASELINE_SPACE, ''
    else:
        space = SMALLIFY_SPACE

    search = MultiObjectiveSearch(space, total_trials, seed=seed,
                                  generation_strategy=generation_strategy,
                                  thresholds=(ratio_threshold, psnr_threshold))
    pending: List[Trial] = []
    next_index = 0

    def launch(trial: Trial):
        expdir = os.path.abspath(os.getcwd()) + basedir + trial.expname + '/'
        cmd = [sys.executable, train_script, '--config', config_path,
               '--expname', trial.expname, '--basedir', basedir,
               '--drop_type', drop_type]
        for k, v in {**trial.params, **(extra_overrides or {})}.items():
            cmd += [f'--{k}', _format_value(v)]
        if dry_run_cmd is not None:
            dry_run_cmd(cmd, expdir)
            trial.proc = None
            trial.metrics = read_trial_metrics(expdir,
                                               'runs/' + trial.expname)
            search.report(trial)
            return
        trial.proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                      stderr=subprocess.STDOUT)

    while next_index < total_trials or pending:
        while next_index < total_trials and len(pending) < parallelism:
            t = Trial(next_index, search.suggest(next_index),
                      expname=f'nas_trial_{next_index}')
            next_index += 1
            launch(t)
            if t.proc is not None:
                pending.append(t)
        if not pending:
            continue
        time.sleep(poll_interval)
        still = []
        for t in pending:
            if t.proc.poll() is None:
                still.append(t)
                continue
            expdir = os.path.abspath(os.getcwd()) + basedir + t.expname + '/'
            t.metrics = read_trial_metrics(expdir, 'runs/' + t.expname)
            search.report(t)
        pending = still

    done = [t for t in search.completed if t.objective is not None]
    accepted = [t for t in done
                if t.objective[0] >= ratio_threshold
                and t.objective[1] >= psnr_threshold]
    front = ([done[i] for i in pareto_front([t.objective for t in done])]
             if done else [])
    print(f'NAS finished: {len(done)}/{total_trials} trials produced metrics; '
          f'{len(accepted)} meet thresholds (ratio>={ratio_threshold}, '
          f'psnr>={psnr_threshold}); Pareto front size {len(front)}; '
          f'hypervolume {hypervolume_2d([t.objective for t in done]):.1f}'
          if done else 'NAS finished: no successful trials')
    return search.completed
