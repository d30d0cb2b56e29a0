"""Quality-control re-runs (port of the JAX package's
``utils/trigger_experiments.py``): train the configurations of a finished
NAS front again with some settings changed, or sweep one hyperparameter
through the fitted parameter -> ratio law to hit target compression ratios.
Each run is a ``train_torch.py`` subprocess, run to its end; its exit code
is not checked (a failed run leaves no ``info.txt``).
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

from .analysis import collect_experiments, targets_from_frontier


def rerun_frontier_configs(frontier_dirs: Sequence[str],
                           overrides: Optional[Dict] = None,
                           basedir: str = '/experiments/QualityControl/',
                           train_script: str = 'train_torch.py',
                           dry_run: bool = False) -> List[List[str]]:
    """Train the ``config.txt`` of each front experiment again with
    ``overrides`` (e.g. ``{'wavelet_filter': ''}``), as ``qc_rerun_<i>``
    under ``basedir``; returns the commands."""
    cmds = []
    for i, d in enumerate(frontier_dirs):
        cfg_file = os.path.join(d, 'config.txt')
        cmd = [sys.executable, train_script, '--config', cfg_file,
               '--expname', f'qc_rerun_{i}', '--basedir', basedir]
        for k, v in (overrides or {}).items():
            cmd += [f'--{k}', str(v)]
        cmds.append(cmd)
        if not dry_run:
            subprocess.run(cmd, check=False)
    return cmds


def runs_at_target_ratios(base_dir: str, config_path: str,
                          param_key: str = 'lambda_drop_loss',
                          target_ratios: Sequence[float] = (100, 200, 300,
                                                            400, 500, 600),
                          basedir: str = '/experiments/QualityControl/',
                          train_script: str = 'train_torch.py',
                          dry_run: bool = False) -> List[List[str]]:
    """Fit the parameter -> compression-ratio law over the finished runs in
    ``base_dir`` and train ``config_path`` once a target ratio, as
    ``qc_target_<ratio>`` under ``basedir``; returns the commands."""
    runs = collect_experiments(base_dir)
    targets = targets_from_frontier(runs, param_key, target_ratios)
    cmds = []
    for ratio, value in targets.items():
        cmd = [sys.executable, train_script, '--config', config_path,
               '--expname', f'qc_target_{int(ratio)}', '--basedir', basedir,
               f'--{param_key}', repr(value)]
        cmds.append(cmd)
        if not dry_run:
            subprocess.run(cmd, check=False)
    return cmds
