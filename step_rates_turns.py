#!/usr/bin/env python
"""Flagship train-step times of two or more trees, in turns, on one card.

    python3 step_rates_turns.py --trees DIR_A,DIR_B [--rounds 4] [--steps 200]
                                [--modes eager,graphed]

Each round runs, for each tree in turn (the order reversed every other
round: A B, B A, ...), one process that imports that tree's chip_smoke.py
and package, builds the tree's kernels (into the tree's own build
directory, so only its first process compiles) and times ``--steps``
flagship phase-1 steps of every training path of that tree's smoke
(chip_smoke.phase_step_rates with one round: host clock around steps that
end in a device read).  A tree whose smoke runs solve_phase's chunk
runner times each path with the step's CUDA graph and with eager steps
(``--modes`` picks them; a tree from before the runner takes no
``--modes`` and times its eager train_step).  So two commits are compared
on the same card in one call, each in processes of its own.  Prints the card's name and power
limit, one JSON line a tree and round, then a last line: for each tree and
path, the ms a step of each round, their median and their spread (max -
min).  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = """\
import json, sys
sys.path.insert(0, {tree!r})
import chip_smoke as cs
from latent_feature_grid_compression_tpu_torch.ops import _build
cs.disable_tf32()
_build.build(_build.kernel_sources())
cs.emit = lambda obj: None
print('STEP_RATES ' + json.dumps(cs.phase_step_rates(rounds=1, steps={steps}{modes})))
"""


def run_tree(tree: str, steps: int, modes: str = '') -> dict:
    extra = f', modes={tuple(modes.split(","))!r}' if modes else ''
    res = subprocess.run([sys.executable, '-c', CHILD.format(tree=tree, steps=steps,
                                                             modes=extra)],
                         cwd=tree, capture_output=True, text=True, timeout=1800)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith('STEP_RATES ')]
    if res.returncode != 0 or not lines:
        raise RuntimeError(f'{tree} exited {res.returncode}:\n{res.stdout[-3000:]}'
                           f'{res.stderr[-3000:]}')
    return json.loads(lines[-1][len('STEP_RATES '):])['ms_per_step']


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--trees', required=True, help='comma-separated checkouts')
    ap.add_argument('--rounds', type=int, default=4)
    ap.add_argument('--steps', type=int, default=200)
    ap.add_argument('--modes', default='',
                    help="comma-separated: eager, graphed (default: the tree's smoke's)")
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees.split(',')]
    import torch
    if not torch.cuda.is_available():
        print('step_rates_turns: CUDA is not available', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    ms = {t: {} for t in trees}
    for r in range(args.rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            got = run_tree(tree, args.steps, args.modes)
            print(json.dumps({'tree': os.path.relpath(tree), 'round': r, 'ms_per_step': got}),
                  flush=True)
            for path, v in got.items():
                ms[tree].setdefault(path, []).extend(v)
    print(json.dumps({os.path.relpath(t): {
        path: {'ms': v, 'median_ms': statistics.median(v), 'spread_ms': max(v) - min(v)}
        for path, v in d.items()} for t, d in ms.items()}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
