#!/usr/bin/env python
"""The spread of chip_smoke.py's resume check on one card.

    python3 resume_noise.py --reps 8 [--tree DIR] [--volume mhd_like.npy]

The resume phase of chip_smoke.py (``state_round_trip``) trains a fresh
flagship-width state of a gate family for 2 chunks of 50 steps, saves it,
loads it back, runs one more chunk from the loaded and from the live state,
and holds the continued losses and the states they end in bit for bit
(trees whose gradient kernel adds with atomics held the losses to
ATOMICS_TOL of each other).  This script repeats that round trip ``--reps``
times for smallify and dynamic variational (the two configs the phase
runs), with chip_smoke.py and the package of the tree DIR (default: this
checkout), so that two trees can be run in turns.  The round trip's checks
are recorded, not raised.  One JSON line a round trip, then one summary
line a config: the continued chunks' max relative loss differences (the
atomics-era check's measure), sorted, their median, 90th percentile and
max, how many exceeded ATOMICS_TOL, how many round trips' continued losses
differed at all, and how many round trips failed any of the tree's checks;
likewise the max absolute difference over the chunk's mean |loss|, and the
chunk's least |loss|.  The volume is synth_volume(255,
seed=1, octaves=6), as the smoke's, saved to ``--volume`` (or a temporary
file) unless that file exists, and read through load_volume as the smoke
reads it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

CONFIGS = ('mhd_p_smallify.txt', 'mhd_p_dynamic_variational.txt')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout whose chip_smoke.py and package run")
    ap.add_argument('--reps', type=int, default=8)
    ap.add_argument('--volume', default=None, help='.npy of the 255^3 volume')
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print('resume_noise: CUDA is not available', file=sys.stderr)
        return 1
    check(os.path.dirname(os.path.abspath(cs.__file__)) == tree,
          f'chip_smoke came from {cs.__file__}, not {tree}')
    cs.disable_tf32()
    label = os.path.relpath(tree)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True)
    print(json.dumps({'tree': label, 'nvidia_smi': card.stdout.strip(),
                      'torch': torch.__version__}), flush=True)
    failed = []
    cs.check = lambda cond, msg: cond or failed.append(msg)
    # the losses of every chunk run; the round trip's last two are the
    # continued chunks, live then loaded
    losses = []
    run_chunks = cs.run_chunks

    def recording(*a, **kw):
        out = run_chunks(*a, **kw)
        losses.append(np.asarray(out[0], dtype=np.float64))
        return out
    cs.run_chunks = recording
    tmp = tempfile.mkdtemp(prefix='lfgc_resume_noise_')
    try:
        # the smoke's volume, through load_volume (float32 in [-1, 1]) as
        # the smoke's resume phase reads it
        vol_path = args.volume or os.path.join(tmp, 'mhd_like.npy')
        if not os.path.exists(vol_path):
            np.save(vol_path, cs.synth_volume(cs.VOLUME_N, seed=1, octaves=6))
        vol_dev = torch.from_numpy(cs.load_volume(vol_path)).cuda()
        for name in CONFIGS:
            config = os.path.join(tree, 'experiment-config-files', name)
            diffs, of_mean, min_abs, unequal, failing = [], [], [], 0, 0
            for rep in range(args.reps):
                del failed[:], losses[:]
                row = cs.state_round_trip(config, vol_dev, tmp)
                live, loaded = losses[-2:]
                diff = np.abs(loaded - live)
                diffs.append(row['continued_max_rel_loss_diff'])
                of_mean.append(float(diff.max() / np.abs(live).mean()))
                min_abs.append(float(np.abs(live).min()))
                unequal += not np.array_equal(loaded, live)
                failing += bool(failed)
                print(json.dumps({'tree': label, 'config': name, 'rep': rep, **row,
                                  'continued_loss_min': float(live.min()),
                                  'continued_loss_max': float(live.max()),
                                  'continued_max_abs_loss_diff': float(diff.max()),
                                  'step_of_max_rel_diff': int(np.argmax(diff / np.abs(live))),
                                  'failed_checks': list(failed)}), flush=True)
            print(json.dumps({
                'tree': label, 'config': name, 'reps': args.reps,
                'atomics_tol': cs.ATOMICS_TOL, **summary(diffs),
                'over_tol': sum(d > cs.ATOMICS_TOL for d in diffs),
                'losses_unequal': unequal, 'failed_round_trips': failing,
                'max_abs_diff_over_mean_abs_loss': summary(of_mean),
                'min_abs_loss': summary(min_abs)}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def summary(values):
    values = sorted(values)
    return {'sorted': values, 'median': statistics.median(values),
            'p90': values[min(len(values) - 1, int(0.9 * len(values)))],
            'max': values[-1]}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'resume_noise: {msg}')


if __name__ == '__main__':
    sys.exit(main())
