#!/usr/bin/env python
"""Multi-objective NAS example of the PyTorch port (the counterpart of
examples/nas_example.py, the reference's Multiobjective-NAS.ipynb flow):
build a search, run all trials of train_torch.py, extract the Pareto
frontier, plot it.

Usage (the trials train on the card):
    python examples/make_test_volume.py                # once, to create data
    python examples/nas_example_torch.py [--trials 12] [--drop_type smallify]
"""

import argparse
import os
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
sys.path.insert(0, REPO)

from latent_feature_grid_compression_tpu_torch.nas import pareto_front, run_search  # noqa: E402
from latent_feature_grid_compression_tpu_torch.utils.plots import (  # noqa: E402
    plot_pareto_comparison)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--config', default='experiment-config-files/test_impl_test.txt')
    p.add_argument('--drop_type', default='smallify')
    p.add_argument('--trials', type=int, default=12)
    p.add_argument('--parallelism', type=int, default=3)
    p.add_argument('--basedir', default='/experiments/NAS/')
    p.add_argument('--max_pass', type=int, default=0,
                   help='override max_pass for every trial (0 = config value)')
    p.add_argument('--out', default='nas_pareto_torch.png', help='the frontier plot')
    args = p.parse_args(argv)

    overrides = {'max_pass': args.max_pass} if args.max_pass else None
    trials = run_search(args.config, drop_type=args.drop_type,
                        total_trials=args.trials, parallelism=args.parallelism,
                        basedir=args.basedir, extra_overrides=overrides,
                        train_script=os.path.join(os.path.abspath(REPO), 'train_torch.py'))

    done = [t for t in trials if t.objective is not None]
    if done:
        front = [done[i] for i in pareto_front([t.objective for t in done])]
        print('\nPareto frontier (compression_ratio, psnr):')
        for t in sorted(front, key=lambda t: t.objective):
            print(f'  trial {t.index}: ratio={t.objective[0]:.1f} '
                  f'psnr={t.objective[1]:.2f}  params={t.params}')
        base = os.path.abspath(os.getcwd()) + args.basedir
        out = plot_pareto_comparison({'NAS': base}, args.out)
        print(f'wrote {out}')
    return trials


if __name__ == '__main__':
    main()
