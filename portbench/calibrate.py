"""The readings that the limits of ``correct`` are set from, at a cell's own
size on the card, many seeds in one process:

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 --seconds 2

For each seed it drives the cell's traffic for a short window, as a run does,
and prints one JSON line with the numbers compared for:

* ``program``: what the timed path produced, against the float32 reference
  (the lower reading of each limit);
* ``control``: the reference computed in TF32, put in the program's place
  (the precision just below the configuration's float32 with TF32 off);
* ``half_batch`` (training cells): the reference with each step's loss over
  half its batch, put in the program's place.

A state left unchanged reads 1 on ``grad_gap`` and ``update_gap`` by their
definition and is not run.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import spec as S
from .run import seeds_of


def readings(cell: S.Cell, seed: int, seconds: float, device) -> dict:
    import torch
    from latent_feature_grid_compression_tpu_torch.device import disable_tf32
    from . import generator as gen
    from .reference import check as C
    from .reference import model as R
    from .run import judge
    from .volume import mhd_like
    from .weights import clone, make_params
    disable_tf32()
    cfg, mix = cell.config, cell.traffic
    seeds = seeds_of(seed)
    volume = mhd_like(cfg['volume']['n'], cfg['volume']['octaves'], seeds['volume'], device)
    params = make_params(cfg, seeds['weights'], device, pruned=mix['kind'] != 'train')
    ref_params = clone(params)
    ctx = gen.Context(config=cfg, traffic=mix, seconds=seconds, trace=False, device=device,
                      volume=volume, params=params, seeds=seeds,
                      process_start=time.perf_counter())
    run = gen.KINDS[mix['kind']](ctx)
    del ctx, params
    gc.collect()
    out = {'seed': seed, 'units': run.units, 'program': judge(run, cell, volume, ref_params, seeds)}
    if run.kind == 'train':
        p0 = [t for _, t in R.leaves(ref_params, cfg['drop_type'])]
        steps, rows = mix['checked_steps'], mix['steps_per_chunk']
        ref = C.train_reference(ref_params, cfg, volume, seeds, steps, rows)
        for name, kw in (('control', {'tf32': True}), ('half_batch', {'half_batch': True})):
            side = C.train_reference(ref_params, cfg, volume, seeds, steps, rows, **kw)
            out[name] = C.train_numbers(side, ref, p0)
    elif run.kind == 'decompress':
        want = C.reference_field(ref_params, cfg, volume.shape)
        out['control'] = {'field_gap': C.field_gap(
            [C.reference_field(ref_params, cfg, volume.shape, tf32=True)], want)}
    else:
        gaps = []
        for i, _ in run.evidence['outputs']:
            pts = gen.slice_points(run.evidence['params'][i], mix['side'], mix['half_extent'],
                                   device)
            want = C.reference_points(ref_params, cfg, pts)
            got = C.reference_points(ref_params, cfg, pts, tf32=True)
            gaps.append(float((got - want).abs().max()))
        out['control'] = {'query_gap': max(gaps)}
    del run
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True, help='comma-separated')
    ap.add_argument('--seconds', type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('calibrate needs a CUDA card', file=sys.stderr)
        return 2
    cell = S.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(',')):
        print(json.dumps(readings(cell, seed, args.seconds, torch.device('cuda', 0))),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
