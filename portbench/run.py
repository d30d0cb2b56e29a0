"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the seed it makes the volume and the model's tensors on the card, hands
them to the port, and lets ``generator.py`` drive the cell's traffic: set-up
and warm-up first (``setup_s`` counts from the process's start to the
window's), then ``--seconds`` of measured work.  Once the window has closed
it reads the peak memory, checks that no JAX module was loaded, frees the
port's state and holds what the timed path produced against the plain
reference (``reference/``).  With ``--trace 0`` the metrics are the cell's
end-to-end ones, with ``--trace 1`` its per-layer ones, read from
profiler profiles in the window.  The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last lines
of standard error and the last key of that object.

Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 2; a JAX module loaded in the process exits 3.
"""

from __future__ import annotations

import time

_IMPORTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

import numpy as np  # noqa: E402

from . import spec as S  # noqa: E402

# top-level module names that must not be loaded (compared whole: the port's
# name begins with the JAX package's)
BANNED = ('jax', 'jaxlib', 'flax', 'latent_feature_grid_compression_tpu')
SEED_STREAMS = ('volume', 'weights', 'positions', 'noise', 'queries', 'sample')


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (from
    /proc/self/stat and /proc/uptime), else this module's import."""
    try:
        ticks = int(Path('/proc/self/stat').read_text().rsplit(')', 1)[1].split()[19])
        uptime = float(Path('/proc/uptime').read_text().split()[0])
        age = uptime - ticks / os.sysconf('SC_CLK_TCK')
        return time.perf_counter() - age if 0.0 <= age < 3600.0 else _IMPORTED
    except (OSError, ValueError, IndexError):
        return _IMPORTED


def seeds_of(seed: int) -> Dict[str, int]:
    """A seed of each stream, all drawn from ``seed``."""
    state = np.random.SeedSequence(seed).generate_state(len(SEED_STREAMS), dtype=np.uint64)
    return {name: int(s) >> 1 for name, s in zip(SEED_STREAMS, state)}


def loaded_banned() -> List[str]:
    return sorted(m for m in sys.modules if m.split('.')[0] in BANNED)


def limits_of(cell: S.Cell, bench_dir: Path) -> Dict[str, float]:
    return json.loads((bench_dir / 'limits' / f'{cell.name}.json').read_text())


def judge(run, cell: S.Cell, volume, ref_params, seeds) -> Dict[str, float]:
    """The numbers compared for the cell's kind (``reference/check.py``)."""
    from . import generator as gen
    from .reference import check as C
    from .reference import model as R
    cfg, mix = cell.config, cell.traffic
    if run.kind == 'train':
        p0 = [t for _, t in R.leaves(ref_params, cfg['drop_type'])]
        ref = C.train_reference(ref_params, cfg, volume, seeds, mix['checked_steps'],
                                mix['steps_per_chunk'])
        return C.train_numbers(C.program_train_side(run.evidence, p0), ref, p0)
    if run.kind == 'decompress':
        want = C.reference_field(ref_params, cfg, volume.shape)
        return {'field_gap': C.field_gap(run.evidence['fields'], want)}
    gaps = []
    for i, out in run.evidence['outputs']:
        pts = gen.slice_points(run.evidence['params'][i], mix['side'], mix['half_extent'],
                               volume.device)
        gaps.append(float((out[:, 0] - C.reference_points(ref_params, cfg, pts)).abs().max()))
    return {'query_gap': max(gaps)}


def run_cell(cell: S.Cell, seed: int, seconds: float, trace: bool, device,
             started: float, bench_dir: Path = S.HERE) -> Tuple[dict, object]:
    """Set up, drive and judge one run: (the result object, the
    ``generator.Run``).  ``device`` is the card (the CPU only in
    the benchmark's own tests)."""
    import torch
    from latent_feature_grid_compression_tpu_torch.device import disable_tf32
    from . import generator as gen
    from .volume import mhd_like
    from .weights import clone, make_params
    disable_tf32()
    cfg, mix = cell.config, cell.traffic
    seeds = seeds_of(seed)
    vol_cfg = cfg['volume']
    volume = mhd_like(vol_cfg['n'], vol_cfg['octaves'], seeds['volume'], device)
    params = make_params(cfg, seeds['weights'], device, pruned=mix['kind'] != 'train')
    ref_params = clone(params)
    if trace and device.type == 'cuda':
        from .profile import warm
        warm(device)
    ctx = gen.Context(config=cfg, traffic=mix, seconds=seconds, trace=trace, device=device,
                      volume=volume, params=params, seeds=seeds, process_start=started)
    run = gen.KINDS[mix['kind']](ctx)
    on_card = device.type == 'cuda'
    run.device_kind = torch.cuda.get_device_name(device) if on_card else 'cpu'
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    banned = loaded_banned()
    if banned:
        raise SystemExit(f'JAX modules were loaded in the run: {banned}')
    del ctx, params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = judge(run, cell, volume, ref_params, seeds)
    limits = limits_of(cell, bench_dir)
    checks = {k: {'value': v, 'limit': limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    metrics = S.read_metrics(cell.per_layer if trace else cell.end_to_end, run)
    dev = {'platform': 'gpu' if on_card else 'cpu', 'kind': run.device_kind,
           'count': cell.chips, 'memory_peak_bytes': int(peak)}
    result = {'correct': correct, 'attempted': run.attempted, 'failed': run.failed,
              'metrics': metrics, 'device': dev}
    if trace and run.profiles:
        s = run.trace or run.profiles[-1]
        dev['busy_s'], dev['window_s'] = s.busy_s, s.window_s
        from .profile import breakdown
        result['breakdown'] = breakdown(s)
    result['checks'] = checks
    return result, run


def _report(run, checks: Dict[str, dict]):
    """The earlier stderr lines: what the window did; then, last, each number
    compared beside its limit."""
    err = sys.stderr
    print(f'window: {run.units} {run.kind} units in {run.window_s:.4f} s, set-up '
          f'{run.setup_s:.4f} s, phases {run.phases}', file=err)
    if run.latencies_s:
        lat = sorted(run.latencies_s)
        print(f'requests: {len(lat)}; latency p50 {1e3 * lat[len(lat) // 2]:.4f} ms, '
              f'max {1e3 * lat[-1]:.4f} ms', file=err)
    if run.chunk_s:
        q = np.percentile(np.asarray(run.chunk_s) * 1e3, [0, 10, 50, 90, 100])
        print('chunks: ' + ', '.join(f'{v:.3f}' for v in q) + ' ms (min, p10, p50, p90, max)',
              file=err)
    for s in run.profiles:
        print(f'profiled: {s.units} units, {s.window_s:.4f} s, busy {s.busy_s:.4f} s, '
              f'complete {s.complete()} {s.missing() or ""}', file=err)
    for name, c in checks.items():
        verdict = 'ok' if c['value'] <= c['limit'] else 'FAILS'
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=err)


def main(argv: Optional[List[str]] = None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = S.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA card(s); this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    try:
        result, run = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                               torch.device('cuda', 0), started)
    except SystemExit as e:
        print(str(e), file=sys.stderr)
        return 3
    _report(run, result['checks'])
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
