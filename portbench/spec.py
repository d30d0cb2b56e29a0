"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root,
the configuration file its entry names, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``.  Adding a cell, a configuration, a mix or a metric
is adding files and entries; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    reader: Callable


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with what it names, read from disk."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_reader(path: Path) -> Callable:
    """``read`` of ``metrics/<name>.py`` (names hold dots, so by path)."""
    spec = importlib.util.spec_from_file_location(f'portbench_metric_{path.stem}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _metrics(entries: List[dict], workload: str, bench_dir: Path):
    out = []
    for m in entries:
        if 'workloads' in m and workload not in m['workloads']:
            continue
        path = bench_dir / 'metrics' / f"{m['name']}.py"
        out.append(Metric(m['name'], m['unit'], _load_reader(path)))
    return out


def load_cell(workload: str, root: Path = ROOT, bench_dir: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; its traffic and
    metric files under ``bench_dir`` (this package's folder by default).
    Raises KeyError for an unknown name, OSError for a missing file."""
    bench_dir = HERE if bench_dir is None else Path(bench_dir)
    bench = json.loads((Path(root) / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[workload]
    configs = {c['name']: c for c in bench['configs']}
    cfg_entry = configs[w['config']]
    config = json.loads((Path(root) / cfg_entry['file']).read_text())
    traffic = json.loads((bench_dir / 'traffic' / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, chips=int(w['chips']), config=config, traffic=traffic,
                end_to_end=_metrics(bench['end_to_end'], workload, bench_dir),
                per_layer=_metrics(bench['per_layer'], workload, bench_dir))


def read_metrics(metrics: List[Metric], run) -> Dict[str, dict]:
    """Each metric's reader on ``run``; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = m.reader(run)
        if value is not None:
            out[m.name] = {'value': float(value), 'unit': m.unit}
    return out
