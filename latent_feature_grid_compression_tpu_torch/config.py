"""Training configuration: flag schema + ``key = value`` config files.

The PyTorch port's own copy of the JAX package's ``config.py``: the same
fields and defaults, the type-inferring ``dict_from_file`` parser, and the
precedence CLI > config file > defaults.  Files written by either package's
trainer load here unchanged; unknown keys (run artifacts such as ``psnr``)
are ignored.  Some fields select paths the port has not ported yet; the
trainer raises on them (``train/run.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional


@dataclasses.dataclass
class TrainConfig:
    expname: str = ''
    data: str = ''
    basedir: str = '/experiments/'
    Tensorboard_log_dir: str = ''

    batch_size: int = 1024
    sample_size: int = 16
    num_workers: int = 8           # accepted for config parity; sampling is on-device

    max_pass: int = 75
    lr: float = 0.008
    pass_decay: int = 20
    lr_decay: float = 0.2
    smallify_decay: int = 0

    lambda_drop_loss: float = 1e-8
    lambda_weight_loss: float = 1e-8

    weight_dkl_multiplier: float = 5e-4
    variational_sigma: float = -7.0

    d_in: int = 3
    d_out: int = 1
    n_hidden_size: int = 32
    n_layers: int = 4
    checkpoint_path: str = ''
    binary_checkpoint_path: str = ''

    embedding_type: str = 'fourier'
    n_embedding_freq: int = 2
    drop_type: str = 'smallify'
    drop_momentum: float = 0.025
    drop_threshold: float = 0.75
    pruning_threshold_list: Optional[List[float]] = None

    wavelet_filter: str = 'db2'
    grid_features: int = 16
    grid_size: int = 32

    # extensions of the JAX package (absent in the reference)
    seed: int = 0
    steps_per_chunk: int = 200      # steps between the trainer's host reads
    mesh_data: int = 1              # data-parallel mesh axis size
    mesh_space: int = 1             # volume-sharding mesh axis size
    mesh_shard_params: int = 0      # 1: shard model/optimizer state over
                                    # 'space' (ZeRO-style grid-tile sharding)
    mesh_local_decode: int = 0      # 1: each device decodes only its grid
                                    # x-tile (+halo)
    compute_dtype: str = 'float32'  # 'bfloat16': the bf16 compute path
                                    # (the fetch in 'bf16', the bf16 MLP
                                    # chain, the one-kernel forward in 'bf16')
    interp_backend: str = 'auto'    # 'auto' | 'xla' | 'pallas': the fetch
                                    # kernels; 'pallas_bf16': the fetch
                                    # kernels in 'bf16'; 'fused': one kernel
                                    # for fetch, embedding and MLP
    mlp_backend: str = 'xla'        # 'xla': the MLP as PyTorch ops;
                                    # 'pallas': the fused MLP kernels
    rng_impl: str = 'rbg'           # the JAX package's key type; the port
                                    # draws from a torch.Generator
    profile_dir: str = ''           # profiler trace output dir
    resume: str = ''                # experiment dir with a mid-training
                                    # train-state checkpoint to resume from

    def to_dict(self):
        d = dataclasses.asdict(self)
        return d


_FIELDS = {f.name: f for f in dataclasses.fields(TrainConfig)}


def _coerce(name: str, value):
    """Coerce a string value to the field's type (dict_from_file semantics)."""
    f = _FIELDS[name]
    if not isinstance(value, str):
        return value
    v = value.strip().strip("'\"")
    if f.type in ('int', int):
        return int(v)
    if f.type in ('float', float):
        return float(v)
    if name == 'pruning_threshold_list':
        if not v or v in ('None',):
            return None
        v = v.replace('[', '').replace(']', '')
        return [float(x) for x in v.split(',') if x.strip()]
    return v


def dict_from_file(filename: str) -> dict:
    """Parse flat ``key = value`` files with int/float/list/str inference
    (exact semantics of visualization/pltUtils.py:24-63, incl. whitespace
    stripping)."""
    d = {}
    with open(filename) as fh:
        for line in fh:
            line = line.replace(' ', '').replace('\n', '')
            parts = line.split('=')
            if len(parts) <= 1:
                continue
            value: object = parts[1]
            try:
                value = int(parts[1])
            except ValueError:
                try:
                    value = float(parts[1])
                except ValueError:
                    if ',' in parts[1]:
                        s = parts[1].replace('[', '').replace(']', '')
                        items = s.split(',')
                        try:
                            value = [int(x) for x in items]
                        except ValueError:
                            value = [float(x) for x in items]
                    elif parts[1] in ('True', 'False'):
                        value = bool(parts[1])
                    else:
                        value = parts[1]
            d[parts[0]] = value
    return d


def write_dict(dictionary: dict, filename: str, experiment_path: str = ''):
    """Emit ``key = value`` lines (model_utils.py:17-20)."""
    with open(os.path.join(experiment_path, filename), 'w') as f:
        for key, value in dictionary.items():
            f.write('%s = %s\n' % (key, value))


def load_config(config_path: Optional[str] = None, overrides: Optional[dict] = None,
                **kwargs) -> TrainConfig:
    """Build a TrainConfig from (defaults <- config file <- overrides)."""
    cfg = TrainConfig()
    merged = {}
    if config_path:
        merged.update(dict_from_file(config_path))
    if overrides:
        merged.update(overrides)
    merged.update(kwargs)
    for k, v in merged.items():
        if k in _FIELDS:
            setattr(cfg, k, _coerce(k, v) if isinstance(v, str) else v)
        # unknown keys ignored (config files carry run artifacts like psnr)
    return cfg


def config_parser() -> argparse.ArgumentParser:
    """CLI with the reference's flag names (Feature_Grid_Training.py:4-68)."""
    p = argparse.ArgumentParser()
    p.add_argument('--config', type=str, default=None, help='config file path')
    for f in dataclasses.fields(TrainConfig):
        if f.name == 'pruning_threshold_list':
            p.add_argument('--pruning_threshold_list', type=float, nargs='+',
                           default=None)
            continue
        ftype = {int: int, float: float, str: str}.get(
            f.type if not isinstance(f.type, str)
            else {'int': int, 'float': float, 'str': str}.get(f.type, str), str)
        p.add_argument(f'--{f.name}', type=ftype, default=None)
    return p


def config_from_args(argv=None) -> TrainConfig:
    args = vars(config_parser().parse_args(argv))
    config_path = args.pop('config', None)
    overrides = {k: v for k, v in args.items() if v is not None}
    return load_config(config_path, overrides)
