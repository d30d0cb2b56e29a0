"""Top-level training entry (port of the JAX package's ``train/run.py``,
single device).

training(cfg) -> info dict:
  load + normalize volume -> build model (or warm-start from
  ``cfg.checkpoint_path``) and, for dynamic variational dropout, the
  variance model -> phase 1 (gates + their loss, 2/3 of max_pass)
  -> bake the gate values into the grid -> phase 2 (finetune at lr/10 under
  the frozen masks, 1/3 of max_pass) -> hard prune -> full-volume
  evaluation, compression accounting, ``model.npz``, the packed binary
  container and the info/config artifacts.

Runs on ``device='cuda'`` unless the caller passes ``'cpu'``.  Options whose
paths are not ported raise "not yet ported" and name the ROADMAP item.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import TrainConfig, write_dict
from ..data.volume import VolumeMeta, load_volume
from ..device import resolve_device
from ..eval.reconstruct import tiled_net_out
from ..io.checkpoint import load_checkpoint, save_checkpoint
from ..io.container import store_model_parameters
from ..models import gates as G
from ..models.feature_grid import (FeatureGridModel, init_model, make_spec,
                                   num_net_params, remove_drop_layers,
                                   save_dropvalues_on_grid)
from ..models.variance import init_variance_model
from .trainer import (StepTimer, init_train_state, make_phase_spec, solve_phase,
                      state_to_model)


def check_ported(cfg: TrainConfig):
    """Raise on every option whose path the port does not have yet."""
    if cfg.resume:
        raise ValueError("resume is not yet ported (train-state checkpoints, "
                         "ROADMAP Queue 1 item 6)")
    if cfg.profile_dir:
        raise ValueError("profile_dir is not yet ported (ROADMAP Queue 1 item 6)")
    if cfg.mesh_data * cfg.mesh_space > 1 or cfg.mesh_shard_params \
            or cfg.mesh_local_decode:
        raise ValueError("multi-device training is not yet ported "
                         "(ROADMAP Queue 1 item 5)")
    # an unknown compute dtype, backend or drop type raises in make_spec


def experiment_dir(cfg: TrainConfig) -> str:
    """``cwd + basedir + expname``, as the reference joins them."""
    return os.path.abspath(os.getcwd()) + cfg.basedir + cfg.expname + '/'


def evaluate_model_training(model: FeatureGridModel, meta: VolumeMeta,
                            volume_np: np.ndarray, zeros: float, cfg: TrainConfig,
                            verbose: bool = True, write_vols: bool = True,
                            volume_dev: Optional[torch.Tensor] = None,
                            device: str | torch.device = 'cuda') -> dict:
    """Final evaluation and the artifacts: ``info.txt``, ``config.txt``,
    ``model.npz``, ``binary_model_file`` + ``_mask.bnr`` and, with
    ``write_vols``, ``vol.vti`` and ``gt.vti``."""
    experiment_path = experiment_dir(cfg)
    os.makedirs(experiment_path, exist_ok=True)

    psnr, l1_diff, mse, rmse = tiled_net_out(
        model, meta, gt_vol=volume_np, evaluate=True, write_vols=write_vols,
        filename=os.path.join(experiment_path, 'vol') if write_vols else 'vol',
        device=device, gt_dev=volume_dev)

    n_params = num_net_params(model)
    compression_ratio = meta.n_voxels / (n_params - zeros)
    compr_rmse = compression_ratio / rmse if rmse > 0 else float('inf')
    if verbose:
        print("Trained Model:", n_params, "parameters;", zeros,
              "of them Zero;", compression_ratio, "compression ratio")
    info = {
        'volume_size': list(meta.resolution),
        'volume_num_voxels': meta.n_voxels,
        'num_parameters': n_params,
        'num_zeros': zeros,
        'compression_ratio': compression_ratio,
        'psnr': psnr,
        'l1_diff': l1_diff,
        'mse': mse,
        'rmse': rmse,
        'compr_rmse': compr_rmse,
    }

    ckpt_path = os.path.join(experiment_path, 'model.npz')
    save_checkpoint(ckpt_path, model)
    cfg.checkpoint_path = ckpt_path
    bin_path = os.path.join(experiment_path, 'binary_model_file')
    store_model_parameters(model, bin_path)
    cfg.binary_checkpoint_path = bin_path

    write_dict(info, 'info.txt', experiment_path)
    write_dict(cfg.to_dict(), 'config.txt', experiment_path)
    return info


def _phase_generator(seed: int, phase: int, device: torch.device,
                     stream: Tuple[int, ...] = ()) -> torch.Generator:
    """A generator of one phase on the training device: the positions'
    (``stream`` ()), or the gate noise's (``stream`` (1,))."""
    return torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed, phase, *stream]).generate_state(1)[0]))


def training(cfg: TrainConfig, verbose: bool = True,
             volume_np: Optional[np.ndarray] = None, write_vols: bool = True,
             device: str | torch.device = 'cuda',
             positions: Tuple[Optional[Iterator], Optional[Iterator]] = (None, None),
             gate_noise: Optional[Iterator] = None,
             variance_model=None) -> dict:
    """Full two-phase training run; returns the info dict.

    positions: per phase, an optional iterator of (N, 3) integer voxel
    positions used in place of the phase's generator.  gate_noise: an
    optional iterator of phase 1's per-level gate noise (a list a step) in
    place of its generator.  variance_model: (weights, biases) to start the
    dynamic family's variance model from, in place of its init."""
    check_ported(cfg)
    dev = resolve_device(device)
    if volume_np is None:
        volume_np = load_volume(cfg.data)
    meta = VolumeMeta(tuple(volume_np.shape))
    volume = torch.from_numpy(np.ascontiguousarray(volume_np, dtype=np.float32)).to(dev)

    spec = make_spec(d_in=cfg.d_in, hidden=cfg.n_hidden_size, d_out=cfg.d_out,
                     num_layers=cfg.n_layers, n_freqs=cfg.n_embedding_freq,
                     grid_features=cfg.grid_features, grid_size=cfg.grid_size,
                     wavelet=cfg.wavelet_filter, drop_type=cfg.drop_type,
                     drop_momentum=cfg.drop_momentum,
                     drop_threshold=cfg.drop_threshold,
                     pruning_threshold_list=cfg.pruning_threshold_list,
                     interp_backend=cfg.interp_backend,
                     compute_dtype=cfg.compute_dtype,
                     mlp_backend=cfg.mlp_backend)
    # one init generator: the model (grid, MLP, gates), then the variance model
    init_gen = torch.Generator().manual_seed(cfg.seed)
    model = init_model(spec, init_gen, device=dev)
    variance = None
    if G.is_dynamic(spec.drop_type):
        variance = variance_model or init_variance_model(init_gen, cfg.d_in, 1, 4, 32)
        variance = tuple([torch.as_tensor(t, dtype=torch.float32).to(dev) for t in ts]
                         for ts in variance)
    if cfg.checkpoint_path:
        model = load_checkpoint(cfg.checkpoint_path, spec, device=dev, model=model)

    experiment_path = experiment_dir(cfg)
    os.makedirs(experiment_path, exist_ok=True)
    timers, phase_stats = [], {}

    def run_phase(phase, state, masks, gate_noise=None):
        ph = make_phase_spec(cfg, spec, meta, phase=phase)
        timers.append(StepTimer(ph.batch_n))
        losses, vol_losses = [], []
        start = state.step
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        # solve_phase ends in a device read: the wall time is the card's
        state = solve_phase(ph, state, volume, cfg.steps_per_chunk, masks,
                            generator=_phase_generator(cfg.seed, phase, dev),
                            positions=positions[phase - 1],
                            noise_generator=_phase_generator(cfg.seed, phase, dev, (1,)),
                            gate_noise=gate_noise, verbose=verbose,
                            timer=timers[-1], metric_cb=losses.append,
                            volume_cb=vol_losses.append)
        seconds = time.perf_counter() - t0
        steps = state.step - start
        phase_stats.update({
            f'phase{phase}_steps': steps, f'phase{phase}_seconds': seconds,
            f'phase{phase}_samples_per_sec': steps * ph.batch_n / seconds})
        for name, values in (('loss', losses), ('volume_loss', vol_losses)):
            values = np.concatenate(values) if values else np.zeros(0)
            phase_stats[f'phase{phase}_first_{name}'] = float(values[0]) if steps else None
            phase_stats[f'phase{phase}_last_{name}'] = float(values[-1]) if steps else None
        return state

    # --- phase 1: gated training -----------------------------------------
    state = init_train_state(model, lr=cfg.lr, shadow_lr=cfg.lr,
                             train_gates=bool(spec.drop_type), variance=variance,
                             weight_dkl=cfg.lambda_drop_loss)
    state = run_phase(1, state, None, gate_noise)
    model = state_to_model(state, model)

    # --- bake the gates into the grid ------------------------------------
    model, masks, zeros = save_dropvalues_on_grid(model)

    # --- phase 2: finetune at lr/10 under the frozen masks -----------------
    # (without the variance model: its gradient there is 0, so is its update)
    state2 = init_train_state(model, lr=cfg.lr / 10.0,
                              shadow_lr=float(state.shadow_lr), train_gates=False)
    # the plateau state carries over (the reference reuses its strategy)
    state2.last_loss, state2.no_gain = state.last_loss, state.no_gain
    state2 = run_phase(2, state2, masks)
    model = state_to_model(state2, model)

    # --- hard prune + evaluate ---------------------------------------------
    model = remove_drop_layers(model, masks)
    info = evaluate_model_training(model, meta, volume_np, zeros, cfg,
                                   verbose=verbose, write_vols=write_vols,
                                   volume_dev=volume, device=dev)
    info.update({'train_' + k: v
                 for k, v in StepTimer.merge(timers).stats().items()})
    info.update({'train_' + k: v for k, v in phase_stats.items()})
    write_dict(info, 'info.txt', experiment_path)
    return info

