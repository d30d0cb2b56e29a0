"""Top-level training entry (port of the JAX package's ``train/run.py``).

training(cfg) -> info dict:
  load + normalize volume -> build model (or warm-start from
  ``cfg.checkpoint_path``) and, for dynamic variational dropout, the
  variance model -> phase 1 (gates + their loss, 2/3 of max_pass)
  -> bake the gate values into the grid -> phase 2 (finetune at lr/10 under
  the frozen masks, 1/3 of max_pass) -> hard prune -> full-volume
  evaluation, compression accounting, ``model.npz``, the packed binary
  container and the info/config artifacts.

The experiment directory doubles as the resume location, as in the JAX
package: ``resume_meta.txt`` names the phase in progress (1, 2, then
``done``), ``train_state_phase{1,2}.npz`` hold each phase's state and
generators (saved at most every minute and at the phase's end), and
``bake.npz`` the frozen masks and the zero count.  ``cfg.resume`` points a
run at such a directory; ``cfg.profile_dir`` takes a profiler trace of
phase 1's second chunk; the TensorBoard writer (tensorboardX, else
``torch.utils.tensorboard``, else none) logs into ``cfg.Tensorboard_log_dir``
or ``runs/<expname>``.  On a card each phase's steps are replays of its
step graph, alone and on an NCCL mesh (``trainer.use_step_graphs``); the
info counts each phase's captures.

Runs on ``device='cuda'`` unless the caller passes ``'cpu'``.

Multi-device: with ``mesh_data * mesh_space > 1`` the run is one process a
device, launched by ``python -m torch.distributed.run --nproc_per_node K``
(K = mesh_data * mesh_space, else it raises); every rank trains on its
device (``cuda:LOCAL_RANK``; NCCL, or gloo asked for by name through
``dist_backend='gloo'``, the only way two ranks may share a card) with the
volume's x-slab under a space axis, while the whole volume stays in host
memory for the evaluation.  Rank 0 alone writes the experiment directory
(``resume_meta.txt``, the train states, ``bake.npz``, the writer's logs, the
evaluation's artifacts); every rank leaves with the same model and info.
Three paths the JAX package takes silently raise here: tile-local decode
(``mesh_local_decode``) under a backend other than 'xla', under the bf16
compute path, the fused MLP or the one-kernel forward, and on a volume
whose X the space axis does not divide.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrainConfig, dict_from_file, write_dict
from ..data.volume import VolumeMeta, load_volume
from ..device import resolve_device
from ..eval.reconstruct import tiled_net_out
from ..io.checkpoint import load_checkpoint, save_checkpoint
from ..io.container import store_model_parameters
from ..io.train_state_io import load_train_state
from ..models import gates as G
from ..models.feature_grid import (FeatureGridModel, check_local_decode, init_model,
                                   make_spec, num_net_params, remove_drop_layers,
                                   save_dropvalues_on_grid)
from ..models.variance import init_variance_model
from ..parallel import mesh as pm
from ..parallel.distributed import initialize_distributed, rank_device
from ..utils.profiling import counters
from .trainer import init_train_state, make_phase_spec, solve_phase, state_to_model


def _check_local_decode(cfg: TrainConfig, meta: VolumeMeta, spec):
    """Tile-local decode needs a space axis that divides the volume's X and
    the float32 'xla' path; the JAX package drops it or changes backend
    silently where this raises."""
    if cfg.mesh_space <= 1:
        raise ValueError("mesh_local_decode needs mesh_space > 1")
    if meta.resolution[0] % cfg.mesh_space:
        raise ValueError(f"mesh_local_decode: the volume's X {meta.resolution[0]} does "
                         f"not divide mesh_space {cfg.mesh_space}")
    if cfg.interp_backend != 'xla':
        raise ValueError(f"mesh_local_decode needs interp_backend 'xla'; got "
                         f"{cfg.interp_backend!r}")
    check_local_decode(spec)


def _build_mesh(cfg: TrainConfig, meta: VolumeMeta, spec, device: torch.device,
                backend: Optional[str], verbose: bool):
    """(the mesh or None, whether the volume is cut over 'space', this
    rank's device).  Starts the process group (``backend``, None: the
    device's default) from the launcher's environment; the mesh must have
    as many ranks as it."""
    if cfg.mesh_local_decode:
        _check_local_decode(cfg, meta, spec)
    want = cfg.mesh_data * cfg.mesh_space
    initialize_distributed(backend=backend, device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if want != world:
        raise ValueError(
            f"mesh_data * mesh_space = {cfg.mesh_data} * {cfg.mesh_space} needs {want} "
            f"processes, one a device, and this run has {world}: launch it with "
            f"torchrun --nproc_per_node {want} (python -m torch.distributed.run)")
    if want == 1:
        return None, False, device
    dev = rank_device(device, backend, verbose=verbose)
    mesh = pm.make_mesh(cfg.mesh_data, cfg.mesh_space, device=dev)
    use_space = cfg.mesh_space > 1 and meta.resolution[0] % cfg.mesh_space == 0
    if verbose and mesh.rank == 0:
        print(f"Mesh: data={mesh.data} x space={mesh.space} ({want} ranks, "
              f"{mesh.backend} on {dev.type}), volume "
              f"{'x-slab sharded' if use_space else 'replicated'}"
              f"{', state sharded over space' if cfg.mesh_shard_params else ''}"
              f"{', tile-local decode' if cfg.mesh_local_decode else ''}", flush=True)
    return mesh, use_space, dev


def experiment_dir(cfg: TrainConfig) -> str:
    """``cwd + basedir + expname``, as the reference joins them."""
    return os.path.abspath(os.getcwd()) + cfg.basedir + cfg.expname + '/'


def _make_writer(cfg: TrainConfig):
    """A TensorBoard ``SummaryWriter`` (tensorboardX's, else PyTorch's; None
    when neither package is installed) into ``cfg.Tensorboard_log_dir``,
    with the config written beside it, else into ``runs/<expname>`` under
    the working directory."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    if cfg.Tensorboard_log_dir:
        writer = SummaryWriter(cfg.Tensorboard_log_dir)
        write_dict(cfg.to_dict(), 'config.txt', cfg.Tensorboard_log_dir)
    else:
        writer = SummaryWriter('runs/' + cfg.expname)
    return writer


def evaluate_model_training(model: FeatureGridModel, meta: VolumeMeta,
                            volume_np: np.ndarray, zeros: float, cfg: TrainConfig,
                            writer=None, verbose: bool = True, write_vols: bool = True,
                            volume_dev: Optional[torch.Tensor] = None,
                            device: str | torch.device = 'cuda') -> dict:
    """Final evaluation and the artifacts: ``info.txt``, ``config.txt``,
    ``model.npz``, ``binary_model_file`` + ``_mask.bnr`` and, with
    ``write_vols``, ``vol.vti`` and ``gt.vti``; the evaluation's scalars
    to ``writer`` when given."""
    experiment_path = experiment_dir(cfg)
    os.makedirs(experiment_path, exist_ok=True)

    captured = counters().get('graph_captures.eval', 0)
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
        # one a reconstruction whose chunks were replays of a captured graph
        'eval_graph_captures': counters().get('graph_captures.eval', 0) - captured,
    }
    if writer is not None:
        for tag, value in (('compression_ratio', compression_ratio), ('zeroes', zeros),
                           ('psnr', psnr), ('mse', mse), ('rmse', rmse),
                           ('compr_rmse', compr_rmse)):
            writer.add_scalar(tag, value)

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


def _resume_point(cfg: TrainConfig, verbose: bool) -> Tuple[int, str]:
    """(the phase to resume, the directory to resume from); (0, '') without
    ``cfg.resume``.  ``cfg.resume`` is an experiment directory or a file in
    it; a run that finished raises."""
    if not cfg.resume:
        return 0, ''
    resume_dir = cfg.resume if os.path.isdir(cfg.resume) else os.path.dirname(cfg.resume)
    phase = dict_from_file(os.path.join(resume_dir, 'resume_meta.txt'))['phase']
    if phase == 'done':
        raise ValueError(f"{resume_dir} finished training (resume_meta phase=done); "
                         f"use --checkpoint_path for a warm start instead")
    if verbose:
        print(f"Resuming phase {phase} from {resume_dir}")
    return int(phase), resume_dir


def _save_bake(experiment_path: str, masks, zeros: float):
    """The frozen masks and the zero count of the bake, with the JAX
    package's keys (``zeros``, ``mask_{i}``)."""
    arrs = {} if masks is None else {f'mask_{i}': m.cpu().numpy()
                                     for i, m in enumerate(masks)}
    np.savez(os.path.join(experiment_path, 'bake.npz'), zeros=np.float64(zeros), **arrs)


def _load_bake(resume_dir: str, device: torch.device):
    with np.load(os.path.join(resume_dir, 'bake.npz'), allow_pickle=False) as z:
        zeros = float(z['zeros'])
        n = sum(1 for k in z.files if k.startswith('mask_'))
        masks = ([torch.from_numpy(z[f'mask_{i}']).to(device=device, dtype=torch.float32)
                  for i in range(n)] if n else None)
    return masks, zeros


def _chunk_rates(counted: Dict[str, int], samples_per_step: int) -> Dict[str, float]:
    """Training rates from the rise of the chunk counters over a run
    (``ChunkRunner.chunk``: steps, and ns from each chunk's load to the end
    of its device read), over every chunk but each phase's first (kernel
    builds, library initialisation, the capture), whose seconds are given
    apart; over the first chunks where there are no others."""
    first_ns = counted.get('first_chunk_ns.train', 0)
    if not first_ns:
        return {}
    steps, ns = counted.get('chunk_steps.train', 0), counted.get('chunk_ns.train', 0)
    if not steps:
        steps, ns = counted.get('first_chunk_steps.train', 0), first_ns
    secs = ns * 1e-9
    return {
        'steps_per_sec': steps / secs if secs else 0.0,
        'samples_per_sec': steps * samples_per_step / secs if secs else 0.0,
        'ms_per_step': secs / steps * 1e3 if steps else 0.0,
        'first_chunks_sec': first_ns * 1e-9,
    }


def training(cfg: TrainConfig, verbose: bool = True,
             volume_np: Optional[np.ndarray] = None, write_vols: bool = True,
             device: str | torch.device = 'cuda',
             positions: Tuple[Optional[Iterator], Optional[Iterator]] = (None, None),
             gate_noise: Optional[Iterator] = None,
             variance_model=None, dist_backend: Optional[str] = None) -> dict:
    """Full two-phase training run; returns the info dict.

    positions: per phase, an optional iterator of (N, 3) integer voxel
    positions used in place of the phase's generator.  gate_noise: an
    optional iterator of phase 1's per-level gate noise (a list a step) in
    place of its generator.  variance_model: (weights, biases) to start the
    dynamic family's variance model from, in place of its init.  On a mesh
    ``positions`` yields this rank's positions (in its slab), and every
    rank returns rank 0's info with its own timings.  dist_backend: the
    process group's backend (None: nccl on the card, gloo on the CPU;
    'gloo' lets ranks share a card)."""
    dev = resolve_device(device)
    if volume_np is None:
        volume_np = load_volume(cfg.data)
    meta = VolumeMeta(tuple(volume_np.shape))

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
    mesh, use_space, dev = _build_mesh(cfg, meta, spec, dev, dist_backend, verbose)
    lead = mesh is None or mesh.rank == 0
    verbose = verbose and lead
    if mesh is None:
        volume = torch.from_numpy(np.ascontiguousarray(volume_np, dtype=np.float32)).to(dev)
    else:
        # the whole volume stays on the host for the evaluation
        volume = pm.shard_volume(mesh, volume_np, use_space)
    mesh_kw = dict(mesh=mesh, use_space=use_space,
                   shard_params=bool(cfg.mesh_shard_params) and mesh is not None,
                   local_decode=bool(cfg.mesh_local_decode))
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
    if lead:
        os.makedirs(experiment_path, exist_ok=True)
    resume_phase, resume_dir = _resume_point(cfg, verbose)
    phase_stats, counted = {}, counters()
    writer = _make_writer(cfg) if lead else None

    def run_phase(phase, state, masks, gate_noise=None, profile_dir=''):
        ph = make_phase_spec(cfg, spec, meta, phase=phase)
        # the positions' generator is the rank's own, the gate noise's the
        # same on every rank
        generators = (_phase_generator(cfg.seed, phase, dev,
                                       () if mesh is None else (0, mesh.rank)),
                      _phase_generator(cfg.seed, phase, dev, (1,)))
        save_path = os.path.join(experiment_path, f'train_state_phase{phase}.npz')
        if resume_phase == phase:
            state = load_train_state(
                os.path.join(resume_dir, f'train_state_phase{phase}.npz'), state,
                generators, mesh_shape=None if mesh is None else (mesh.data, mesh.space),
                rank=0 if mesh is None else mesh.rank)
        if lead:
            write_dict({'phase': phase}, 'resume_meta.txt', experiment_path)
        losses, vol_losses = [], []
        start = state.step
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        captured = counters().get('graph_captures.train', 0)
        # solve_phase ends in a device read: the wall time is the card's
        state = solve_phase(ph, state, volume, cfg.steps_per_chunk, masks,
                            generator=generators[0], positions=positions[phase - 1],
                            noise_generator=generators[1], gate_noise=gate_noise,
                            verbose=verbose, metric_cb=losses.append,
                            volume_cb=vol_losses.append, writer=writer,
                            state_save_path=save_path,
                            profile_dir=profile_dir if lead else '', **mesh_kw)
        seconds = time.perf_counter() - t0
        steps = state.step - start
        phase_stats.update({
            f'phase{phase}_steps': steps, f'phase{phase}_seconds': seconds,
            f'phase{phase}_samples_per_sec': steps * ph.batch_n / seconds,
            # 1 where the phase's steps were replays of its step graph
            f'phase{phase}_graph_captures':
                counters().get('graph_captures.train', 0) - captured})
        for name, values in (('loss', losses), ('volume_loss', vol_losses)):
            values = np.concatenate(values) if values else np.zeros(0)
            phase_stats[f'phase{phase}_first_{name}'] = float(values[0]) if steps else None
            phase_stats[f'phase{phase}_last_{name}'] = float(values[-1]) if steps else None
        return state

    try:
        # --- phase 1: gated training -------------------------------------
        state = init_train_state(model, lr=cfg.lr, shadow_lr=cfg.lr,
                                 train_gates=bool(spec.drop_type), variance=variance,
                                 weight_dkl=cfg.lambda_drop_loss)
        if resume_phase < 2:
            state = run_phase(1, state, None, gate_noise, cfg.profile_dir)
            model = state_to_model(state, model)
            # --- bake the gates into the grid ----------------------------
            model, masks, zeros = save_dropvalues_on_grid(model)
        else:
            # phase 2 takes only the shapes of the model's tensors from
            # here (its state comes from the file), and the pruning drops
            # the gates
            masks, zeros = _load_bake(resume_dir, dev)
        # (also when resumed, so that this run's directory resumes alone)
        if lead:
            _save_bake(experiment_path, masks, zeros)

        # --- phase 2: finetune at lr/10 under the frozen masks -------------
        # (without the variance model: its gradient there is 0, so is its
        # update)
        state2 = init_train_state(model, lr=cfg.lr / 10.0,
                                  shadow_lr=float(state.shadow_lr), train_gates=False)
        # the plateau state carries over (the reference reuses its strategy)
        state2.last_loss, state2.no_gain = state.last_loss, state.no_gain
        state2 = run_phase(2, state2, masks)
        model = state_to_model(state2, model)

        # --- hard prune + evaluate (rank 0) --------------------------------
        model = remove_drop_layers(model, masks)
        info = None
        if lead:
            info = evaluate_model_training(
                model, meta, volume_np, zeros, cfg, writer=writer, verbose=verbose,
                write_vols=write_vols, volume_dev=volume if mesh is None else None,
                device=dev)
    finally:
        if writer is not None:
            writer.close()
    if mesh is not None:
        # the other ranks wait here for rank 0's evaluation
        shared = [info]
        dist.broadcast_object_list(shared, src=0)
        info = shared[0]
    rates = _chunk_rates({k: v - counted.get(k, 0) for k, v in counters().items()},
                         cfg.batch_size * cfg.sample_size)
    info.update({'train_' + k: v for k, v in rates.items()})
    info.update({'train_' + k: v for k, v in phase_stats.items()})
    if lead:
        write_dict(info, 'info.txt', experiment_path)
        write_dict({'phase': 'done'}, 'resume_meta.txt', experiment_path)
    pm.barrier(mesh)
    return info
