#!/usr/bin/env python
"""Training CLI of the PyTorch port (counterpart of ``train.py``).

Runs the two-phase training of a config file (the reference's flat
``key = value`` files, unchanged; flags override the file) and writes the
experiment directory: ``info.txt``, ``config.txt``, ``model.npz``,
``binary_model_file`` + ``_mask.bnr``, ``vol.vti`` and ``gt.vti``.  Runs on
the NVIDIA card by default and raises without one; ``--device cpu`` runs the
plain PyTorch path on the CPU.  Float32 convolutions and matmuls are kept
out of TF32.

    python train_torch.py --config experiment-config-files/mhd_p_smallify.txt \
        [--max_pass 6 --expname run1 ...] [--device cpu]

On several devices, one process a device (``--mesh_data a --mesh_space b``,
a * b processes; ``--dist_backend gloo`` lets ranks share a card):

    python -m torch.distributed.run --standalone --nproc_per_node 2 train_torch.py \
        --config experiment-config-files/mhd_p_smallify.txt --mesh_data 2
"""

import argparse

import torch.distributed as dist

from latent_feature_grid_compression_tpu_torch.config import config_from_args
from latent_feature_grid_compression_tpu_torch.device import disable_tf32, resolve_device
from latent_feature_grid_compression_tpu_torch.parallel.distributed import shutdown_distributed
from latent_feature_grid_compression_tpu_torch.train import training


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--dist_backend', type=str, default=None,
                   help="a multi-device run's process-group backend (default: nccl "
                        "on the card, gloo on the CPU; 'gloo' lets ranks share a card)")
    args, rest = p.parse_known_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    cfg = config_from_args(rest)
    print("Finished parsing arguments, starting training")
    # a process group this call starts (under torchrun) ends with it
    started = not dist.is_initialized()
    try:
        return training(cfg, device=device, dist_backend=args.dist_backend)
    finally:
        if started:
            shutdown_distributed()


if __name__ == '__main__':
    main()
