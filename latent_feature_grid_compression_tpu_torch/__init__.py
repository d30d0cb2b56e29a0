"""latent_feature_grid_compression_tpu_torch — the PyTorch/CUDA port of
``latent_feature_grid_compression_tpu`` for NVIDIA Hopper (H100).

The port mirrors the JAX package's module layout so every module has a
counterpart there, and is held against it by ``tests/test_torch_*.py``.  It
imports ``torch`` and never ``jax`` nor anything of the JAX package.

Ported so far: the decompression path (npz checkpoint or packed binary
container -> wavelet decode -> trilinear feature fetch, a hand-written CUDA
kernel on the card -> Fourier embedding + SnakeAlt MLP -> full-volume PSNR),
single-device smallify training (the fetch's grid gradient a CUDA kernel
too), and the two kernel backends of the model forward: the fused SnakeAlt
MLP (``mlp_backend='pallas'``) and the one-kernel fetch + embedding + MLP
(``interp_backend='fused'``), each a CUDA kernel forward and backward; every
gate family, the bf16 compute path, resume and multi-device training; and
the tools around training: the post-training quantization study, the NAS
search and quality-control re-runs, analysis and plots, and the ``.h5`` and
``.cvol`` readers.  Entry points run on ``device='cuda'`` unless the caller
passes ``'cpu'``.
"""

__version__ = "0.1.0"
