from .dwt import WaveletFilter3d, encode_pyramid, decode_pyramid
from .interpolation import (grid_sample_3d, grid_sample_channel_minor,
                            grid_sample_channel_minor_backward, channel_minor,
                            trilinear_interpolate, gather_rows, gather_volume)
from .grid_sample import fetch, grid_sample_3d_cuda, grid_sample_channel_minor_cuda
from .embedding import fourier_embed, fourier_out_dim
from .mlp import snake_alt, init_mlp, mlp_apply, init_linear
