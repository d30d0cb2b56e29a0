"""The grid gradient's share of its roofline at a training step's batch: its
two launches (the tile sort and the box kernel) together."""
from portbench.counts import fetch
from portbench.layer import roofline


def read(run):
    c = run.config
    n, C, G = c['batch_size'] * c['sample_size'], c['grid_features'], c['grid_size']
    return roofline(run, 'train', lambda pk: fetch.grad_bound_ms(n, C, G, G, G, pk),
                    ['grid_sample_bwd_tiles_kernel', 'grid_sample_bwd_kernel'])
