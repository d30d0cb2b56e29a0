"""The fetch kernel's share of its roofline at a training step's batch."""
from portbench.counts import fetch
from portbench.layer import roofline


def read(run):
    c = run.config
    n, C, G = c['batch_size'] * c['sample_size'], c['grid_features'], c['grid_size']
    return roofline(run, 'train', lambda pk: fetch.bound_ms(n, C, G, G, G, pk),
                    ['grid_sample_fwd_kernel'])
