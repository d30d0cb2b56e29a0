"""The fetch kernel's share of its roofline at the evaluation's chunk."""
from portbench.counts import fetch
from portbench.layer import roofline

CHUNK = 1 << 18     # the evaluation's chunk of voxels


def read(run):
    c = run.config
    n = min(CHUNK, c['volume']['n'] ** 3)
    C, G = c['grid_features'], c['grid_size']
    return roofline(run, 'decompress', lambda pk: fetch.bound_ms(n, C, G, G, G, pk),
                    ['grid_sample_fwd_kernel'])
