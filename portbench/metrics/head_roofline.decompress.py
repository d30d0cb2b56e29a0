"""The inference head kernel's share of its roofline at the evaluation's
chunk: the operations of the embedding, the head and the clamp over the
float32 peak (they bound it: its bytes take a tenth as long)."""
from portbench.counts import embedding, mlp
from portbench.counts.model import SNAKE_OPS, head_dims
from portbench.layer import roofline

CHUNK = 1 << 18     # the evaluation's chunk of voxels
KERNEL = 'inference_head_kernel'


def read(run):
    c = run.config
    n = min(CHUNK, c['volume']['n'] ** 3)
    ops = (embedding.ops(n, c['n_embedding_freq'], c['d_in'])
           + mlp.forward_ops(n, head_dims(c), SNAKE_OPS) + n)
    return roofline(run, 'decompress', lambda pk: ops / pk.f32_flops * 1e3, [KERNEL])
