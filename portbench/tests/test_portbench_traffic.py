"""The inputs made from the seed: the volume, the starting tensors, the
query planes and the seed streams, at a tiny size."""

import numpy as np
import torch

from portbench import generator as gen
from portbench.run import seeds_of
from portbench.volume import mhd_like
from portbench.weights import make_params

from conftest import run_tiny

BIG = 2 ** 33 + 123


def test_seed_streams_take_large_seeds():
    a, b = seeds_of(BIG), seeds_of(BIG + 1)
    assert a == seeds_of(BIG) and a != b
    assert len(set(a.values())) == len(a) and all(0 <= s < 2 ** 63 for s in a.values())


def test_volume_is_seeded_and_normalized():
    v = mhd_like(17, 3, 5, 'cpu')
    assert v.shape == (17, 17, 17) and v.dtype == torch.float32
    assert float(v.min()) == -1.0 and float(v.max()) == 1.0
    assert torch.equal(v, mhd_like(17, 3, 5, 'cpu'))
    assert not torch.equal(v, mhd_like(17, 3, 6, 'cpu'))


def test_starting_tensors_take_the_ports_shapes(tiny_bench):
    import json
    from latent_feature_grid_compression_tpu_torch.models.feature_grid import coeff_shapes
    root, _ = tiny_bench
    for name, groups in (('mhd_p_smallify', {'betas'}),
                         ('mhd_p_dynamic_variational', {'log_thetas', 'log_var', 'var_w'})):
        cfg = json.loads((root / f'{name}.json').read_text())
        p = make_params(cfg, 7, 'cpu')
        spec = gen.spec_of(cfg, gated=True)
        assert [tuple(c.shape) for c in p['coeffs']] == list(coeff_shapes(spec))
        assert groups <= set(p)
        assert [tuple(w.shape) for w in p['mlp_w']] == [(32, 31)] + [(32, 32)] * 3 + [(1, 32)]
        q = make_params(cfg, 7, 'cpu', pruned=True)
        kept = sum(int((c != 0).sum()) for c in q['coeffs']) / sum(c.numel() for c in q['coeffs'])
        assert 0.25 < kept < 0.42
        assert all(torch.equal(a, b) for a, b in zip(p['mlp_w'], make_params(cfg, 7, 'cpu')['mlp_w']))


def test_slice_points_lie_on_their_plane():
    params = gen.SliceParams(3, 0.5)
    assert np.array_equal(params[1], gen.SliceParams(3, 0.5)[1])
    assert not np.array_equal(params[1], gen.SliceParams(4, 0.5)[1])
    far = params[gen.SliceParams.BLOCK + 1]
    assert not np.array_equal(far, params[1]) and np.abs(far[:3]).max() <= 0.5
    one = params[1]
    pts = gen.slice_points(one, 16, 1.0, 'cpu').double()
    assert pts.shape == (256, 3)
    n = torch.tensor(one[3:] / np.linalg.norm(one[3:]))
    c = torch.tensor(one[:3])
    assert float(((pts - c) @ n).abs().max()) < 1e-5
    corner = pts[0] - c
    assert abs(float(corner.norm()) - 2 ** 0.5) < 1e-5


def _kept(seed, k, count):
    keeper = gen.Keeper(seed, k)
    for i in range(count):
        keeper.offer(i)
    return keeper.items()


def test_picks_are_seeded():
    assert _kept(9, 3, 1000) == _kept(9, 3, 1000) != _kept(10, 3, 1000)
    assert _kept(9, 3, 2) == [0, 1] and _kept(9, 3, 3) == [0, 1, 2]
    kept = _kept(9, 3, 1000)
    assert len(kept) == 4 and kept[-1] == 999 and len(set(kept)) == 4
    # drawn across the whole window, not from its start
    late = [max(_kept(s, 3, 1000)[:3]) for s in range(40)]
    assert sum(x >= 500 for x in late) >= 25


def test_a_mix_drives_the_work_it_names(tiny_bench):
    result, run = run_tiny(tiny_bench, 'smallify-query', seconds=0.3)
    assert run.kind == 'query' and run.units == len(run.latencies_s) == result['attempted']
    assert run.work == run.units * 32 * 32
    result, run = run_tiny(tiny_bench, 'dynvar-train', seconds=0.3)
    assert run.kind == 'train' and run.work == run.units * 128 and run.units % 5 == 0
