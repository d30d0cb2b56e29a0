"""The port's grid gradient and ground-truth gathers against the JAX
package: the plain backward of the trilinear fetch against ``jax.grad``
through ``pallas_grid_sample_3d`` (interpret mode) and through the XLA
``grid_sample_3d``; the differentiable fetch's dispatch on the CPU; and the
trainer's exact ground-truth fetch.  The backward kernel's own tests on the
card are in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from latent_feature_grid_compression_tpu.ops import interpolation as jinterp
from latent_feature_grid_compression_tpu.ops.pallas_kernels import (
    pallas_grid_sample_3d)
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops.interpolation import (
    channel_minor, gather_rows, gather_volume, grid_sample_3d,
    grid_sample_channel_minor, grid_sample_channel_minor_backward,
    trilinear_interpolate)


def _inputs(shape, n, seed, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    features = rng.standard_normal(shape).astype(np.float32)
    coords = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    g = rng.standard_normal((n, shape[0])).astype(np.float32)
    return features, coords, g


def _port_grad(features, coords, g):
    """The plain backward, brought back to the (C, D, H, W) layout."""
    C, D, H, W = features.shape
    dg = grid_sample_channel_minor_backward(torch.from_numpy(g),
                                            torch.from_numpy(coords), D, H, W)
    return dg.permute(3, 0, 1, 2).numpy()


def _jax_grad(fn, features, coords, g):
    def loss(f):
        return jnp.sum(fn(f, jnp.asarray(coords)) * jnp.asarray(g))
    return np.asarray(jax.grad(loss)(jnp.asarray(features)))


# the unblocked Pallas backward (grid 8) and the HW-blocked one (grid 32),
# at the shapes and tolerances of tests/test_pallas.py (its 'f32' precision
# is a 3-pass bf16 split)
@pytest.mark.parametrize('shape,n,seed,tol', [((4, 8, 8, 8), 513, 1, 2e-4),
                                              ((8, 32, 32, 32), 400, 3, 3e-4)])
def test_plain_backward_matches_pallas_interpret(shape, n, seed, tol):
    features, coords, g = _inputs(shape, n, seed)
    ref = _jax_grad(lambda f, c: pallas_grid_sample_3d(f, c, interpret=True),
                    features, coords, g)
    np.testing.assert_allclose(_port_grad(features, coords, g), ref, atol=tol)


# out-of-range corners included; the flagship grid 15 and an anisotropic one
@pytest.mark.parametrize('shape', [(4, 8, 8, 8), (16, 15, 15, 15), (3, 5, 7, 9)])
def test_plain_backward_matches_xla_grad(shape):
    features, coords, g = _inputs(shape, 700, 4, -1.2, 1.2)
    ref = _jax_grad(jinterp.grid_sample_3d, features, coords, g)
    np.testing.assert_allclose(_port_grad(features, coords, g), ref, atol=1e-5)


def test_fetch_grad_equals_autograd_through_plain_forward():
    features, coords, g = _inputs((6, 9, 10, 11), 900, 5, -1.2, 1.2)
    grid = channel_minor(torch.from_numpy(features))
    c, gt = torch.from_numpy(coords), torch.from_numpy(g)
    a = grid.clone().requires_grad_(True)
    (gs.fetch(a, c) * gt).sum().backward()
    b = grid.clone().requires_grad_(True)
    (grid_sample_channel_minor(b, c) * gt).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5)


def test_fetch_on_cpu_launches_nothing_and_stops_coord_grads():
    features, coords, _ = _inputs((4, 5, 5, 5), 50, 6)
    grid = channel_minor(torch.from_numpy(features)).requires_grad_(True)
    c = torch.from_numpy(coords).requires_grad_(True)
    before = (gs.launches, gs.bwd_launches)
    out = gs.fetch(grid, c)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  grid_sample_channel_minor(grid.detach(), c.detach()).numpy())
    out.sum().backward()
    assert grid.grad is not None and c.grad is None
    assert (gs.launches, gs.bwd_launches) == before


def test_cuda_wrappers_reject_cpu_tensors():
    features, coords, g = _inputs((4, 5, 5, 5), 10, 7)
    with pytest.raises(ValueError, match='CUDA tensor'):
        gs.grid_sample_channel_minor_backward_cuda(
            torch.from_numpy(g), torch.from_numpy(coords), 5, 5, 5)
    with pytest.raises(ValueError, match='CUDA tensor'):
        gs.grid_sample_3d_cuda(torch.from_numpy(features), torch.from_numpy(coords))
    with pytest.raises(ValueError, match=r'g \(N, C\)'):
        gs.grid_sample_channel_minor_backward_cuda(
            torch.from_numpy(g[:5]), torch.from_numpy(coords), 5, 5, 5)


def _lattice(shape, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, s, n) for s in shape], 1).astype(np.int32)


def test_gathers_match_jax():
    shape = (11, 13, 17)
    vol = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    pts = _lattice(shape, 3000, 9)
    want = np.asarray(jinterp.gather_volume(jnp.asarray(vol), jnp.asarray(pts)))
    got = gather_volume(torch.from_numpy(vol), torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    v2 = vol.reshape(11 * 13, 17)
    np.testing.assert_array_equal(
        gather_rows(torch.from_numpy(v2), 13, torch.from_numpy(pts)).numpy(),
        np.asarray(jinterp.gather_rows(jnp.asarray(v2), 13, jnp.asarray(pts))))
    np.testing.assert_array_equal(got, vol[pts[:, 0], pts[:, 1], pts[:, 2]])


def _box(shape):
    min_bb = np.array([-1.0, -2.0, 0.5], np.float32)
    max_bb = np.array([1.0, 3.0, 4.0], np.float32)
    return min_bb, max_bb, np.asarray(shape, np.float32)


def test_trilinear_interpolate_matches_jax():
    shape = (9, 10, 12)
    vol = np.random.default_rng(10).standard_normal(shape).astype(np.float32)
    min_bb, max_bb, res = _box(shape)
    pts = np.random.default_rng(11).uniform(min_bb, max_bb, (2000, 3)).astype(np.float32)
    want = jinterp.trilinear_interpolate(*(jnp.asarray(a) for a in
                                           (vol, pts, min_bb, max_bb, res)))
    got = trilinear_interpolate(*(torch.from_numpy(a) for a in
                                  (vol, pts, min_bb, max_bb, res)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_trilinear_interpolate_equals_gather_at_integer_points():
    """The trainer's exact fetch: at lattice points the interpolation
    degenerates to the voxel value."""
    shape = (8, 9, 10)
    vol = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    min_bb = np.zeros(3, np.float32)
    res = np.asarray(shape, np.float32)
    max_bb = res - 1.0
    pts = _lattice(shape, 2000, 13)
    got = trilinear_interpolate(*(torch.from_numpy(a) for a in
                                  (vol, pts.astype(np.float32), min_bb, max_bb, res)))
    want = gather_volume(torch.from_numpy(vol), torch.from_numpy(pts))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_plain_backward_is_the_adjoint_of_the_forward():
    """<fetch(G), g> == <G, dG(g)> for random G and g."""
    features, coords, g = _inputs((5, 6, 7, 8), 400, 14, -1.3, 1.3)
    fwd = grid_sample_3d(torch.from_numpy(features), torch.from_numpy(coords))
    lhs = float((fwd.double() * torch.from_numpy(g).double()).sum())
    rhs = float((torch.from_numpy(features).double()
                 * torch.from_numpy(_port_grad(features, coords, g)).double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs))
