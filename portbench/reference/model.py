"""The plain reference of the latent-feature-grid model, in float32 PyTorch.

Written from the method's description (the reference repository's
``model/Feature_Grid_Model.py``, ``wavelet_transform/``, ``training/``):
nothing here imports or calls the port.

* Wavelets: the db2 filter bank, h = [1+r3, 3+r3, 3-r3, 1-r3] / (4 sqrt 2)
  (rec_lo; dec_lo its reverse, rec_hi[k] = (-1)^k h[3-k], dec_hi its
  reverse).  Analysis: zero padding of 2 on each side (+1 trailing for odd
  sizes), a stride-2 convolution with the decomposition filters a spatial
  axis at a time; subband bits with the first spatial axis most significant,
  0 = lowpass.  Synthesis: a stride-2 transposed convolution with the
  reconstruction filters, centre-cropped (the floor of the excess on the
  leading side).  ``encode`` makes the pyramid (lowpass, then the details
  coarsest first), ``decode`` inverts it.
* Feature fetch: ``F.grid_sample`` (trilinear, ``align_corners=False``,
  zero padding) of the (C, D, H, W) grid, coordinate 0 indexing W.
* Head: [x, sin(2 pi x), cos(2 pi x), sin(4 pi x), cos(4 pi x), features]
  -> 4 x (Linear, SnakeAlt(x) = x / 2 + sin(x)^2) -> Linear; clamped to
  [-1, 1] outside training.
* Gates: smallify multiplies each level by its betas; dynamic variational
  by exp(log_theta) + exp(log_var / 2) * xi, xi ~ N(0, 1).
* Losses: smallify, MSE + 1e-8-weighted L1 of the betas and L2 of the
  (ungated) coefficients; dynamic variational, the Gaussian log-likelihood
  at the variance MLP's log-sigma (3 -> 4 x 32 ReLU -> 1), scaled to the
  volume, less the Molchanov KL (ramped weight) and the coefficients' L2,
  both scaled by voxels / batch.
* Adam (torch's: bias-corrected moments, eps outside the square root).

Parameters are a dict of lists in the trainer's order of leaves:
coeffs, mlp_w, mlp_b, then the family's gate tensors, then var_w, var_b.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_R3 = math.sqrt(3.0)
DB2_REC_LO = [(1 + _R3) / (4 * math.sqrt(2.0)), (3 + _R3) / (4 * math.sqrt(2.0)),
              (3 - _R3) / (4 * math.sqrt(2.0)), (1 - _R3) / (4 * math.sqrt(2.0))]
DB2_REC_HI = [(-1.0) ** k * DB2_REC_LO[3 - k] for k in range(4)]
DB2_DEC_LO = DB2_REC_LO[::-1]
DB2_DEC_HI = DB2_REC_HI[::-1]
L = 4
PAD = (2 * L - 3) // 2

# Molchanov's KL approximation
K1, K2, K3 = 0.63576, 1.87320, 1.48695

LEAF_GROUPS = {'smallify': ('coeffs', 'mlp_w', 'mlp_b', 'betas'),
               'dynamic_variational': ('coeffs', 'mlp_w', 'mlp_b', 'log_thetas', 'log_var',
                                       'var_w', 'var_b'),
               '': ('coeffs', 'mlp_w', 'mlp_b')}


def subband_size(s: int) -> int:
    return (s + 2 * PAD + s % 2 - L) // 2 + 1


def level_shapes(grid_size: int) -> List[int]:
    """The size each decode level restores, coarsest first."""
    levels = int(math.floor(math.log2(grid_size / (L - 1.0))))
    sizes, s = [], grid_size
    for _ in range(levels):
        sizes.append(s)
        s = subband_size(s)
    return sizes[::-1]


def _along(x: torch.Tensor, axis: int, fn) -> torch.Tensor:
    """``fn`` on (rows, 1, length) applied along ``axis`` of ``x``."""
    x = x.movedim(axis, -1)
    shape = x.shape
    y = fn(x.reshape(-1, 1, shape[-1]))
    return y.reshape(shape[:-1] + (y.shape[-1],)).movedim(-1, axis)


def _analysis(x, axis, taps):
    w = torch.tensor(taps[::-1], dtype=x.dtype, device=x.device).view(1, 1, L)

    def fn(r):
        s = r.shape[-1]
        return F.conv1d(F.pad(r, (PAD, PAD + s % 2)), w, stride=2)
    return _along(x, axis, fn)


def _synthesis(lo, hi, axis, s_out):
    def tconv(taps):
        w = torch.tensor(taps, dtype=lo.dtype, device=lo.device).view(1, 1, L)
        return lambda r: F.conv_transpose1d(r, w, stride=2)
    full = _along(lo, axis, tconv(DB2_REC_LO)) + _along(hi, axis, tconv(DB2_REC_HI))
    start = (full.shape[axis] - s_out) // 2
    return full.narrow(axis, start, s_out)


def encode(grid: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """(C, G, G, G) -> [lowpass (C, s, s, s)] + details (C, 7, s', s', s'),
    coarsest first."""
    details, data = [], grid
    for _ in range(levels):
        bands = [data]
        for axis in (1, 2, 3):
            bands = [_analysis(b, axis, taps) for b in bands
                     for taps in (DB2_DEC_LO, DB2_DEC_HI)]
        # bands are ordered with the first spatial axis' bit most significant
        details.append(torch.stack(bands[1:], dim=1))
        data = bands[0]
    return [data] + details[::-1]


def decode(coeffs: Sequence[torch.Tensor], grid_size: int) -> torch.Tensor:
    """The inverse of ``encode``: (C, G, G, G)."""
    restored = coeffs[0]
    for high, s_out in zip(coeffs[1:], level_shapes(grid_size)):
        C, s = high.shape[0], high.shape[-1]
        x = torch.cat([restored[:, None], high], dim=1).view(C, 2, 2, 2, s, s, s)
        # axis bits (a, b, w) = (first, second, third spatial axis)
        y = _synthesis(x[:, :, :, 0], x[:, :, :, 1], 5, s_out)      # (C, 2, 2, s, s, S)
        y = _synthesis(y[:, :, 0], y[:, :, 1], 3, s_out)            # (C, 2, s, S, S)
        restored = _synthesis(y[:, 0], y[:, 1], 1, s_out)           # (C, S, S, S)
    return restored


def fetch(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """(C, D, H, W) grid at (N, 3) coordinates in [-1, 1] -> (N, C)."""
    out = F.grid_sample(grid[None], coords.view(1, -1, 1, 1, 3), mode='bilinear',
                        padding_mode='zeros', align_corners=False)
    return out.view(grid.shape[0], -1).t()


def embed(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    parts = [x]
    for k in range(n_freqs):
        f = (2.0 ** k) * 2.0 * math.pi
        parts += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(parts, dim=-1)


def snake_alt(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x + torch.sin(x) ** 2


def mlp(ws, bs, x, act) -> torch.Tensor:
    for w, b in zip(ws[:-1], bs[:-1]):
        x = act(x @ w.t() + b)
    return x @ ws[-1].t() + bs[-1]


def gated(p: Dict[str, list], family: str, noise: Optional[Sequence[torch.Tensor]]):
    if family == 'smallify':
        return [c * b[None] for c, b in zip(p['coeffs'], p['betas'])]
    if family == 'dynamic_variational':
        return [c * (torch.exp(lt) + torch.exp(lv / 2.0) * xi)[None]
                for c, lt, lv, xi in zip(p['coeffs'], p['log_thetas'], p['log_var'], noise)]
    return list(p['coeffs'])


def head(p, grid: torch.Tensor, coords: torch.Tensor, n_freqs: int) -> torch.Tensor:
    x = torch.cat([embed(coords, n_freqs), fetch(grid, coords)], dim=-1)
    return mlp(p['mlp_w'], p['mlp_b'], x, snake_alt)[:, 0]


def predict(p, coords: torch.Tensor, grid_size: int, n_freqs: int) -> torch.Tensor:
    """The decompressed value at (N, 3) coordinates, clamped: (N,)."""
    return head(p, decode(p['coeffs'], grid_size), coords, n_freqs).clamp(-1.0, 1.0)


def lattice_coords(resolution: Tuple[int, int, int], start: int, count: int,
                   device) -> torch.Tensor:
    """Normalized, anisotropy-scaled coordinates of flat (row-major)
    voxels start .. start + count - 1."""
    X, Y, Z = resolution
    lin = torch.arange(start, start + count, device=device, dtype=torch.int64)
    idx = torch.stack([lin // (Y * Z), (lin // Z) % Y, lin % Z], dim=1).to(torch.float32)
    max_idx = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32, device=device)
    return (idx / max_idx * 2.0 - 1.0) * (max_idx / max_idx.max())


def field(p, resolution, grid_size: int, n_freqs: int, block: int = 1 << 18) -> torch.Tensor:
    """The whole decompressed volume (X, Y, Z), a block of voxels at a time."""
    grid = decode(p['coeffs'], grid_size)
    n = resolution[0] * resolution[1] * resolution[2]
    out = torch.empty(n, device=grid.device)
    for start in range(0, n, block):
        count = min(block, n - start)
        c = lattice_coords(resolution, start, count, grid.device)
        out[start:start + count] = head(p, grid, c, n_freqs).clamp(-1.0, 1.0)
    return out.view(resolution)


def loss(p, cfg: dict, coords, gt, noise, weight_dkl, n_voxels: int, batch: int):
    """The phase-1 loss of ``cfg``'s family for one step's samples."""
    family = cfg['drop_type']
    grid = decode(gated(p, family, noise), cfg['grid_size'])
    pred = head(p, grid, coords, cfg['n_embedding_freq'])
    l2 = sum(torch.sum(c * c) for c in p['coeffs'])
    if family == 'dynamic_variational':
        log_sigma = mlp(p['var_w'], p['var_b'], coords, torch.relu)[:, 0]
        sq = (gt - pred) ** 2
        sigma = torch.exp(log_sigma)
        ll = -sq / (2.0 * sigma * sigma) - (math.log(2.0 * math.pi) + 2.0 * log_sigma) / 2.0
        dkl = 0.0
        for lt, lv in zip(p['log_thetas'], p['log_var']):
            log_alpha = lv - 2.0 * lt
            dkl = dkl + torch.sum(-K1 * torch.sigmoid(K2 + K3 * log_alpha)
                                  + 0.5 * F.softplus(-log_alpha) + K1)
        scale = n_voxels / batch
        return -(torch.sum(ll) * (n_voxels / pred.shape[0]) - weight_dkl * dkl * scale
                 - cfg['lambda_weight_loss'] * l2 * scale)
    mse = torch.mean((pred - gt) ** 2)
    l1 = sum(torch.sum(torch.abs(b)) for b in p['betas']) if family == 'smallify' else 0.0
    return mse + cfg['lambda_drop_loss'] * l1 + cfg['lambda_weight_loss'] * l2


def leaves(p: Dict[str, list], family: str) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, in the trainer's order."""
    return [(f'{g}[{i}]', t) for g in LEAF_GROUPS[family] for i, t in enumerate(p[g])]


def train_steps(p0: Dict[str, list], cfg: dict, draws, volume: torch.Tensor,
                steps: int, half_batch: bool = False):
    """``steps`` phase-1 steps from ``p0`` with Adam at the config's lr.
    ``draws(t)`` gives step t's (N, 3) integer positions and its gate noise
    (a list a level, or None).  ``half_batch``: the loss over the first half
    of each batch only (a planted fault).  Returns (each step's loss, the
    first step's gradient, the parameters after the last step), the last two
    as lists of leaves in the trainer's order."""
    family = cfg['drop_type']
    names = LEAF_GROUPS[family]
    flat = [t.detach().clone().requires_grad_(True) for _, t in leaves(p0, family)]
    m = [torch.zeros_like(t) for t in flat]
    v = [torch.zeros_like(t) for t in flat]
    res = torch.tensor(volume.shape, device=volume.device, dtype=torch.float32)
    max_idx = res - 1.0
    n_voxels = volume.numel()
    weight_dkl = torch.tensor(float(cfg['lambda_drop_loss']), device=volume.device)
    losses, first_grad = [], None
    for t in range(1, steps + 1):
        pos, noise = draws(t)
        batch = pos.shape[0]
        if half_batch:
            pos = pos[:batch // 2]
        coords = (pos.to(torch.float32) / max_idx * 2.0 - 1.0) * (max_idx / max_idx.max())
        p = _unflatten(flat, p0, names)
        gt = volume[pos[:, 0].long(), pos[:, 1].long(), pos[:, 2].long()]
        weight_dkl = torch.where(weight_dkl < 30.0,
                                 weight_dkl * (1.0 + cfg['weight_dkl_multiplier']), weight_dkl)
        value = loss(p, cfg, coords, gt, noise, weight_dkl, n_voxels, batch)
        grads = torch.autograd.grad(value, flat)
        losses.append(float(value.detach()))
        if first_grad is None:
            first_grad = [g.detach().clone() for g in grads]
        bc1, bc2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
        with torch.no_grad():
            for x, g, mi, vi in zip(flat, grads, m, v):
                mi.mul_(0.9).add_(0.1 * g)
                vi.mul_(0.999).add_(0.001 * g * g)
                x.sub_(cfg['lr'] * (mi / bc1) / (torch.sqrt(vi / bc2) + 1e-8))
    return losses, first_grad, [x.detach() for x in flat]


def _unflatten(flat: List[torch.Tensor], like: Dict[str, list], names) -> Dict[str, list]:
    out, k = {}, 0
    for g in names:
        n = len(like[g])
        out[g] = flat[k:k + n]
        k += n
    return out
