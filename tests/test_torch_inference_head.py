"""The inference head after the fetch (``ops/inference_head.py``) on the
CPU: its plain version is the chain the model ran before (``_mlp_input``,
``mlp_apply``, ``clamp``) bit for bit; the route through the kernel (a
query's float32 ``xla`` head or the evaluation's head whatever the
backends, at the kernel's widths, on a card, no gradient needed), through
the model's pure-Python predicate told a card's device; ``predict`` and
``predict_trilinear`` call the head where the rule says so; the wrapper's
width checks; the launch counter among the counters a graph replay adds;
and the kernel source's widths against the wrapper's.  The kernel itself
is held to the plain version on the card (``tests/test_torch_cuda.py``)."""

import re

import pytest
import torch

from latent_feature_grid_compression_tpu_torch.models import feature_grid as fg
from latent_feature_grid_compression_tpu_torch.ops import _build
from latent_feature_grid_compression_tpu_torch.ops import inference_head as ih
from latent_feature_grid_compression_tpu_torch.ops import launch_counts
from latent_feature_grid_compression_tpu_torch.ops.grid_sample import fetch
from latent_feature_grid_compression_tpu_torch.ops.interpolation import channel_minor
from latent_feature_grid_compression_tpu_torch.ops.mlp import mlp_apply, snake_alt

CARD = torch.device('cuda')


def _model(C=16, **kw):
    spec = fg.make_spec(**dict(dict(grid_features=C, grid_size=8), **kw))
    return fg.init_model(spec, torch.Generator().manual_seed(C), device='cpu')


def _coords(n, seed=1):
    # some out of range: the fetch gives those zeros
    return torch.rand((n, 3), generator=torch.Generator().manual_seed(seed)) * 2.4 - 1.2


@pytest.mark.parametrize('C', ih.CHANNELS)
def test_plain_version_is_the_chain_bit_for_bit(C):
    model = _model(C)
    grid = channel_minor(fg.decode_volume(model))
    coords = _coords(3000)
    ws, bs = list(model.mlp_w), list(model.mlp_b)
    with torch.no_grad():
        want = mlp_apply(ws, bs, fg._mlp_input(model, grid, coords), snake_alt).clamp(-1, 1)
        got = ih.inference_head_plain(coords, fetch(grid, coords), ws, bs, 2)
        routed = ih.inference_head(coords, fetch(grid, coords), ws, bs, 2)
    assert got.shape == (3000, 1)
    assert torch.equal(got, want) and torch.equal(routed, want)


ROUTES = [
    # (make_spec keys, device, gradient needed, evaluation, routed)
    ({}, CARD, False, False, True),
    ({'grid_features': 22}, CARD, False, False, True),
    ({'interp_backend': 'pallas_bf16'}, CARD, False, False, True),
    ({'num_layers': 1}, CARD, False, False, True),
    ({'num_layers': 15}, CARD, False, False, True),
    ({}, CARD, True, False, False),
    ({}, torch.device('cpu'), False, False, False),
    ({'interp_backend': 'fused'}, CARD, False, False, False),
    ({'mlp_backend': 'pallas'}, CARD, False, False, False),
    ({'compute_dtype': 'bfloat16'}, CARD, False, False, False),
    ({'hidden': 24}, CARD, False, False, False),
    ({'grid_features': 8}, CARD, False, False, False),
    ({'n_freqs': 3}, CARD, False, False, False),
    ({'d_out': 2}, CARD, False, False, False),
    ({'num_layers': 16}, CARD, False, False, False),
    # the evaluation's head is float32 whatever the backends
    ({'mlp_backend': 'pallas'}, CARD, False, True, True),
    ({'interp_backend': 'fused'}, CARD, False, True, True),
    ({'compute_dtype': 'bfloat16'}, CARD, False, True, True),
    ({'hidden': 24}, CARD, False, True, False),
    ({}, CARD, True, True, False),
    ({}, torch.device('cpu'), False, True, False),
]


@pytest.mark.parametrize('keys,device,grad,evaluation,routed', ROUTES)
def test_the_route_follows_widths_backends_device_and_gradient(monkeypatch, keys, device,
                                                               grad, evaluation, routed):
    """``predict`` (a query, ``train=False``) or the evaluation's
    ``predict_trilinear`` on CPU tensors, with ``uses_head_kernel`` told
    the row's device: the head is called once where the row routes it, and
    the answer is the unrouted one bit for bit."""
    model = _model(**keys)
    grid = channel_minor(fg.decode_volume(model)).detach()
    coords = _coords(64)
    head = fg.predict_trilinear if evaluation else fg.predict
    with torch.no_grad():
        want = head(model, grid, coords)
    uses = fg.uses_head_kernel
    monkeypatch.setattr(fg, 'uses_head_kernel',
                        lambda spec, dev, g: uses(spec, torch.device(device), g))
    calls = _counted(monkeypatch)
    with torch.set_grad_enabled(grad):
        got = head(model, grid, coords)
    assert len(calls) == int(routed)
    assert torch.equal(got.detach(), want)


def test_a_gradient_is_needed_under_autograd_with_a_tensor_that_requires_it():
    model = _model()
    ws = list(model.mlp_w)
    coords = _coords(8)
    assert ih.needs_grad(coords, *ws)
    assert not ih.needs_grad(coords, *[w.detach() for w in ws])
    with torch.no_grad():
        assert not ih.needs_grad(coords, *ws)


def _counted(monkeypatch, routed=None):
    """The head's calls counted, and with ``routed`` given,
    ``uses_head_kernel`` answering it."""
    calls = []
    head = ih.inference_head
    if routed is not None:
        monkeypatch.setattr(fg, 'uses_head_kernel', lambda *a, **k: routed)
    monkeypatch.setattr(ih, 'inference_head',
                        lambda *a, **k: calls.append(a) or head(*a, **k))
    return calls


@pytest.mark.parametrize('routed', [True, False])
def test_predict_and_predict_trilinear_call_the_head_where_routed(monkeypatch, routed):
    """Where the rule routes it (stubbed here: the CPU head is the plain
    version), both heads call ``inference_head`` once and give the chain's
    answer bit for bit; where it does not, neither calls it."""
    model = _model()
    grid = channel_minor(fg.decode_volume(model))
    coords = _coords(500)
    with torch.no_grad():
        want = fg.predict(model, grid, coords)
    calls = _counted(monkeypatch, routed)
    with torch.no_grad():
        got = fg.predict(model, grid, coords)
        got_eval = fg.predict_trilinear(model, grid, coords)
        got_query = fg.apply_model(model, coords, train=False)
    assert len(calls) == (3 if routed else 0)
    assert torch.equal(got, want) and torch.equal(got_eval, want)
    assert torch.equal(got_query, want)


def test_a_loaded_checkpoints_weights_reach_the_head_contiguous(monkeypatch):
    """A checkpoint's weights load as transposed views of its (in, out)
    arrays; the kernel reads row-major weights, so the routed head gets
    contiguous copies, and the same answer."""
    from latent_feature_grid_compression_tpu_torch.convert import (params_from_jax,
                                                                   params_to_jax)
    model = _model()
    coeffs, mlp_w, mlp_b, _ = params_to_jax(model)
    loaded = params_from_jax(coeffs, mlp_w, mlp_b, model.spec, device='cpu')
    assert not all(w.is_contiguous() for w in loaded.mlp_w)
    grid = channel_minor(fg.decode_volume(loaded))
    coords = _coords(300)
    with torch.no_grad():
        want = fg.predict_trilinear(loaded, grid, coords)
    seen = []
    head = ih.inference_head
    monkeypatch.setattr(fg, 'uses_head_kernel', lambda *a, **k: True)
    monkeypatch.setattr(ih, 'inference_head',
                        lambda c, f, ws, bs, n: seen.append(ws + bs) or head(c, f, ws, bs, n))
    with torch.no_grad():
        got = fg.predict_trilinear(loaded, grid, coords)
    assert len(seen) == 1 and all(t.is_contiguous() for t in seen[0])
    assert torch.equal(got, want)


def test_training_forward_never_calls_the_head(monkeypatch):
    """``train=True`` (the loss's forward) keeps the chain, unclamped,
    whatever the rule says."""
    model = _model()
    calls = _counted(monkeypatch, True)
    out = fg.apply_model(model, _coords(200), train=True)
    assert not calls and out.requires_grad


@pytest.mark.parametrize('bad', ['C', 'layers', 'hidden', 'out', 'bias'])
def test_width_checks_raise(bad):
    C = 12 if bad == 'C' else 16
    dims = [15 + C] + [32] * 4 + [1]
    if bad == 'hidden':
        dims[2] = 24
    if bad == 'out':
        dims[-1] = 2
    ws = [torch.zeros(b, a) for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros(b) for b in dims[1:]]
    if bad == 'layers':
        ws, bs = ws[-1:], bs[-1:]
    if bad == 'bias':
        bs[1] = torch.zeros(31)
    with pytest.raises(ValueError):
        ih.check_widths(ws, bs, C)


def test_check_widths_gives_the_layer_widths():
    dims = [37] + [32] * 3 + [1]
    ws = [torch.zeros(b, a) for a, b in zip(dims[:-1], dims[1:])]
    assert ih.check_widths(ws, [torch.zeros(b) for b in dims[1:]], 22) == dims


def test_the_launch_counter_is_among_the_counters():
    assert (ih, 'launches') in launch_counts.KERNEL_COUNTERS
    assert (ih, 'launches') in launch_counts.COUNTERS
    ih.launches = 0
    mark = launch_counts.read()
    ih.launches += 3
    i = launch_counts.COUNTERS.index((ih, 'launches'))
    assert launch_counts.since(mark)[i] == 3
    ih.launches = 0


def test_the_kernel_source_has_the_wrappers_widths():
    src = (_build.CSRC_DIR / 'inference_head.cu').read_text()

    def const(name, text=src):
        return int(re.search(rf'constexpr int {name} = (\d+);', text).group(1))
    assert const('kHidden') == ih.HIDDEN and const('kFreqs') == ih.N_FREQS
    mlp = (_build.CSRC_DIR / 'snake_mlp.cuh').read_text()
    assert const('kMaxLayers', mlp) == ih.MAX_LAYERS
    assert 'inference_head' in _build.kernel_sources()
    assert re.search(r'return \(C == 16 \|\| C == 22\)', src) and ih.CHANNELS == (16, 22)
