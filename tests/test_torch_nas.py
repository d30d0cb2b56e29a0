"""The port's NAS, quality-control re-runs, analysis and plots against the
JAX package's: the same inputs through both (``nas/search.py``,
``nas/bayesopt.py``, ``utils/analysis.py``, ``utils/trigger_experiments.py``),
the searches' suggestions bit for bit, every plot function writing its
figure, and a real 2-trial search with a quality-control run of each kind
through ``train_torch.py`` on the CPU.

``run_search`` joins the experiment directory to the working directory and
logs to ``runs/<expname>`` under it, so every test that runs it chdirs to
its ``tmp_path``."""

import math
import os
import random
import sys

import numpy as np
import pytest
import torch

from latent_feature_grid_compression_tpu.nas import bayesopt as jbo
from latent_feature_grid_compression_tpu.nas import search as jsearch
from latent_feature_grid_compression_tpu.utils import analysis as janalysis
from latent_feature_grid_compression_tpu.utils import trigger_experiments as jtrig
from latent_feature_grid_compression_tpu_torch import config as tconfig
from latent_feature_grid_compression_tpu_torch.data.cvol import write_cvol
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.nas import bayesopt as tbo
from latent_feature_grid_compression_tpu_torch.nas import search as tsearch
from latent_feature_grid_compression_tpu_torch.utils import analysis as tanalysis
from latent_feature_grid_compression_tpu_torch.utils import plots as tplots
from latent_feature_grid_compression_tpu_torch.utils import trigger_experiments as ttrig

CPU_TRAIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'torch_train_cpu.py')
SPACES = ('SMALLIFY_SPACE', 'BASELINE_SPACE', 'VARIATIONAL_SPACE')


def test_spaces_match_jax():
    for name in SPACES:
        assert ([vars(p) for p in getattr(tsearch, name)]
                == [vars(p) for p in getattr(jsearch, name)])


@pytest.mark.parametrize('name', SPACES)
def test_param_spec_draws_match_jax(name):
    for p, q in zip(getattr(tsearch, name), getattr(jsearch, name)):
        ra, rb = random.Random(3), random.Random(3)
        for _ in range(20):
            v = p.sample(ra)
            assert v == q.sample(rb) and p.low <= v <= p.high
            assert p.perturb(v, ra) == q.perturb(v, rb)


def _points(seed, n=30):
    rng = np.random.default_rng(seed)
    pts = [tuple(map(float, p)) for p in rng.uniform(0, 10, (n, 2))]
    return pts + [pts[0], (pts[1][0], pts[2][1])]   # a duplicate, a shared y


@pytest.mark.parametrize('seed', [0, 1])
def test_pareto_and_hypervolume_match_jax(seed):
    cases = [[(1, 5), (2, 4), (3, 3), (2.5, 4.5), (0.5, 6)], _points(seed)]
    for pts in cases:
        assert tsearch.pareto_front(pts) == jsearch.pareto_front(pts)
        for ref in ((0.0, 0.0), (2.0, 3.0)):
            assert tsearch.hypervolume_2d(pts, ref) == jsearch.hypervolume_2d(pts, ref)
    assert sorted(cases[0][i] for i in tsearch.pareto_front(cases[0])) == \
        [(0.5, 6), (1, 5), (2.5, 4.5), (3, 3)]
    assert tsearch.hypervolume_2d([(2, 3), (3, 1)]) == pytest.approx(7.0)
    xs, ys = zip(*cases[1])
    for mx in (True, False):
        for my in (True, False):
            assert (tanalysis.pareto_frontier(xs, ys, mx, my)
                    == janalysis.pareto_frontier(xs, ys, mx, my))
    assert set(zip(*tanalysis.pareto_frontier([1, 2, 3, 4], [10, 8, 9, 2]))) == \
        {(4, 2), (3, 9), (1, 10)}


@pytest.mark.parametrize('strategy', ['sobol', 'gp_ehvi'])
def test_search_suggestions_match_jax(strategy):
    a = tsearch.MultiObjectiveSearch(tsearch.SMALLIFY_SPACE, total_trials=10, seed=1,
                                     generation_strategy=strategy)
    b = jsearch.MultiObjectiveSearch(jsearch.SMALLIFY_SPACE, total_trials=10, seed=1,
                                     generation_strategy=strategy)
    for i in range(10):
        p = a.suggest(i)
        assert p == b.suggest(i)
        for spec in tsearch.SMALLIFY_SPACE:
            assert spec.low <= p[spec.name] <= spec.high
            if spec.integer:
                assert p[spec.name] == int(p[spec.name])
    with pytest.raises(ValueError):
        tsearch.MultiObjectiveSearch(tsearch.SMALLIFY_SPACE, generation_strategy='nope')


def _arg(cmd, name):
    return cmd[cmd.index(f'--{name}') + 1]


def _fake_trainer(log):
    """A stand-in trainer: info.txt from a fixed function of the trial's
    flags (the same for both packages), the command logged."""
    def run(cmd, expdir):
        log.append(cmd)
        os.makedirs(expdir, exist_ok=True)
        lam = float(_arg(cmd, 'lambda_drop_loss')) if '--lambda_drop_loss' in cmd else 1e-8
        g = float(_arg(cmd, 'grid_size'))
        ratio = 10.0 * (lam / 1e-8) ** 0.25 * (1.0 + 0.3 * math.sin(g))
        psnr = 45.0 - 3.0 * math.log10(max(ratio, 1.0)) + 0.2 * math.cos(3 * g)
        tconfig.write_dict({'compression_ratio': ratio, 'psnr': psnr,
                            'rmse': 10 ** (-psnr / 20)}, 'info.txt', expdir)
    return run


@pytest.mark.parametrize('drop_type', ['smallify', 'variational_dynamic', ''])
@pytest.mark.parametrize('strategy', ['sobol', 'gp_ehvi'])
def test_run_search_dry_matches_jax(strategy, drop_type, tmp_path, monkeypatch):
    out = {}
    for name, mod in (('jax', jsearch), ('torch', tsearch)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        cfg = str(tmp_path / name / 'base.txt')
        tconfig.write_dict({'data': 'x.npy', 'max_pass': 5}, 'base.txt', str(tmp_path / name))
        log = []
        trials = mod.run_search(cfg, drop_type=drop_type, total_trials=8, parallelism=3,
                                basedir='/nas_out/', seed=0, generation_strategy=strategy,
                                extra_overrides={'wavelet_filter': 'db2', 'max_pass': 1},
                                dry_run_cmd=_fake_trainer(log))
        out[name] = trials, log
    (jt, jlog), (tt, tlog) = out['jax'], out['torch']
    assert [t.params for t in tt] == [t.params for t in jt]
    assert [t.metrics for t in tt] == [t.metrics for t in jt]
    assert [t.expname for t in tt] == [f'nas_trial_{i}' for i in range(8)]
    assert all(t.metrics and 'compression_ratio' in t.metrics for t in tt)
    for a, b in zip(tlog, jlog):
        assert a[1] == 'train_torch.py' and b[1] == 'train.py'
        assert a[2:] == [s.replace(str(tmp_path / 'jax'), str(tmp_path / 'torch'))
                         for s in b[2:]]
    # a string value goes as its repr
    assert _arg(tlog[0], 'wavelet_filter') == "'db2'"


def _runs(base, lams, law=lambda lam: math.exp(0.5 * math.log(lam) + 12)):
    for i, lam in enumerate(lams):
        d = base / f'run_{i}'
        d.mkdir(parents=True)
        tconfig.write_dict({'lambda_drop_loss': lam, 'lr': 0.008}, 'config.txt', str(d))
        tconfig.write_dict({'compression_ratio': float(law(lam)), 'psnr': 40.0 - i,
                            'num_zeros': 1000.0 * (i + 1), 'num_parameters': 113521},
                           'info.txt', str(d))
    (base / 'no_info').mkdir()
    (base / 'a_file.txt').write_text('x = 1\n')
    return str(base)


def test_analysis_matches_jax(tmp_path):
    base = _runs(tmp_path / 'runs', [1e-8, 1e-7, 1e-6, 1e-5])
    runs = tanalysis.collect_experiments(base)
    assert runs == janalysis.collect_experiments(base) and len(runs) == 4
    assert tanalysis.load_experiment(runs[0]['path']) == janalysis.load_experiment(runs[0]['path'])
    assert tanalysis.load_experiment(str(tmp_path)) == {'info': {}, 'config': {}}
    xs = [float(r['config']['lambda_drop_loss']) for r in runs]
    ys = [float(r['info']['compression_ratio']) for r in runs]
    a, b = tanalysis.fit_log_linear(xs, ys)
    assert (a, b) == janalysis.fit_log_linear(xs, ys)
    assert a == pytest.approx(0.5, abs=1e-6)
    assert tanalysis.param_for_target_ratio(a, b, 150.0) == \
        janalysis.param_for_target_ratio(a, b, 150.0)
    targets = tanalysis.targets_from_frontier(runs, target_ratios=(100.0, 250.0))
    assert targets == janalysis.targets_from_frontier(runs, target_ratios=(100.0, 250.0))
    assert np.exp(0.5 * np.log(targets[100.0]) + 12) == pytest.approx(100.0, rel=1e-6)
    with pytest.raises(ValueError, match='>= 2 completed runs'):
        tanalysis.targets_from_frontier(runs[:1])


def test_trigger_commands_match_jax(tmp_path):
    base = _runs(tmp_path / 'runs', [1e-9, 1e-8, 1e-7])
    dirs = [os.path.join(base, f'run_{i}') for i in range(3)]
    over = {'wavelet_filter': '', 'grid_size': 12}
    got = ttrig.rerun_frontier_configs(dirs, over, basedir='/qc/', dry_run=True)
    want = jtrig.rerun_frontier_configs(dirs, over, basedir='/qc/', dry_run=True)
    got_t = ttrig.runs_at_target_ratios(base, 'c.txt', target_ratios=(100, 300),
                                        basedir='/qc/', dry_run=True)
    want_t = jtrig.runs_at_target_ratios(base, 'c.txt', target_ratios=(100, 300),
                                         basedir='/qc/', dry_run=True)
    for a, b in zip(got + got_t, want + want_t):
        assert a[:1] == b[:1] and a[1] == 'train_torch.py' and a[2:] == b[2:]
    assert len(got) == 3 and len(got_t) == 2
    assert got[0][-4:] == ['--wavelet_filter', '', '--grid_size', '12']
    assert _arg(got_t[1], 'expname') == 'qc_target_300'


def test_read_trial_metrics_match_jax(tmp_path):
    from torch.utils.tensorboard import SummaryWriter
    log_dir = str(tmp_path / 'runs' / 'trial0')
    w = SummaryWriter(log_dir)
    for step, val in enumerate([10.0, 20.0, 150.0]):
        w.add_scalar('compression_ratio', val, step)
    w.add_scalar('psnr', 33.5)
    w.add_scalar('loss', 0.25)
    w.close()
    tb = tsearch.read_trial_metrics_tb(log_dir)
    assert tb == jsearch.read_trial_metrics_tb(log_dir)
    assert tb == {'compression_ratio': 150.0, 'psnr': 33.5}
    exp = tmp_path / 'exp'
    exp.mkdir()
    tconfig.write_dict({'compression_ratio': 1.0, 'psnr': 1.0, 'name': 'x'}, 'info.txt',
                       str(exp))
    for tb_dir in (log_dir, str(tmp_path / 'nope'), None):
        got = tsearch.read_trial_metrics(str(exp), tb_dir)
        assert got == jsearch.read_trial_metrics(str(exp), tb_dir)
    assert tsearch.read_trial_metrics(str(exp), log_dir)['compression_ratio'] == 150.0
    assert tsearch.read_trial_metrics(str(exp), None) == {'compression_ratio': 1.0,
                                                          'psnr': 1.0}
    assert tsearch.read_trial_metrics(str(tmp_path / 'missing'),
                                      str(tmp_path / 'nope')) is None
    assert tsearch.read_trial_metrics_tb(str(tmp_path / 'nope')) is None


# --- nas/bayesopt.py -------------------------------------------------------

@pytest.mark.parametrize('name', SPACES)
def test_normalizer_matches_jax(name):
    tn, jn = tbo.SpaceNormalizer(getattr(tsearch, name)), jbo.SpaceNormalizer(
        getattr(jsearch, name))
    r = random.Random(5)
    for _ in range(10):
        p = {s.name: s.sample(r) for s in getattr(tsearch, name)}
        x = tn.encode(p)
        np.testing.assert_array_equal(x, jn.encode(p))
        assert ((x >= 0) & (x <= 1)).all()
        back = tn.decode(x)
        assert back == jn.decode(x)
        for k, v in p.items():
            assert back[k] == pytest.approx(v, rel=1e-6)


def test_gp_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.random((20, 2))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    tg, jg = tbo.GP(X, y), jbo.GP(X, y)
    assert (tg.ls, tg.noise) == (jg.ls, jg.noise)
    q = np.vstack([X, rng.random((7, 2)), [[5.0, 5.0]]])
    for a, b in zip(tg.posterior(q), jg.posterior(q)):
        np.testing.assert_array_equal(a, b)
    mu, var = tg.posterior(X)
    assert np.abs(mu - y).max() < 0.2
    assert tg.posterior(np.array([[5.0, 5.0]]))[1][0] > var.mean()


def test_hv2_front_mask_and_ehvi_match_jax():
    rng = np.random.default_rng(1)
    pts = np.vstack([rng.random((40, 2)) * 4, [[2.0, 3.0], [3.0, 1.0], [1.0, 1.0]]])
    for ref in (np.zeros(2), np.array([1.0, 1.5])):
        assert tbo._hv2(pts, ref) == jbo._hv2(pts, ref)
    np.testing.assert_array_equal(tbo._front_mask(pts), jbo._front_mask(pts))
    assert tbo._front_mask(pts[-3:]).tolist() == [True, True, False]
    front = np.array([[1.0, 4.0], [4.0, 1.0]])
    mu = np.array([[3.0, 3.0], [0.5, 0.5], [2.0, 2.5]])
    var = np.array([[1e-6, 1e-6], [1e-6, 1e-6], [0.3, 0.1]])
    got = tbo.mc_ehvi(mu, var, front, np.zeros(2), np.random.default_rng(0), n_samples=16)
    np.testing.assert_array_equal(
        got, jbo.mc_ehvi(mu, var, front, np.zeros(2), np.random.default_rng(0), n_samples=16))
    assert got[0] > got[1] and got[0] == pytest.approx(4.0, rel=0.05)


def _synthetic_objective(params):
    lam = math.log10(params['lambda_drop_loss'])
    g = params['grid_size']
    return (10 ** (2.0 + (lam + 10) / 8.0 - g / 64.0), 38.0 + g / 4.0 - (lam + 10) * 1.2)


def test_generator_suggestions_match_jax():
    tgen = tbo.GPEHVIGenerator(tsearch.SMALLIFY_SPACE, seed=0)
    jgen = jbo.GPEHVIGenerator(jsearch.SMALLIFY_SPACE, seed=0)
    r = random.Random(2)
    observed = []
    for _ in range(2):   # fewer than 3: the generator samples the space
        p = tgen.suggest(observed)
        assert p == jgen.suggest(observed)
        observed.append((p, _synthetic_objective(p)))
    for _ in range(6):
        p = {s.name: s.sample(r) for s in tsearch.SMALLIFY_SPACE}
        observed.append((p, _synthetic_objective(p)))
    for _ in range(5):
        p = tgen.suggest(observed)
        assert p == jgen.suggest(observed)
        for s in tsearch.SMALLIFY_SPACE:
            assert s.low <= p[s.name] <= s.high
        observed.append((p, _synthetic_objective(p)))


def test_search_uses_the_gp_after_exploration_as_jax():
    searches = [mod.MultiObjectiveSearch(mod.SMALLIFY_SPACE, total_trials=8, seed=3,
                                         generation_strategy='gp_ehvi')
                for mod in (tsearch, jsearch)]
    assert all(s._gen is not None for s in searches)
    r = random.Random(4)
    for i in range(6):
        p = {spec.name: spec.sample(r) for spec in tsearch.SMALLIFY_SPACE}
        for s, mod in zip(searches, (tsearch, jsearch)):
            t = mod.Trial(i, dict(p), expname=f't{i}')
            t.metrics = dict(zip(('compression_ratio', 'psnr'), _synthetic_objective(p)))
            s.report(t)
    assert searches[0].suggest(7) == searches[1].suggest(7)


# --- utils/plots.py --------------------------------------------------------

def _nonempty(path):
    assert os.path.exists(path) and os.path.getsize(path) > 0, path
    return path


def test_plot_pareto_comparison_and_hyperparams(tmp_path):
    for i, (ratio, psnr) in enumerate([(50, 45), (100, 40), (200, 38)]):
        d = tmp_path / 'm1' / f'r{i}'
        d.mkdir(parents=True)
        tconfig.write_dict({'compression_ratio': ratio, 'psnr': psnr}, 'info.txt', str(d))
        tconfig.write_dict({'lr': 0.008 * (i + 1), 'grid_size': 10 + i}, 'config.txt', str(d))
    _nonempty(tplots.plot_pareto_comparison({'m1': str(tmp_path / 'm1')},
                                            str(tmp_path / 'cmp.png')))
    _nonempty(tplots.plot_hyperparam_analysis(str(tmp_path / 'm1'), 'lr',
                                              str(tmp_path / 'hp.png')))
    _nonempty(tplots.plot_parallel_coordinates(str(tmp_path / 'm1'), ['lr', 'grid_size'],
                                               str(tmp_path / 'par.png')))
    with pytest.raises(ValueError, match='no complete runs'):
        tplots.plot_parallel_coordinates(str(tmp_path / 'm1'), ['nope'],
                                         str(tmp_path / 'none.png'))


def test_plot_weight_histograms_of_the_ports_model(tmp_path):
    spec = tfg.make_spec(grid_size=8, grid_features=4, hidden=16, num_layers=2)
    model = tfg.init_model(spec, torch.Generator().manual_seed(0), device='cpu')
    _nonempty(tplots.plot_weight_histograms(model, str(tmp_path / 'hist.png')))
    flat = tfg.init_model(tfg.make_spec(grid_size=8, grid_features=4, hidden=16,
                                        num_layers=2, wavelet='none'),
                          torch.Generator().manual_seed(0), device='cpu')
    _nonempty(tplots.plot_weight_histograms(flat, str(tmp_path / 'hist1.png')))


def test_plot_pareto_with_variance(tmp_path):
    rng = np.random.default_rng(3)
    repeats = []
    for rep in range(3):
        base = tmp_path / f'search_{rep}'
        for i in range(6):
            d = base / f'r{i}'
            d.mkdir(parents=True)
            ratio = float(rng.uniform(40, 400))
            tconfig.write_dict({'compression_ratio': ratio,
                                'psnr': float(50 - 4 * np.log10(ratio) + rng.uniform(-1, 1))},
                               'info.txt', str(d))
        repeats.append(str(base))
    _nonempty(tplots.plot_pareto_with_variance({'smallify': repeats},
                                               str(tmp_path / 'var.png')))


def test_plot_quality_control(tmp_path):
    base = _runs(tmp_path / 'qc', [1e-9, 1e-8, 1e-7, 1e-6],
                 law=lambda lam: math.exp(0.4 * math.log(lam) + 12))
    _nonempty(tplots.plot_quality_control(base, 'lambda_drop_loss', str(tmp_path / 'qc.png')))


def test_plot_pruned_ratio_comparison(tmp_path):
    for label in ('with_wavelet', 'without_wavelet'):
        for i, ratio in enumerate([80, 150, 300, 700]):   # 700 > upper_limit
            d = tmp_path / label / f'r{i}'
            d.mkdir(parents=True)
            tconfig.write_dict({'compression_ratio': float(ratio),
                                'num_zeros': 1000.0 * (i + 1),
                                'num_parameters': 113521, 'psnr': 40.0}, 'info.txt', str(d))
    _nonempty(tplots.plot_pruned_ratio_comparison(
        {'with wavelet': str(tmp_path / 'with_wavelet'),
         'without wavelet': str(tmp_path / 'without_wavelet')},
        str(tmp_path / 'pruned.png')))


def test_save_pgf_and_mlflow_are_guarded(tmp_path):
    import shutil
    plt = tplots._plt()
    fig, ax = plt.subplots()
    ax.plot([1, 2], [3, 4])
    if any(shutil.which(t) for t in ('xelatex', 'lualatex', 'pdflatex')):
        _nonempty(tplots.save_pgf(fig, str(tmp_path / 'fig')))
    else:
        with pytest.raises(RuntimeError, match='TeX engine'):
            tplots.save_pgf(fig, str(tmp_path / 'fig'))
    plt.close(fig)
    try:
        import mlflow  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match='mlflow'):
            tplots.mlflow_best_run('psnr', 'exp')


# --- a real search and the quality-control runs ----------------------------

def _volume(n=16):
    x, y, z = np.meshgrid(*[np.linspace(-1, 1, n)] * 3, indexing='ij')
    return (np.sin(3 * x) * np.cos(2 * y) * np.sin(z + 0.5)).astype(np.float32)


def test_search_and_qc_runs_through_train_torch(tmp_path, monkeypatch):
    """2 trials of train_torch.py (through the CPU wrapper) at max_pass 1
    on a 16^3 .cvol volume, a run at the geometric mean of their ratios,
    and the front's first trial again without the wavelet."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    write_cvol(str(tmp_path / 'vol.cvol'), _volume())
    tconfig.write_dict({'data': str(tmp_path / 'vol.cvol'), 'max_pass': 1, 'batch_size': 64,
                        'sample_size': 4, 'n_layers': 2, 'wavelet_filter': 'db2'},
                       'base.txt', str(tmp_path))
    cfg = str(tmp_path / 'base.txt')
    trials = tsearch.run_search(cfg, drop_type='smallify', total_trials=2, parallelism=2,
                                basedir='/nas/', seed=0, train_script=CPU_TRAIN,
                                poll_interval=0.2, generation_strategy='sobol')
    assert len(trials) == 2
    for t in trials:
        assert t.proc.returncode == 0 and t.metrics, t.expname
        exp = tmp_path / 'nas' / t.expname
        info = tconfig.dict_from_file(str(exp / 'info.txt'))
        tb = tsearch.read_trial_metrics_tb(str(tmp_path / 'runs' / t.expname))
        assert tb == t.metrics and set(tb) == set(tsearch._TB_TAGS)
        for tag, value in tb.items():
            key = 'num_zeros' if tag == 'zeroes' else tag
            assert value == float(np.float32(info[key])), tag
        # (16^3 voxels: a model may be larger than the volume)
        assert math.isfinite(info['psnr']) and info['compression_ratio'] > 0
        assert tconfig.dict_from_file(str(exp / 'config.txt'))['grid_size'] == \
            t.params['grid_size']

    ratios = [t.metrics['compression_ratio'] for t in trials]
    target = math.exp(sum(map(math.log, ratios)) / len(ratios))
    cmds = ttrig.runs_at_target_ratios(str(tmp_path / 'nas'), cfg,
                                       param_key='lambda_drop_loss', target_ratios=(target,),
                                       basedir='/qc/', train_script=CPU_TRAIN)
    assert len(cmds) == 1
    qc = tmp_path / 'qc' / f'qc_target_{int(target)}'
    lam = tconfig.dict_from_file(str(qc / 'config.txt'))['lambda_drop_loss']
    # at the trials' geometric-mean ratio the fitted law gives their
    # geometric-mean parameter, whatever its slope
    lams = [t.params['lambda_drop_loss'] for t in trials]
    assert lam == pytest.approx(math.exp(sum(map(math.log, lams)) / 2), rel=1e-6)
    assert math.isfinite(tconfig.dict_from_file(str(qc / 'info.txt'))['psnr'])

    front = [trials[i] for i in tsearch.pareto_front([t.objective for t in trials])]
    # the trial's config.txt names its model.npz as checkpoint_path: a
    # rerun under another wavelet starts afresh
    ttrig.rerun_frontier_configs([str(tmp_path / 'nas' / front[0].expname)],
                                 {'wavelet_filter': '', 'checkpoint_path': ''},
                                 basedir='/qc/', train_script=CPU_TRAIN)
    rerun = tmp_path / 'qc' / 'qc_rerun_0'
    info = tconfig.dict_from_file(str(rerun / 'info.txt'))
    assert math.isfinite(info['psnr']) and info['compression_ratio'] > 0
    conf = tconfig.dict_from_file(str(rerun / 'config.txt'))
    assert conf['wavelet_filter'] == '' and conf['grid_size'] == front[0].params['grid_size']
    assert sys.executable == cmds[0][0]


def _example(script):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        'examples', script)
    spec = importlib.util.spec_from_file_location(script[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_nas_example_matches_jaxs(tmp_path, monkeypatch, capsys):
    """examples/nas_example_torch.py is examples/nas_example.py over the
    port: the same search, frontier and plot from the same stand-in
    trainer; the trials run train_torch.py."""
    out = {}
    for name, script in (('jax', 'nas_example.py'), ('torch', 'nas_example_torch.py')):
        ex = _example(script)
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        cfg = str(tmp_path / name / 'base.txt')
        tconfig.write_dict({'data': 'x.npy', 'max_pass': 5}, 'base.txt', str(tmp_path / name))
        log = []
        search = ex.run_search
        monkeypatch.setattr(ex, 'run_search', lambda *a, **k: search(
            *a, dry_run_cmd=_fake_trainer(log), **k))
        monkeypatch.setattr(sys, 'argv', [script, '--config', cfg, '--trials', '6',
                                          '--parallelism', '2', '--basedir', '/nas_out/'])
        ex.main()
        printed = capsys.readouterr().out.splitlines()
        out[name] = [ln for ln in printed if ln.startswith('  trial ')]
        wrote = [ln for ln in printed if ln.startswith('wrote ')]
        assert len(wrote) == 1 and os.path.exists(wrote[0][len('wrote '):])
        assert os.path.basename(log[0][1]) == {'jax': 'train.py', 'torch': 'train_torch.py'}[name]
    assert out['torch'] and out['torch'] == out['jax']
