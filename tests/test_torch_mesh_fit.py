"""The `bigmesh_fit.grad` cell on the CPU at a tiny size: inverse rendering
around a mesh through the cluster tier, the program's loss and gradients
against the benchmark's plain reference, the bfloat16 control and two
planted faults against the cell's limits, and the cell's files and
metric readers.

The harness's `run()` refuses a process that has loaded JAX, as the
suite's workers have, so `GradSteps`, the reference and the check are
called directly, as `run()` calls them.  Sizes: 24x16 pixels x 4 spp on
a 24x24 displaced sphere (1,152 triangles), the configuration's scene,
camera and light otherwise.  Loss and gradients agree within float32
rounding (measured 6.2e-8 and 1.1e-7; held to 1e-5); the bfloat16
reference reads about 0.7 on both, above the limits 1e-3 and 2e-3.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import check
from benchmark.harness import drivers
from benchmark.harness import spans as sp
from benchmark.harness.trace import TraceView
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL, CONFIG = 'bigmesh_fit.grad', 'bigmesh_fit'
SEED = 2 ** 31 + 12345
MS = 1_000_000


def _load(kind, name):
    with open(os.path.join(ROOT, 'benchmark', kind, name + '.json')) as f:
        return json.load(f)


def _tiny_cfg():
    cfg = _load('configs', CONFIG)
    cfg['resolution'] = [24, 16]
    cfg['mesh'] = dict(cfg['mesh'], n_lat=24, n_lon=24)
    return cfg


def _spec():
    return _load('workloads', CELL)


def _fit_steps(seed, warmup=True):
    """The cell's `GradSteps` at the tiny size after set-up, with one
    step in its window."""
    traffic = _load('traffic', 'grad_steps')
    if not warmup:
        traffic['warmup_steps'] = 0
    drv = drivers.GradSteps(_tiny_cfg(), traffic, _spec(), seed, 'cpu', {})
    drv.setup()
    drv.unit()
    return drv


def _judged(pairs):
    numbers = check.grad_numbers(pairs, _spec())
    return numbers, check.judge(numbers, _spec()['limits'])[0]


@pytest.fixture(scope='module')
def fitted():
    """The cell's `GradSteps` and its float32 reference pairs."""
    drv = _fit_steps(SEED)
    return drv, drv.compare()


def test_program_agrees_with_the_reference(fitted):
    drv, pairs = fitted
    numbers, correct = _judged(pairs)
    assert correct and numbers['steps'] == 1
    assert numbers['loss_gap'] <= 1e-5 and numbers['grad_gap'] <= 1e-5
    (loss, grads), _ = pairs[0]
    # the scene's mesh is hit and the gradients are not all zero
    assert loss > 0 and np.abs(grads['kd']).max() > 0
    assert grads['light_intensity'] > 0


def test_bfloat16_reference_fails_the_limits(fitted):
    drv, pairs = fitted
    ctl = [(c, r) for (_, c), (_, r) in zip(drv.compare(torch.bfloat16),
                                            pairs)]
    numbers, correct = _judged(ctl)
    assert not correct
    assert numbers['loss_gap'] > _spec()['limits']['loss_gap']


def _half_samples(img, samples):
    return samples[:, :, :samples.shape[2] // 2].mean(dim=2), samples


def _scaled_image(img, samples):
    return img * 1.01, samples


@pytest.mark.parametrize('fault', [_half_samples, _scaled_image],
                         ids=['half_samples', 'scaled_image'])
def test_planted_fault_turns_the_check_false(fault, monkeypatch):
    from pathtracer_tpu_torch.render import renderer
    orig = renderer.render_unsplatted
    monkeypatch.setattr(renderer, 'render_unsplatted',
                        lambda *a, **k: fault(*orig(*a, **k)))
    drv = _fit_steps(SEED + 1, warmup=False)
    assert not _judged(drv.compare())[1]


def test_cell_files_load():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    conf = next(c for c in bench['configs'] if c['name'] == CONFIG)
    cell = next(w for w in bench['workloads'] if w['name'] == CELL)
    assert conf['reduced'] == ['mesh', 'resolution']
    assert len(conf['source']) <= 200 and len(cell['why']) <= 200
    assert (cell['config'], cell['traffic'], cell['chips']) == (
        CONFIG, 'grad_steps', 1)
    step = next(m for m in bench['end_to_end'] if m['name'] == 'grad_step_ms')
    assert CELL in step['workloads']
    # the scene, camera, light, objects and mesh of the render cell
    cfg, base = _load('configs', CONFIG), _load('configs', 'bigmesh')
    for key in ('resolution', 'bounces', 'camera', 'light_intensity',
                'objects', 'mesh'):
        assert cfg[key] == base[key], key
    assert (cfg['spp'], cfg['lane_tile'], cfg['program']) == (
        4, 0, {'backface_cull': False})
    assert _spec() == {'max_steps': 1,
                       'limits': {'loss_gap': 1e-3, 'grad_gap': 2e-3}}


def _reader(name):
    import importlib.util
    path = os.path.join(ROOT, 'benchmark', 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location('m', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(i, name, a, b, **attrs):
    return SimpleNamespace(name=name, id=i, parent=None, root=i,
                           start_ns=a * MS, end_ns=b * MS, attrs=attrs)


@pytest.fixture
def step_trace(monkeypatch):
    """One traced step, labelled pass from t 1000 ms: a forward sample
    (1010-1090) with a query (1020-1040), its recompute (1100-1200) with a
    query (1110-1150); kernels of 4 ms launched in the forward's query, 7
    in the recompute's query, 3 in the recompute outside it, 5 outside
    every span, and a copy, which is no kernel."""
    spans = [_span(1, 'pt.sample', 1010, 1090, k=0, recompute=False),
             _span(2, 'pt.query', 1020, 1040, kind='closest'),
             _span(3, 'pt.sample', 1100, 1200, k=0, recompute=True),
             _span(4, 'pt.query', 1110, 1150, kind='shadow')]
    monkeypatch.setattr(sp, 'recorded', lambda: spans)
    kernels = [(1030, 4, 'hier_kernel'), (1120, 7, 'sweep_kernel'),
               (1160, 3, 'elementwise'), (1300, 5, 'elementwise'),
               (1125, 9, 'Memcpy HtoD')]
    labelled = TraceView(
        device=[(t * MS, (t + d) * MS, n, i)
                for i, (t, d, n) in enumerate(kernels, 1)],
        ranges={}, launch_start={i: t * MS
                                 for i, (t, _, _) in enumerate(kernels, 1)},
        window_ns=400 * MS, units={'steps': 1}, host={},
        host_ops=[(1001 * MS, 1002 * MS, 'aten::mul')])
    return TraceView(device=[], ranges={}, launch_start={},
                     window_ns=400 * MS, units={'steps': 1}, host={},
                     host_ops=[], labelled=labelled)


@pytest.mark.parametrize('name,want', [('query_ms.fit', 11.0),
                                       ('requery_share.fit', 70.0)])
def test_readers_known_answers(step_trace, name, want):
    assert _reader(name)(step_trace) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize('name', ['query_ms.fit', 'requery_share.fit'])
def test_readers_give_nothing_without_the_recorder(step_trace, name,
                                                   monkeypatch):
    monkeypatch.setattr(sp, 'recorded', lambda: None)
    assert _reader(name)(step_trace) is None


def test_sweep_operators_take_the_launch_arguments():
    """Both sweeps launch through torch operators whose outputs and
    counters are mutable arguments (the CUDA kernels are their only
    implementation)."""
    from pathtracer_tpu_torch.ops import cluster  # noqa: F401 (defines them)
    ops = torch.ops.pathtracer_tpu_torch
    for op, outs in ((ops.cluster_sweep_launch,
                      ('t_out', 'tri_out', 'stats')),
                     (ops.cluster_sweep_any_launch, ('occ_out', 'stats'))):
        args = {a.name: a for a in op.default._schema.arguments}
        assert all(args[o].alias_info is not None
                   and args[o].alias_info.is_write for o in outs)
        assert [str(args[k].type) for k in ('n_sub', 'group')] == ['int'] * 2
