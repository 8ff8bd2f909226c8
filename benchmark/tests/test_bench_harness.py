"""The harness on the CPU: every file found by name, the contract's last
line, the traced line, the refusals, the sample count, and no JAX."""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import run as bench_run
from benchmark.tests.conftest import BENCH, CELLS, ROOT, tiny

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def _entry(cell):
    return next(w for w in BENCH['workloads'] if w['name'] == cell)


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['benchmark']
    assert 1 <= BENCH['run_seconds'] <= 51
    names = [c['name'] for c in BENCH['configs']] + CELLS + [
        m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m['name'] == 'setup_s' for m in BENCH['end_to_end'])
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    e2e = {m['name'] for m in BENCH['end_to_end']}
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e and 'bound' not in m
    for cell in CELLS:
        reported = [m for m in BENCH['end_to_end']
                    if cell in m.get('workloads', [cell])]
        assert len(reported) >= 2
        assert any(cell in m.get('workloads', [cell])
                   for m in BENCH['per_layer'])


@pytest.mark.parametrize('kind,name', [
    ('configs', c['name']) for c in BENCH['configs']] + [
    ('traffic', w['traffic']) for w in BENCH['workloads']] + [
    ('workloads', w['name']) for w in BENCH['workloads']])
def test_data_files_load_by_name(kind, name):
    with open(os.path.join(ROOT, 'benchmark', kind, name + '.json')) as f:
        data = json.load(f)
    if kind == 'workloads':
        assert data['limits']
    if kind == 'traffic':
        from benchmark.harness import drivers
        assert data['driver'] in drivers.DRIVERS


@pytest.mark.parametrize('name', [m['name'] for m in BENCH['per_layer']])
def test_metric_readers_load_by_name(name):
    path = os.path.join(ROOT, 'benchmark', 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location('m', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


@pytest.mark.parametrize('cell', CELLS)
def test_tiny_run_prints_the_last_line(cell, capsys):
    bench_run.emit(*bench_run.run(cell, 2 ** 31 + 12345, 0.3, False,
                                  device='cpu', overrides=tiny(cell)))
    out, err = capsys.readouterr()
    res = json.loads(out.strip().splitlines()[-1])
    assert list(res)[-1] == 'check'
    assert {'correct', 'attempted', 'failed', 'metrics',
            'device'} <= set(res)
    assert res['correct'] is True and res['attempted'] >= 1
    want = {m['name'] for m in BENCH['end_to_end']
            if cell in m.get('workloads', [cell])}
    assert set(res['metrics']) == want
    assert all(v['value'] > 0 for k, v in res['metrics'].items()
               if k != 'peak_mem_gib')
    assert {'platform', 'kind', 'count', 'memory_peak_bytes'} <= set(
        res['device'])
    last = err.strip().splitlines()[-len(res['check']):]
    for name, line in zip(res['check'], last):
        assert line.startswith(f'check {name} ') and ' limit ' in line


@pytest.mark.parametrize('cell', CELLS)
def test_tiny_traced_run(cell):
    res, _ = bench_run.run(cell, 77, 0.3, True, device='cpu',
                           overrides=tiny(cell))
    assert res['correct'] is True
    assert {'busy_s', 'window_s'} <= set(res['device'])
    assert set(res['breakdown']) == {'device_ops', 'idle_gaps'}
    listed = {m['name'] for m in BENCH['per_layer']
              if cell in m.get('workloads', [cell])}
    # on the CPU only host-clock metrics have something to read
    assert set(res['metrics']) <= listed
    if 'scene_build_s' in listed:
        assert res['metrics']['scene_build_s']['value'] > 0


def test_pixel_samples_are_counted_exactly(monkeypatch):
    """The rate's numerator: every lane the integrator traces in the
    window is one counted pixel-sample."""
    from pathtracer_tpu_torch.render import integrator
    lanes = []
    orig = integrator.trace_paths

    def counting(sc, origins, *a, **k):
        lanes.append(origins.shape[0])
        return orig(sc, origins, *a, **k)

    from benchmark.harness import drivers
    ov = tiny('bigmesh.render')
    cfg = bench_run._merge(bench_run._load('configs', 'bigmesh'),
                           ov['config'])
    traffic = bench_run._load('traffic', 'frames_1spp')
    spec = bench_run._merge(bench_run._load('workloads', 'bigmesh.render'),
                            ov['check'])
    drv = drivers.Frames(cfg, traffic, spec, 5, 'cpu', {})
    drv.setup()
    monkeypatch.setattr(integrator, 'trace_paths', counting)
    samples = sum(drv.unit()['samples'] for _ in range(5))
    w, h = cfg['resolution']
    assert sum(lanes) == samples * w * h == 5 * w * h


def test_cli_refuses_without_a_card():
    p = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                        CELLS[0], '--seed', '1', '--seconds', '1',
                        '--trace', '0'], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    assert p.returncode != 0 and p.stdout == ''


def test_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    prints no result."""
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(ROOT, 'benchmark'), tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    env = dict(os.environ, PYTHONPATH='')
    code = ('import sys; sys.argv = ["run.py", "--workload", "%s", "--seed",'
            ' "1", "--seconds", "1"]; sys.path.insert(0, "benchmark");'
            ' import run; run.run("%s", 1, 0.1, False, device="cpu")'
            % (CELLS[0], CELLS[0]))
    p = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0 and p.stdout == ''
    assert 'pathtracer_tpu_torch' in p.stderr


def test_a_tiny_run_loads_no_jax():
    """A whole run in a fresh interpreter, then the whole top-level name
    of every loaded module against JAX's and the JAX package's."""
    code = ('import json, sys; from benchmark import run as R;'
            ' from benchmark.tests.conftest import tiny;'
            ' res, _ = R.run("bigmesh.render", 3, 0.2, False, device="cpu",'
            ' overrides=tiny("bigmesh.render"));'
            ' print(json.dumps([res["correct"], R.forbidden_modules(),'
            ' "pathtracer_tpu_torch" in sys.modules]))')
    p = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    correct, bad, port = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct and bad == [] and port


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'pathtracer_tpu_fake', sys)
    assert 'pathtracer_tpu' not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jaxlib.fake', sys)
    assert bench_run.forbidden_modules() == ['jaxlib']
