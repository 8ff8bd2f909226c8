"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration
(benchmark/configs/<config>.json) and its traffic
(benchmark/traffic/<traffic>.json, which names the driver); the cell's
own file (benchmark/workloads/<cell>.json) holds the check's sizes and
limits; each per-layer metric is read by benchmark/metrics/<metric>.py.
Set-up builds the scene and the program's object from the seed and warms
up; the window runs the driver's units until `--seconds` have passed and
the device has finished; then the reference checks what the window
produced.  With --trace 1 the first units of the window run under
torch.profiler and the per-layer metrics are printed instead of the
end-to-end ones.  The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pathtracer_tpu')


def _load(kind: str, name: str) -> dict:
    with open(os.path.join(ROOT, 'benchmark', kind, name + '.json')) as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def _listed(entries, cell):
    return [m for m in entries if cell in m.get('workloads', [cell])]


def _reader(name: str):
    import importlib.util
    path = os.path.join(ROOT, 'benchmark', 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location('_metric_' + name.replace(
        '.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = 'cuda', overrides: dict = None, controls=()):
    """One run of a cell; returns (result dict, check lines).  `device`
    'cpu' and `overrides` ({'config': {...}, 'traffic': {...}, 'check':
    {...}}, merged into the files) serve the CPU tests.  `controls`: float
    dtypes in which the reference is also run and held, in the program's
    place, to the float32 reference (result['controls'])."""
    import torch
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.harness import check as check_mod
    from benchmark.harness import drivers
    from benchmark.harness import trace as trace_mod

    overrides = overrides or {}
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    cell = next(w for w in bench['workloads'] if w['name'] == workload)
    cfg = _merge(_load('configs', cell['config']), overrides.get('config'))
    traffic = _merge(_load('traffic', cell['traffic']),
                     overrides.get('traffic'))
    spec = _merge(_load('workloads', workload), overrides.get('check'))
    seed = int(seed) & ((1 << 64) - 1)
    host = {}
    drv = drivers.DRIVERS[traffic['driver']](cfg, traffic, spec, seed,
                                             device, host)
    cuda = torch.device(device).type == 'cuda'
    drv.setup()
    setup_s = time.perf_counter() - T0
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    units, traced = {}, None

    def add(into, u):
        for k, v in u.items():
            into[k] = into.get(k, 0) + v

    t0 = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        cpu_act, dev_act = ProfilerActivity.CPU, ProfilerActivity.CUDA
        views = []
        # first the device alone, which costs the host little: busy and
        # idle time, kernels; then the host's ops too, with the harness's
        # labels: what ran inside a label, what the host did in the gaps
        for acts, labelled in (([dev_act] if cuda else [cpu_act], False),
                               ([cpu_act] + ([dev_act] if cuda else []),
                                True)):
            tu = {}
            with (drv.traced() if labelled else contextlib.nullcontext()), \
                    profile(activities=acts) as prof:
                w0 = time.perf_counter_ns()
                for _ in range(traffic['trace_units']):
                    add(tu, drv.unit())
                drivers._sync(device)
                w1 = time.perf_counter_ns()
            add(units, tu)
            views.append(trace_mod.read_events(prof, w1 - w0, tu, host))
        traced = views[0]
        traced.labelled = views[1]
    # the window lasts `seconds`, and at least until one answer is due
    while time.perf_counter() - t0 < seconds or not drv.answered():
        add(units, drv.unit())
    drivers._sync(device)
    elapsed = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0

    metrics = {}
    if trace:
        for m in _listed(bench['per_layer'], workload):
            v = _reader(m['name'])(traced)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        # a metric is found by its name's ending, so a cell may name its
        # own rate (`analytic_samples_per_s`) with no edit here
        w, h = cfg['resolution']
        e2e = {'setup_s': setup_s, 'peak_mem_gib': window_peak / 2 ** 30}
        if 'waves' in units:
            e2e['samples_per_s'] = units['samples'] * w * h / elapsed
        if 'steps' in units:
            e2e['grad_step_ms'] = elapsed / units['steps'] * 1e3
        for m in _listed(bench['end_to_end'], workload):
            kind = next((k for k in e2e if m['name'].endswith(k)), None)
            if kind is None:
                raise RuntimeError(f'{m["name"]} is not measured in a '
                                   f'{traffic["driver"]} cell')
            metrics[m['name']] = {'value': e2e[kind], 'unit': m['unit']}
    # the check, once the window has closed and the program is done with
    c0 = time.perf_counter()
    pairs = drv.compare()
    host['check_s'] = time.perf_counter() - c0
    numbers = check_mod.NUMBERS[traffic['driver']](pairs, spec)
    correct, judged = check_mod.judge(numbers, spec['limits'])
    held = {}
    for dt in controls:
        ctl = [(c, r) for (_, c), (_, r) in zip(drv.compare(dt), pairs)]
        n = check_mod.NUMBERS[traffic['driver']](ctl, spec)
        held[str(dt).replace('torch.', '')] = dict(
            numbers=n, correct=check_mod.judge(n, spec['limits'])[0])
    drv.close()
    device_info = {'platform': 'gpu' if cuda else 'cpu',
                   'kind': (torch.cuda.get_device_name() if cuda
                            else 'cpu'),
                   'count': 1,
                   'memory_peak_bytes': int(max(setup_peak, window_peak))}
    result = {'correct': correct,
              'attempted': int(units.get('waves', units.get('steps', 0))),
              'failed': 0, 'metrics': metrics, 'device': device_info}
    if trace:
        device_info['busy_s'] = traced.busy_ns() / 1e9
        device_info['window_s'] = traced.window_ns / 1e9
        result['breakdown'] = {
            'device_ops': traced.breakdown()['device_ops'],
            'idle_gaps': traced.labelled.breakdown()['idle_gaps']}
    if controls:
        result['controls'] = held
    result['check'] = judged
    host['window_s'] = elapsed
    lines = ['times ' + ' '.join(f'{k} {v!r}' for k, v in host.items()),
             'checked ' + ' '.join(f'{k} {v!r}' for k, v in numbers.items()
                                   if k not in judged)]
    lines += [f'check {k} {v["value"]!r} limit {v["limit"]!r}'
              for k, v in judged.items()]
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f'the run loaded {", ".join(bad)}: nothing it runs '
                         'may import JAX or the JAX package')
    return result, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cache = os.path.join(ROOT, '.bench_cache')
    # every kernel cache at a fixed place inside the checkout
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache,
                                                      'torch_extensions')
    os.environ['CUDA_CACHE_PATH'] = os.path.join(cache, 'nv')
    import torch
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        cells = {w['name']: w for w in json.load(f)['workloads']}
    if a.workload not in cells:
        sys.exit(f'unknown workload {a.workload!r}; BENCHMARK.json has '
                 f'{sorted(cells)}')
    need = cells[a.workload]['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        sys.exit(f'{a.workload} needs {need} CUDA device(s); this machine '
                 f'has {torch.cuda.device_count()}')
    emit(*run(a.workload, a.seed, a.seconds, bool(a.trace)))


def emit(result: dict, lines):
    """The check's lines last on standard error, the result line last on
    standard output."""
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
