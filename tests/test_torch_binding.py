"""PyTorch port, the one binding of the hand-written CUDA kernels
(ops/binding.py), on the CPU and without building anything.

The library table declares every ``extern "C"`` entry point of every
csrc/*.cu source with the argument types of its C declaration; every
operator a wrapper calls is defined once the package is imported, with
its entry point's arguments by name, kind and order; each operator's
CUDA kernel hands its entry point exactly its arguments and the stream,
raises with the entry point's name on an error code and counts the
launch (run here against a stand-in library); and the CPU route of every
wrapper launches nothing, so no counter moves.  The kernels
themselves run only on a GPU (tests/test_torch_gpu.py, chip_smoke.py).
"""

import ctypes
import glob
import os
import re
import types

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch  # noqa: F401 (defines the operators)
from pathtracer_tpu_torch.core import rng
from pathtracer_tpu_torch.ops import binding
from pathtracer_tpu_torch.ops import bvh as bvh_mod
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.ops import packet_bvh as tp
from pathtracer_tpu_torch.ops import pcg_draw as pcg
from pathtracer_tpu_torch.ops import sweep_ablate as sa
from pathtracer_tpu_torch.ops import sweep_micro as sm
from pathtracer_tpu_torch.ops import traverse as tt
from pathtracer_tpu_torch.utils import procgen, profiling
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

CSRC = os.path.join(os.path.dirname(binding.__file__), os.pardir, 'csrc')
SOURCES = sorted(os.path.basename(f)[:-3]
                 for f in glob.glob(os.path.join(CSRC, '*.cu')))
WRAPPERS = ('cluster_sweep', 'cluster_sweep_any', 'cull_tree', 'hier_cull',
            'packet_hit', 'dot_fp32', 'dot_tf32', 'epilogue', 'edgemat',
            'sweep_ablate', 'pcg_draw')


def _entry_points(src):
    """{name: [(ctypes type, name, written) of each parameter]} of the
    extern "C" functions of csrc/<src>.cu, read from their declarations (a
    pointer c_void_p, written unless const; int c_int; long long
    c_longlong; float c_float)."""
    with open(os.path.join(CSRC, src + '.cu')) as f:
        text = f.read()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        decl = []
        for p in params.split(','):
            pname = re.search(r'(\w+)\s*$', p).group(1)
            if '*' in p:
                kind = ctypes.c_void_p
            elif 'long long' in p:
                kind = ctypes.c_longlong
            elif 'float' in p:
                kind = ctypes.c_float
            else:
                assert re.fullmatch(r'\s*int \w+\s*', p), p
                kind = ctypes.c_int
            decl.append((kind, pname, '*' in p and 'const' not in p))
        out[name] = decl
    return out


def _table_kind(t):
    """A table type's C kind: an int array (an info entry's buffer) is a
    pointer."""
    if isinstance(t, type) and issubclass(t, ctypes.Array):
        assert t._type_ is ctypes.c_int
        return ctypes.c_void_p
    return t


def test_every_source_has_one_table_entry():
    assert sorted(binding.LIBS) == SOURCES


@pytest.mark.parametrize('src', SOURCES)
def test_table_declares_every_entry_point(src):
    """The table's entry points are the source's, each with the argument
    types of its C declaration (an info entry's last an int array)."""
    decl = _entry_points(src)
    table = binding.LIBS[src]
    assert set(table) == set(decl)
    for entry, types_ in table.items():
        assert [_table_kind(t) for t in types_] == [k for k, _, _ in
                                                    decl[entry]]
        if entry.endswith('_info'):
            assert issubclass(types_[-1], ctypes.Array)


def test_build_takes_one_flag_list(monkeypatch):
    """Every library is built with NVCC_FLAGS, the shared CUDA runtime
    among them, and nothing else."""
    seen = []
    monkeypatch.setattr(binding.device, 'build_shared',
                        lambda src, name, cmd, **k: seen.append(cmd))
    for src in SOURCES:
        binding.build(src)
    assert seen == [[binding.nvcc_path()] + binding.NVCC_FLAGS] * len(SOURCES)
    assert '-cudart shared' in ' '.join(binding.NVCC_FLAGS)


def test_every_wrapper_launches_through_an_operator():
    """Each wrapper's counter has an operator, and every operator that the
    wrappers' sources name is one of them."""
    assert {c for _, c, _ in binding.OPS.values()} == set(WRAPPERS)
    named = set()
    for mod in (tc, tp, sa, sm, pcg):
        with open(mod.__file__) as f:
            named |= set(re.findall(r'pathtracer_tpu_torch\.(\w+_launch)',
                                    f.read()))
    assert named and named <= set(binding.OPS)


@pytest.mark.parametrize('name', sorted(binding.OPS))
def test_operator_is_defined(name):
    entry, counter, _ = binding.OPS[name]
    assert hasattr(torch.ops.pathtracer_tpu_torch, name)
    assert entry in binding._LIB_OF and counter in WRAPPERS


_KIND = {ctypes.c_void_p: ('Tensor', 'Optional[Tensor]'),
         ctypes.c_int: ('int',), ctypes.c_longlong: ('int',),
         ctypes.c_float: ('float',)}


@pytest.mark.parametrize('name', sorted(binding.OPS))
def test_operator_takes_its_entry_points_arguments(name):
    """An operator's arguments are its entry point's C parameters but the
    stream, by name and in order: a pointer a Tensor (mutable where the C
    pointer is not const), an int or long long an int, a float a float."""
    entry = binding.OPS[name][0]
    decl = _entry_points(binding._LIB_OF[entry])[entry]
    assert decl[-1][1] == 'stream'
    schema = getattr(torch.ops.pathtracer_tpu_torch, name).default._schema
    args = schema.arguments
    assert [a.name for a in args] == [n for _, n, _ in decl[:-1]]
    for a, (kind, pname, written) in zip(args, decl):
        assert str(a.type) in _KIND[kind], pname
        assert (a.alias_info is not None and a.alias_info.is_write) == \
            written, pname
    assert not schema.returns


def _schema_args(name):
    """Stand-in arguments of operator `name` from its schema: a CPU tensor
    of its own for each tensor, None for each optional one, distinct ints
    and floats."""
    schema = getattr(torch.ops.pathtracer_tpu_torch, name).default._schema
    out = []
    for k, a in enumerate(schema.arguments):
        t = str(a.type)
        if t == 'Optional[Tensor]':
            out.append(None)
        elif t == 'Tensor':
            out.append(torch.zeros((4, 6), dtype=torch.float32) + k)
        elif t == 'int':
            out.append(k + 2)
        else:
            assert t == 'float', t
            out.append(k + 0.5)
    return out


class _Library:
    """A stand-in for a loaded library: each entry point records its C
    arguments and returns `rc`."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return self.rc
        return call


@pytest.mark.parametrize('name', sorted(binding.OPS))
def test_operator_kernel_passes_declared_arguments(name, monkeypatch):
    """An operator's CUDA kernel calls its entry point with its arguments
    in order (a tensor's pointer, a null pointer for None, ints and floats
    as they are) and the stream last, counts one launch on success, and
    on an error code raises with the entry point's name and counts
    nothing.  The recorder's counters are a fresh dict here, so that the
    stand-in launches count nowhere else."""
    entry, counter, launch = binding.OPS[name]
    stub = _Library(0)
    monkeypatch.setattr(binding, 'lib', lambda lib_name: stub)
    monkeypatch.setattr(profiling, '_counters', {})
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    args = _schema_args(name)
    ptrs = [a.data_ptr() for a in args if isinstance(a, torch.Tensor)]
    assert len(set(ptrs)) == len(ptrs)
    want = tuple(a.data_ptr() if isinstance(a, torch.Tensor)
                 else 0 if a is None else a for a in args) + (7,)
    key = f'{counter}.launches'
    launch(*args)
    assert profiling.counters() == {key: 1}
    assert stub.calls == [(entry, want)]
    assert len(want) == len(binding.LIBS[binding._LIB_OF[entry]][entry])
    stub.rc = 700
    with pytest.raises(RuntimeError, match=f'{entry} launch failed'):
        launch(*args)
    assert profiling.counters() == {key: 1}


def _cpu_calls():
    """One CPU call of each wrapper, by the wrapper's counter name."""
    md = procgen.sphere_mesh(12, 12, radius=3.0)
    tris = md.vertices[md.vtx_idx]
    cm = tc.build_clustered(tris, tris_c=tc.SUBT, dev='cpu')
    g = torch.Generator().manual_seed(0)
    n = tc.BLOCK
    org = torch.tensor([0.0, 0.0, 10.0]).expand(n, 3).contiguous()
    dirn = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g) * 0.1 + torch.tensor([0, 0, -1.0]),
        dim=1)
    tmax = torch.full((n,), 1e30)
    tmin = torch.full((n,), -1.0)
    ids, counts, keys = tc.cull_tree(cm, org, dirn, tmax)
    x = torch.rand((64, sm.AR), generator=g)
    w = torch.rand((sm.AR, 128), generator=g)
    m = 16
    hi = torch.as_tensor(np.arange(8, dtype=np.int64))
    fb = bvh_mod.build_bvh(tris)
    packed = tp.pack_bvh(fb, device='cpu')
    soup = tt.make_soup(tris[fb.order], device='cpu')
    return {
        'cluster_sweep': lambda: tc.cluster_sweep(cm, ids, counts, keys, org,
                                                  dirn, tmax, tmin),
        'cluster_sweep_any': lambda: tc.cluster_sweep_any(
            cm, ids, counts, keys, org, dirn, tmax, tmin),
        'cull_tree': lambda: tc.cull_tree(cm, org, dirn, tmax),
        'hier_cull': lambda: tc.hier_cull(cm.bounds, org, dirn, tmax),
        'packet_hit': lambda: tp.packet_hit(packed, soup, org, dirn, tmax,
                                            tmin),
        'dot_fp32': lambda: sm.dot_fp32(x, w, 2, 1e-3, 64),
        'dot_tf32': lambda: sm.dot_tf32(x, w, 2, 1e-3, 64),
        'epilogue': lambda: sm.epilogue(
            torch.rand((m, 6 * sm.SUBT), generator=g),
            -torch.rand((1, m), generator=g), 2, 1e-3),
        'edgemat': lambda: sm.edgemat(
            torch.rand((3, m), generator=g), torch.rand((3, m), generator=g),
            torch.rand((12, sm.SUBT), generator=g), 2, 1e-3),
        'sweep_ablate': lambda: sa.sweep_ablate(cm, ids, counts, org, dirn,
                                                tmax, tmin, 'full'),
        'pcg_draw': lambda: rng.next_uniform2(rng.make_stream(hi, hi)),
    }


@pytest.fixture(scope='module')
def cpu_calls():
    return _cpu_calls()


@pytest.mark.parametrize('wrapper', WRAPPERS)
def test_cpu_route_counts_no_launch(cpu_calls, wrapper, monkeypatch):
    """A CPU call of each wrapper takes its plain version: no launch is
    counted (on a fresh counter dict) and no library is loaded."""
    monkeypatch.setattr(profiling, '_counters', {})
    loaded = dict(binding._libs)
    cpu_calls[wrapper]()
    assert not [k for k in profiling.counters() if k.endswith('.launches')]
    assert binding._libs == loaded
