"""The one binding of the port's hand-written CUDA kernels (csrc/*.cu):
how each library is built, loaded, launched and counted.

Build: `build(name)` compiles csrc/<name>.cu with nvcc for sm_90a into
``_build/lib<name>.so`` (device.build_shared: once, kept while newer than
the source and every csrc/*.cuh header), every library with the one flag
list NVCC_FLAGS.

Load: LIBS declares each library's C entry points (the ``extern "C"``
functions of its source, each returning a CUDA error code) with their
ctypes argument types.  `lib(name)` builds, loads and declares a library
once.  `info(entry, *args)` reads the ints that a ``*_info`` entry point
writes into its last argument, an int array of the length LIBS declares
(registers per thread, resident blocks per SM, ...), as a tuple, once per
arguments.

Launch: every launch on the card goes through a torch operator
``pathtracer_tpu_torch::<name>`` (OPS), defined on the one Library below
with its CUDA kernel as its only implementation, so that the profiler
links the kernel to the operator and through it to the spans around it.
An operator's arguments are its entry point's, by name and in order,
but the stream (a pointer a Tensor, written ones mutable, a null one
None; an int or long long an int; a float a float).  Its kernel passes
them on (a tensor its pointer) with the current stream of the first
argument's device, raises with the entry point's name on an error code,
and counts the launch on the recorder's counter ``<counter>.launches``
(utils/profiling.count).  The wrappers in this package check their
arguments, allocate the outputs and call the operator; CPU tensors take
their plain versions and never reach it.

Nothing is built or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil

import torch

from .. import device
from ..utils import profiling

# sm_90a (Hopper); contraction into FMAs is off, so a kernel rounds every
# product and sum on its own as the plain PyTorch versions do; the shared
# CUDA runtime is the one torch loads, so the profiler records each launch
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
              '-cudart', 'shared']

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# library -> {C entry point: argument types}; a launch's last argument is
# the stream, an info entry's last the int array it fills
LIBS = {
    'cluster_sweep': {
        'cluster_sweep_closest': [P] * 7 + [I] + [P] * 8 + [I, I, P],
        'cluster_sweep_any': [P] * 7 + [I] + [P] * 7 + [I, I, P],
        'cluster_sweep_info': [I, I, I * 3]},
    'cluster_cull': {
        'cluster_cull_tree': [P, I, P, I] + [P] * 4 + [I] + [P] * 5,
        'cluster_cull_info': [I, I * 4]},
    'cluster_hier_cull': {
        'cluster_hier_cull': [P, I, P, I, P, L] + [P] * 3 + [I, I] + [P] * 6,
        'cluster_hier_cull_info': [I, I, I, I * 4]},
    'packet_bvh': {
        'packet_bvh_hit': [P, I, I] + [P] * 5 + [I] + [P] * 7,
        'packet_bvh_info': [I, I * 4]},
    'sweep_micro': {
        'sweep_dot': [P, P, I, I, I, F, I, I, P, P, P],
        'sweep_epilogue': [P, P, I, I, F, P, P],
        'sweep_edgemat': [P, P, P, I, I, I, F, P, P, P],
        'sweep_micro_info': [I, I * 3]},
    'sweep_ablate': {
        'sweep_ablate': [P] * 5 + [I] + [P] * 10 + [I, I, I, P],
        'sweep_ablate_info': [I, I, I * 3]},
    'pcg_draw': {
        'pcg_seed': [P] * 6 + [L, P],
        'pcg_draw': [P] * 9 + [L, P]},
}
_LIB_OF = {e: name for name, entries in LIBS.items() for e in entries}
_libs = {}
_info = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if home and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
        return os.path.join(home, 'bin', 'nvcc')
    return shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'


def build(name: str, log=None) -> str:
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>.so`` with
    NVCC_FLAGS (once).  `log` receives the compiler's output (the ptxas
    register and shared-memory report).  Returns the library path."""
    csrc = os.path.join(device.PKG_DIR, 'csrc')
    return device.build_shared(
        os.path.join(csrc, name + '.cu'), f'lib{name}.so',
        [nvcc_path()] + NVCC_FLAGS, log=log,
        deps=sorted(glob.glob(os.path.join(csrc, '*.cuh'))))


def lib(name: str, log=None) -> ctypes.CDLL:
    """Library `name` of LIBS, built and loaded once, its entry points
    declared."""
    if name not in _libs:
        handle = ctypes.CDLL(build(name, log=log))
        for entry, argtypes in LIBS[name].items():
            fn = getattr(handle, entry)
            fn.argtypes, fn.restype = argtypes, I
        _libs[name] = handle
    return _libs[name]


def info(entry: str, *args) -> tuple:
    """The ints that the info entry point `entry` writes for `args`, from
    the CUDA runtime (read once per arguments)."""
    key = (entry, args)
    if key not in _info:
        name = _LIB_OF[entry]
        buf = LIBS[name][entry][-1]()
        rc = getattr(lib(name), entry)(*args, buf)
        if rc != 0:
            raise RuntimeError(f'{entry} failed: CUDA error {rc}')
        _info[key] = tuple(buf)
    return _info[key]


# the operators, defined once per process (torch.library.custom_op would
# import the compiler stack at its first call, seconds of set-up)
_OPS = torch.library.Library('pathtracer_tpu_torch', 'DEF')
OPS = {}    # operator -> (C entry point, counter, its CUDA kernel)


def _c(x):
    """A C argument: a tensor's pointer, a null pointer for None."""
    if isinstance(x, torch.Tensor):
        return x.data_ptr()
    return 0 if x is None else x


def _op(schema: str, entry: str, counter: str):
    """Define the operator of `schema` (the arguments of `entry` but the
    stream): its CUDA kernel calls `entry` on them and the stream, and
    counts the launch."""
    name = schema.split('(', 1)[0]
    library, key = _LIB_OF[entry], f'{counter}.launches'

    def launch(*args):
        rc = getattr(lib(library), entry)(
            *map(_c, args),
            torch.cuda.current_stream(args[0].device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f'{entry} launch failed: CUDA error {rc}')
        profiling.count(key)

    _OPS.define(schema + ' -> ()')
    _OPS.impl(name, launch, 'CUDA')
    OPS[name] = (entry, counter, launch)


_SWEEP = ('Tensor ids, Tensor counts, Tensor keys, Tensor planes, '
          'Tensor ctab, Tensor starts, Tensor sub_bounds, int n_sub, '
          'Tensor org, Tensor dir, Tensor tmax, Tensor tmin, Tensor order')
_op(f'cluster_sweep_launch({_SWEEP}, Tensor(a!) t_out, Tensor(b!) tri_out, '
    f'Tensor(c!)? stats, int n_units, int group)', 'cluster_sweep_closest',
    'cluster_sweep')
_op(f'cluster_sweep_any_launch({_SWEEP}, Tensor(a!) occ_out, '
    f'Tensor(b!)? stats, int n_units, int group)', 'cluster_sweep_any',
    'cluster_sweep_any')
_op('cull_tree_launch(Tensor pairs, int depth, Tensor root, int root_cnt, '
    'Tensor order, Tensor org, Tensor dir, Tensor tmax, int n_packets, '
    'Tensor(a!) ids_out, Tensor(b!) count_out, Tensor(c!) keys_out, '
    'Tensor(d!)? work)', 'cluster_cull_tree', 'cull_tree')
_op('hier_cull_launch(Tensor bounds, int bstride, Tensor? nrm, int nstride, '
    'Tensor? excl, int estride, Tensor org, Tensor dir, Tensor tmax, '
    'int n_packets, int c, Tensor(a!) ids, Tensor(b!) count, '
    'Tensor(c!) keys, Tensor(d!) swept, Tensor(e!)? work)',
    'cluster_hier_cull', 'hier_cull')
_op('packet_hit_launch(Tensor pairs, int root_cnt, int depth, Tensor soup, '
    'Tensor org, Tensor dir, Tensor tmax, Tensor tmin, int n, '
    'Tensor(a!) next_ray, Tensor(b!) t_out, Tensor(c!) tri_out, '
    'Tensor(d!) al_out, Tensor(e!) be_out, Tensor(f!)? work)',
    'packet_bvh_hit', 'packet_hit')
_DOT = ('(Tensor x, Tensor w, int m, int n, int reps, float eps, '
        'int out_cols, int tile, Tensor(a!) out, Tensor(b!) pairs)')
_op('dot_fp32_launch' + _DOT, 'sweep_dot', 'dot_fp32')
_op('dot_tf32_launch' + _DOT, 'sweep_dot', 'dot_tf32')
_op('epilogue_launch(Tensor p, Tensor tn, int m, int reps, float eps, '
    'Tensor(a!) out)', 'sweep_epilogue', 'epilogue')
_op('edgemat_launch(Tensor o, Tensor d, Tensor tr, int m, int reps, '
    'int splits, float eps, Tensor(a!) partial, Tensor(b!) out)',
    'sweep_edgemat', 'edgemat')
_op('sweep_ablate_launch(Tensor ids, Tensor counts, Tensor planes, '
    'Tensor ctab, Tensor starts, int n_sub, Tensor org, Tensor dir, '
    'Tensor tmax, Tensor tmin, Tensor order, Tensor(a!) t_out, '
    'Tensor(b!) tri_out, Tensor(c!) be_out, Tensor(d!) ga_out, '
    'Tensor(e!)? stats, int n_units, int group, int variant)',
    'sweep_ablate', 'sweep_ablate')
_op('pcg_seed_launch(Tensor key_hi, Tensor key_lo, Tensor(a!) s_hi, '
    'Tensor(b!) s_lo, Tensor(c!) inc_hi, Tensor(d!) inc_lo, int n)',
    'pcg_seed', 'pcg_draw')
_op('pcg_draw_launch(Tensor s_hi, Tensor s_lo, Tensor inc_hi, '
    'Tensor inc_lo, Tensor? gate, Tensor(a!) o_hi, Tensor(b!) o_lo, '
    'Tensor(c!) u1, Tensor(d!)? u2, int n)', 'pcg_draw', 'pcg_draw')
