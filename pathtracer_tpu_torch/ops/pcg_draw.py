"""The PCG32 draws' kernel binding: csrc/pcg_draw.cu on CUDA tensors.

core/rng.py routes its draws here on a CUDA tensor, after checking their
arguments; CPU tensors take its plain versions and never reach this
module.  `pcg_seed` (make_stream) and `pcg_draw` (next_uniform,
next_uniform2) allocate their outputs with ``torch.empty`` and make one
launch each, through the torch operators
``pathtracer_tpu_torch::pcg_seed_launch`` and ``pcg_draw_launch``, so
that the profiler records each launch inside its operator and links it
to the spans around it.  Every launch of the kernel file, seed or draw,
is counted on the one counter ``pcg_draw.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import device

_libs = {}


def load_kernel(log=None) -> ctypes.CDLL:
    """Build csrc/pcg_draw.cu for sm_90a (once) and load it.  It links the
    shared CUDA runtime, the one torch loads, so that the profiler records
    each launch inside its operator."""
    if 'pcg' not in _libs:
        lib = ctypes.CDLL(device.build_cuda('pcg_draw', log=log,
                                            extra=('-cudart', 'shared')))
        ptr, n = ctypes.c_void_p, ctypes.c_longlong
        lib.pcg_seed.argtypes = [ptr] * 6 + [n, ptr]
        lib.pcg_seed.restype = ctypes.c_int
        lib.pcg_draw.argtypes = [ptr] * 9 + [n, ptr]
        lib.pcg_draw.restype = ctypes.c_int
        _libs['pcg'] = lib
    return _libs['pcg']


def _halves(like, n):
    return tuple(torch.empty(like.shape, dtype=torch.int64,
                             device=like.device) for _ in range(n))


def pcg_seed(key_hi, key_lo):
    """make_stream's state tuple (s_hi, s_lo, inc_hi, inc_lo) of checked
    CUDA keys, in one launch."""
    out = _halves(key_hi, 4)
    if key_hi.numel():
        torch.ops.pathtracer_tpu_torch.pcg_seed_launch(key_hi, key_lo, *out)
        pcg_draw.launches += 1
    return out


def pcg_draw(state, gate, k):
    """k (1 or 2) draws of every lane of a checked CUDA state in one
    launch: (u1, u2 or None, new state).  The new state shares the
    increment halves with `state`."""
    s_hi, s_lo, inc_hi, inc_lo = state
    n_hi, n_lo = _halves(s_hi, 2)
    u1 = torch.empty(s_hi.shape, dtype=torch.float32, device=s_hi.device)
    u2 = torch.empty_like(u1) if k == 2 else None
    if s_hi.numel():
        torch.ops.pathtracer_tpu_torch.pcg_draw_launch(
            s_hi, s_lo, inc_hi, inc_lo, gate, n_hi, n_lo, u1, u2)
        pcg_draw.launches += 1
    return u1, u2, (n_hi, n_lo, inc_hi, inc_lo)


pcg_draw.launches = 0


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _seed_launch(key_hi, key_lo, s_hi, s_lo, inc_hi, inc_lo):
    """pcg_seed's launch, the CUDA kernel of the operator
    `pathtracer_tpu_torch::pcg_seed_launch`: the profiler links a kernel
    to the operator that launched it, and through it to the spans around
    it; a bare ctypes call belongs to no operator."""
    rc = load_kernel().pcg_seed(
        key_hi.data_ptr(), key_lo.data_ptr(), s_hi.data_ptr(),
        s_lo.data_ptr(), inc_hi.data_ptr(), inc_lo.data_ptr(),
        key_hi.numel(), _stream(key_hi))
    if rc != 0:
        raise RuntimeError(f'pcg_seed launch failed: CUDA error {rc}')


def _draw_launch(s_hi, s_lo, inc_hi, inc_lo, gate, n_hi, n_lo, u1, u2):
    """pcg_draw's launch, the CUDA kernel of the operator
    `pathtracer_tpu_torch::pcg_draw_launch`, as _seed_launch."""
    rc = load_kernel().pcg_draw(
        s_hi.data_ptr(), s_lo.data_ptr(), inc_hi.data_ptr(),
        inc_lo.data_ptr(), 0 if gate is None else gate.data_ptr(),
        n_hi.data_ptr(), n_lo.data_ptr(), u1.data_ptr(),
        0 if u2 is None else u2.data_ptr(), s_hi.numel(), _stream(s_hi))
    if rc != 0:
        raise RuntimeError(f'pcg_draw launch failed: CUDA error {rc}')


# the operators, in a fragment of the namespace that ops/cluster.py
# defines (torch.library.custom_op would import the compiler stack at its
# first call, seconds of set-up)
_OPS = torch.library.Library('pathtracer_tpu_torch', 'FRAGMENT')
_OPS.define('pcg_seed_launch(Tensor key_hi, Tensor key_lo, Tensor(a!) s_hi, '
            'Tensor(b!) s_lo, Tensor(c!) inc_hi, Tensor(d!) inc_lo) -> ()')
_OPS.impl('pcg_seed_launch', _seed_launch, 'CUDA')
_OPS.define('pcg_draw_launch(Tensor s_hi, Tensor s_lo, Tensor inc_hi, '
            'Tensor inc_lo, Tensor? gate, Tensor(a!) n_hi, Tensor(b!) n_lo, '
            'Tensor(c!) u1, Tensor(d!)? u2) -> ()')
_OPS.impl('pcg_draw_launch', _draw_launch, 'CUDA')
