"""Default device, precision rules and the native build directory of the
PyTorch port.

Default device: every entry point that allocates (``build_scene``,
``upload_mesh``, ``build_clustered``, ``make_soup``, ``make_film``, ...)
builds on the CUDA card unless the caller names another device.  There
is no fallback: without a card the first CUDA allocation fails.  CPU runs
(the parity tests) pass ``device='cpu'``.

Precision: every float32 product in the port runs in full float32.  A
Hopper card would otherwise route float32 matmuls and convolutions through
TF32 (about three decimal digits), which flips barycentric edge tests the
same way the TPU's bf16 matmul passes did (ops/cluster.py).  The flags are
process-wide torch settings, so importing the package sets them once.

Gradients: the hit queries' kernels have no backward pass, and their
wrappers (ops/cluster.py, ops/packet_bvh.py) refuse a ray that requires
grad on every device (`refuse_grad`), so the plain versions on the CPU
cannot differentiate what the card does not.

Build directory: native code (the g++ BVH builder, one nvcc library per
``csrc/*.cu`` source) is compiled at first use into
``pathtracer_tpu_torch/_build``, which git ignores.  Nothing is built when
a module is imported.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, '_build')

# sm_90a (Hopper); contraction into FMAs is off, so a kernel rounds every
# product and sum on its own as the plain PyTorch versions do
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']


def default_device() -> torch.device:
    """The device of every entry point called without one: the CUDA card.
    It does not check that a card is present and never falls back."""
    return torch.device('cuda')


def resolve(dev) -> torch.device:
    """`dev` as a torch.device; None means default_device()."""
    return default_device() if dev is None else torch.device(dev)


def refuse_grad(query: str, *rays):
    """Raise if any of `rays` (a hit query's ray tensors) requires grad:
    the query's hits are constants of the estimator, so the gradient must
    have been cut upstream, as the integrator detaches its sampled
    direction."""
    if any(isinstance(x, torch.Tensor) and x.requires_grad for x in rays):
        raise ValueError(
            f'{query}: a ray input requires grad, but hit queries carry no '
            f'gradient (their kernels have no backward); detach the ray '
            f'upstream, as render/integrator.py detaches its sampled '
            f'direction')


def build_dir() -> str:
    """The port's build directory, created on demand."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR


def build_shared(src: str, name: str, cmd_prefix: list, timeout: float = 600,
                 log=None, deps=()) -> str:
    """Compile `src` into ``_build/<name>`` unless an up-to-date copy exists
    (one newer than `src` and every header in `deps`).

    cmd_prefix is the compiler command without the output and source
    arguments.  The library is written to a temporary name and renamed,
    so a concurrent process never loads a half-written file.  Raises
    RuntimeError with the compiler's output when the build fails.
    Returns the library path."""
    out = os.path.join(build_dir(), name)
    newest = max(os.path.getmtime(f) for f in (src, *deps))
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out
    tmp = f'{out}.{os.getpid()}.tmp'
    proc = subprocess.run(cmd_prefix + ['-o', tmp, src], capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f'building {os.path.basename(src)} failed:\n'
                           f'{proc.stdout}{proc.stderr}')
    if log is not None and (proc.stdout or proc.stderr):
        log(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if home and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
        return os.path.join(home, 'bin', 'nvcc')
    return shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'


def build_cuda(name: str, log=None) -> str:
    """Compile ``csrc/<name>.cu`` with nvcc for sm_90a into
    ``_build/lib<name>.so`` (once; kept while newer than the source and
    every ``csrc/*.cuh`` header).  `log` receives the compiler's output
    (the ptxas register and shared-memory report).  Returns the library
    path."""
    csrc = os.path.join(PKG_DIR, 'csrc')
    return build_shared(os.path.join(csrc, name + '.cu'), f'lib{name}.so',
                        [nvcc_path()] + NVCC_FLAGS, log=log,
                        deps=sorted(glob.glob(os.path.join(csrc, '*.cuh'))))
