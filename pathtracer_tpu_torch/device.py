"""Precision rules and the native build directory of the PyTorch port.

Precision: every float32 product in the port runs in full float32.  A
Hopper card would otherwise route float32 matmuls and convolutions through
TF32 (about three decimal digits), which flips barycentric edge tests the
same way the TPU's bf16 matmul passes did (ops/cluster.py).  The flags are
process-wide torch settings, so importing the package sets them once.

Build directory: native code (the g++ BVH builder, the nvcc cluster-sweep
library) is compiled at first use into ``pathtracer_tpu_torch/_build``,
which git ignores.  Nothing is built when a module is imported.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, '_build')


def build_dir() -> str:
    """The port's build directory, created on demand."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR


def build_shared(src: str, name: str, cmd_prefix: list, timeout: float = 600,
                 log=None) -> str:
    """Compile `src` into ``_build/<name>`` unless an up-to-date copy exists.

    cmd_prefix is the compiler command without the output and source
    arguments.  The library is written to a temporary name and renamed,
    so a concurrent process never loads a half-written file.  Raises
    CalledProcessError (with the compiler's output) when the build fails.
    Returns the library path."""
    out = os.path.join(build_dir(), name)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    tmp = f'{out}.{os.getpid()}.tmp'
    proc = subprocess.run(cmd_prefix + ['-o', tmp, src], check=True,
                          capture_output=True, text=True, timeout=timeout)
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
