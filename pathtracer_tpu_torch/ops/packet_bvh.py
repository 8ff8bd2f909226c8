"""Packet-BVH tier: closest hit over one flat BVH for small meshes
(counterpart of pathtracer_tpu/ops/pallas_bvh.py).

The TPU kernel walks 1024-ray packets with one SMEM stack, because Mosaic
indexes dynamically only from scalar memory.  Its port
(csrc/packet_bvh.cu) gives every ray its own thread and its own depth-64
stack: left child first, descend where the ray's own slab is live and
enters before its best t, leaves test their triangles with the
edge-matrix formula of traverse._tri_test_block (accept t >= 0,
t > tmin, barycentrics >= 0, strict t < best so that ties keep the first
found, which in BVH order is the lower index).

`packet_hit_plain` is the same function computed directly: brute force
over the BVH-ordered soup (traverse.brute_force_hit with t_max and
t_min).  A ray that grazes a leaf box can differ from the walk by a
rounding of the slab test.  CPU tensors take the plain version; CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from .traverse import TriSoup, brute_force_hit

BIG_T = float(np.float32(1e30))
STACK_DEPTH = 64       # per-ray traversal stack of the kernel
PLAIN_RAY_CHUNK = 16384  # rays per brute-force block of the plain version


class PackedBVH(NamedTuple):
    """Kernel-ready node arrays (leaf: na = first tri, nb = tri count)."""

    box: torch.Tensor      # (M, 6) f32 [lo xyz | hi xyz]
    na: torch.Tensor       # (M,) int32: left child / leaf tri start
    nb: torch.Tensor       # (M,) int32: right child / leaf tri count
    nleaf: torch.Tensor    # (M,) int32 (1 = leaf)
    max_leaf: int


def pack_bvh(fb, device=None) -> PackedBVH:
    """Pack a FlatBVH for the packet kernel (pallas_bvh.pack_bvh) on
    `device` (None: the card); refuses trees as deep as the kernel's
    stack."""
    if fb.depth >= STACK_DEPTH:
        raise ValueError(
            f'BVH depth {fb.depth} >= kernel stack depth {STACK_DEPTH}: the '
            f'traversal stack would overflow; rebuild with a larger leaf '
            f'size')
    dev = device_mod.resolve(device)
    nb = np.where(fb.node_leaf, fb.node_b - fb.node_a, fb.node_b)

    def i32(x):
        return torch.as_tensor(np.array(x, np.int32), device=dev)

    box = np.concatenate([fb.node_lo, fb.node_hi], axis=1)
    return PackedBVH(box=torch.as_tensor(np.array(box, np.float32,
                                                  order='C'), device=dev),
                     na=i32(fb.node_a), nb=i32(nb),
                     nleaf=i32(fb.node_leaf.astype(np.int32)),
                     max_leaf=int(fb.max_leaf))


def packet_hit_plain(soup: TriSoup, org, dirn, tmax, tmin=None):
    """Closest hit by brute force over the BVH-ordered soup: (t — tmax
    where nothing beat it —, tri int32 or -1, alpha, beta), ties to the
    lower index.  Blocks of PLAIN_RAY_CHUNK rays bound the (rays, tris)
    temporaries at any ray count."""
    outs = []
    for r0 in range(0, org.shape[0], PLAIN_RAY_CHUNK):
        sl = slice(r0, r0 + PLAIN_RAY_CHUNK)
        h = brute_force_hit(soup, org[sl], dirn[sl], t_max=tmax[sl],
                            t_min=None if tmin is None else tmin[sl])
        outs.append((h.t, h.tri, h.alpha, h.beta))
    if not outs:
        e = tmax[:0]
        return e, e.to(torch.int32), e, e
    return tuple(torch.cat(x) for x in zip(*outs))


_lib_handle = None


def load_kernels(log=None) -> ctypes.CDLL:
    """Build csrc/packet_bvh.cu for sm_90a (once) and load it."""
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(device_mod.build_cuda('packet_bvh', log=log))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.packet_bvh_hit.argtypes = [ptr] * 4 + [ptr] + [ptr] * 4 \
            + [i32] + [ptr] * 5 + [ptr]
        lib.packet_bvh_hit.restype = i32
        _lib_handle = lib
    return _lib_handle


def _soup_table(soup: TriSoup) -> torch.Tensor:
    """(T, 16) per-triangle rows in TriSoup field order, one 64-byte row
    per triangle for the kernel."""
    return torch.stack(list(soup), dim=1).contiguous()


def packet_hit(packed: PackedBVH, soup: TriSoup, org, dirn, tmax, tmin=None,
               work=None):
    """Closest hit for N rays: (t, tri, alpha, beta).  CPU tensors take
    packet_hit_plain; CUDA tensors launch the hand-written kernel
    (replaces the TPU kernel pallas_bvh._traverse_kernel) or raise.
    `work` (N, 2) int32, optional: the kernel writes each ray's count of
    inner nodes expanded (two slab tests each) and of triangle tests there
    (for the roofline bound)."""
    if org.device.type == 'cpu':
        return packet_hit_plain(soup, org, dirn, tmax, tmin)
    dev = org.device
    n = org.shape[0]
    if dev.type != 'cuda':
        raise ValueError(f'packet_hit takes CUDA or CPU tensors, got {dev}')
    if tmin is None:
        tmin = torch.full((n,), -1.0, device=dev)
    table = _soup_table(soup)
    f32, i32 = torch.float32, torch.int32
    checks = ((packed.box, f32, (packed.box.shape[0], 6)),
              (packed.na, i32, None), (packed.nb, i32, None),
              (packed.nleaf, i32, None), (table, f32, None),
              (org, f32, (n, 3)), (dirn, f32, (n, 3)), (tmax, f32, (n,)),
              (tmin, f32, (n,)))
    for x, dt, shape in checks:
        if x.device != dev or x.dtype != dt or not x.is_contiguous() \
                or (shape is not None and tuple(x.shape) != shape):
            raise ValueError('packet_hit inputs must be contiguous tensors '
                             'of the kernel types on one device')
    if work is not None and (work.device != dev or work.dtype != i32
                             or tuple(work.shape) != (n, 2)):
        raise ValueError('packet_hit work must be an (N, 2) int32 tensor')
    t = torch.empty_like(tmax)
    tri = torch.empty((n,), dtype=i32, device=dev)
    al = torch.empty_like(tmax)
    be = torch.empty_like(tmax)
    if n == 0:
        return t, tri, al, be
    rc = load_kernels().packet_bvh_hit(
        packed.box.data_ptr(), packed.na.data_ptr(), packed.nb.data_ptr(),
        packed.nleaf.data_ptr(), table.data_ptr(), org.data_ptr(),
        dirn.data_ptr(), tmax.data_ptr(), tmin.data_ptr(), n, t.data_ptr(),
        tri.data_ptr(), al.data_ptr(), be.data_ptr(),
        0 if work is None else work.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'packet_bvh_hit launch failed: CUDA error {rc}')
    packet_hit.launches += 1
    return t, tri, al, be


packet_hit.launches = 0


def packet_hit_packed(packed: PackedBVH, soup: TriSoup, org, dirn, tmax,
                      tmin=None):
    """pallas_bvh.packet_hit_packed's signature: the same as packet_hit."""
    return packet_hit(packed, soup, org, dirn, tmax, tmin=tmin)
