"""Packet-BVH tier: closest hit over one flat BVH for small meshes
(counterpart of pathtracer_tpu/ops/pallas_bvh.py).

The TPU kernel walks 1024-ray packets with one SMEM stack, because Mosaic
indexes dynamically only from scalar memory.  Its port
(csrc/packet_bvh.cu) gives every ray its own thread and its own stack:
left child first, descend where the ray's own slab is live and enters
before its best t, leaves test their triangles with the edge-matrix
formula of traverse._tri_test_block (accept t >= 0, t > tmin,
barycentrics >= 0, strict t < best so that ties keep the first found,
which in BVH order is the lower index).

The slab test is conservative (`_slab_live`): an axis where the ray lies
in the plane of a face holds the whole ray, and the exit grows by
SLAB_GROW, so a ray grazing a leaf box still tests its triangles.

`packet_hit_plain` is the same function computed directly: brute force
over the BVH-ordered soup (traverse.brute_force_hit with t_max and
t_min).  It can still differ from the walk on a tie, or where the
triangle test's rounding accepts a point just outside a leaf box.  CPU
tensors take the plain version; CUDA tensors launch the kernel or raise.

`packet_walk_plain` is the kernel's own walk, ray by ray, in lockstep
torch over rays: the exact reference the kernel is held to bit for bit
(hits and per-ray counters), where brute force must allow for ties.
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
# 1 + 2 gamma_3 rounded to float32 (1 + 3 * 2^-23): the growth of a slab's
# exit that covers the rounding of its products (Ize 2013)
SLAB_GROW = float(np.float32(1.0 + 3.0 * 2.0 ** -23))
PAIR_WORDS = 16        # 32-bit words per child-pair record (64 bytes)
WORK = 6               # per-ray kernel counters: inner nodes expanded,
                       # triangle tests; clock64 cycles from the warp's turn
                       # on its 32-ray batch to the ray's result and to its
                       # rays being loaded; inner-node steps and triangle
                       # tests the warp ran with this lane leading (kernel
                       # only)


class PackedBVH(NamedTuple):
    """Kernel-ready node arrays (leaf: na = first tri, nb = tri count)."""

    box: torch.Tensor      # (M, 6) f32 [lo xyz | hi xyz]
    na: torch.Tensor       # (M,) int32: left child / leaf tri start
    nb: torch.Tensor       # (M,) int32: right child / leaf tri count
    nleaf: torch.Tensor    # (M,) int32 (1 = leaf)
    max_leaf: int
    pairs: torch.Tensor = None   # (R, PAIR_WORDS) child-pair records
    depth: int = 0         # deepest node (root 0): bounds the walk's stack


def tree_depth(na, nb, nleaf) -> int:
    """Depth of the deepest node of a packed tree (root 0).  A walk that
    pushes one sibling per level never holds more nodes than that."""
    na, nb, leaf = np.asarray(na), np.asarray(nb), np.asarray(nleaf) != 0
    level, depth = np.zeros(1, np.int64), 0
    while True:
        inner = level[~leaf[level]]
        if inner.size == 0:
            return depth
        level = np.concatenate([na[inner], nb[inner]]).astype(np.int64)
        depth += 1


def pair_records(box, na, nb, nleaf) -> np.ndarray:
    """(R, PAIR_WORDS) float32 child-pair records, one 64-byte row per
    inner node (R = inner nodes, root first, in node order):

        words 0-5   left child's box  lo xyz | hi xyz
        words 6-11  right child's box lo xyz | hi xyz
        word 12, 13 (int32 bits) left / right child: its record when
                    inner, its first item (na) when a leaf
        word 14, 15 (int32 bits) left / right item count (nb) when a
                    leaf, 0 when inner

    so a walk reads one record per inner node, as four 16-byte loads."""
    box = np.asarray(box, np.float32)
    na, nb = np.asarray(na, np.int64), np.asarray(nb, np.int64)
    leaf = np.asarray(nleaf) != 0
    if (nb[leaf] < 1).any():
        raise ValueError('a leaf without items cannot be told from an '
                         'inner node in a child-pair record')
    inner = np.flatnonzero(~leaf)
    rank = np.full(leaf.shape[0], -1, np.int64)
    rank[inner] = np.arange(inner.size)
    rec = np.zeros((inner.size, PAIR_WORDS), np.float32)
    ints = rec.view(np.int32)
    for side, child in enumerate((na[inner], nb[inner])):
        rec[:, 6 * side:6 * side + 6] = box[child]
        ints[:, 12 + side] = np.where(leaf[child], na[child], rank[child])
        ints[:, 14 + side] = np.where(leaf[child], nb[child], 0)
    return rec


def packed_from_arrays(box, na, nb, nleaf, max_leaf, dev) -> PackedBVH:
    """A PackedBVH on `dev` from host node arrays (leaf nb = count)."""
    def i32(x):
        return torch.as_tensor(np.array(x, np.int32), device=dev)

    box = np.array(box, np.float32, order='C')
    return PackedBVH(box=torch.as_tensor(box, device=dev), na=i32(na),
                     nb=i32(nb), nleaf=i32(np.asarray(nleaf).astype(np.int32)),
                     max_leaf=int(max_leaf),
                     pairs=torch.as_tensor(pair_records(box, na, nb, nleaf),
                                           device=dev),
                     depth=tree_depth(na, nb, nleaf))


def pack_bvh(fb, device=None) -> PackedBVH:
    """Pack a FlatBVH for the packet kernel (pallas_bvh.pack_bvh) on
    `device` (None: the card); refuses trees as deep as the kernel's
    stack."""
    if fb.depth >= STACK_DEPTH:
        raise ValueError(
            f'BVH depth {fb.depth} >= kernel stack depth {STACK_DEPTH}: the '
            f'traversal stack would overflow; rebuild with a larger leaf '
            f'size')
    nb = np.where(fb.node_leaf, fb.node_b - fb.node_a, fb.node_b)
    box = np.concatenate([fb.node_lo, fb.node_hi], axis=1)
    return packed_from_arrays(box, fb.node_a, nb, fb.node_leaf, fb.max_leaf,
                              device_mod.resolve(device))


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


def _slab_live(bx, o, inv, best):
    """The kernel's slab_live for rows of boxes and rays, conservative: an
    axis whose direction component is zero with the origin on a face
    (0 * inf = NaN) holds the whole ray, and the exit grows by
    SLAB_GROW before it is compared, so a ray that grazes the box stays
    live.  Live: the exit at or past max(entry, 0) and the entry below
    the ray's best t."""
    tmin = tmx = None
    for k in range(3):
        t1 = (bx[:, k] - o[:, k]) * inv[:, k]
        t2 = (bx[:, k + 3] - o[:, k]) * inv[:, k]
        lo_, hi_ = torch.minimum(t1, t2), torch.maximum(t1, t2)
        flat = torch.isnan(lo_) & torch.isinf(inv[:, k])
        lo_ = torch.where(flat, -torch.inf, lo_)
        hi_ = torch.where(flat, torch.inf, hi_)
        tmin = lo_ if tmin is None else torch.maximum(tmin, lo_)
        tmx = hi_ if tmx is None else torch.minimum(tmx, hi_)
    return (tmx * SLAB_GROW >= torch.clamp_min(tmin, 0.0)) & (tmin < best)


def _tri_rows(soup: TriSoup, j, o, d):
    """The kernel's tri_test for ray i against triangle j[i]: (t, alpha,
    beta, accepted without the best-t and tmin bounds), in the order of
    traverse._tri_test_block."""
    ax, ay, az, ux, uy, uz, vx, vy, vz, nx, ny, nz, m11, m12, m22, inv = (
        x[j] for x in soup)
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    dn = dx * nx + dy * ny + dz * nz
    t = ((ax - ox) * nx + (ay - oy) * ny + (az - oz) * nz) / dn
    px = ox + t * dx - ax
    py = oy + t * dy - ay
    pz = oz + t * dz - az
    b11 = px * ux + py * uy + pz * uz
    b21 = px * vx + py * vy + pz * vz
    beta = (b11 * m22 - b21 * m12) * inv
    gamma = (b21 * m11 - b11 * m12) * inv
    alpha = 1.0 - beta - gamma
    ok = (t >= 0.0) & (beta >= 0.0) & (gamma >= 0.0) & (alpha >= 0.0) \
        & ~t.isnan()
    return t, alpha, beta, ok


def packet_walk_plain(packed: PackedBVH, soup: TriSoup, org, dirn, tmax,
                      tmin=None):
    """The packet kernel's walk, one per ray, stepped in lockstep over the
    rays still walking: the root entered untested; at an inner node both
    children's slabs against the ray's own best t, the left child entered
    first and the right one pushed (a stack of STACK_DEPTH); at a leaf its
    triangles in order, a hit kept on t < best and t > tmin.  Returns (t,
    tri, alpha, beta, work) with work (N, 2) int32: inner nodes expanded
    and triangle tests per ray, the kernel's first two counters."""
    n, dev = org.shape[0], org.device
    if tmin is None:
        tmin = torch.full((n,), -1.0, device=dev)
    box, leaf = packed.box, packed.nleaf != 0
    na, nb = packed.na.long(), packed.nb.long()
    inv = 1.0 / dirn
    best = tmax.clone()
    btri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bal, bbe = torch.ones_like(best), torch.zeros_like(best)
    work = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    live = torch.arange(n, device=dev)
    while live.numel():
        nd = node[live]
        at_leaf = leaf[nd]
        # leaves: their triangles in order; then the ray pops
        r, first, cnt = live[at_leaf], na[nd[at_leaf]], nb[nd[at_leaf]]
        for k in range(int(cnt.max()) if r.numel() else 0):
            m = k < cnt
            rr, j = r[m], first[m] + k
            t, al, be, ok = _tri_rows(soup, j, org[rr], dirn[rr])
            win = ok & (t < best[rr]) & (t > tmin[rr])
            w = rr[win]
            best[w], btri[w] = t[win], j[win].to(torch.int32)
            bal[w], bbe[w] = al[win], be[win]
            work[rr, 1] += 1
        # inner nodes: left first where live, right pushed or entered
        q, qn = live[~at_leaf], nd[~at_leaf]
        work[q, 0] += 1
        a, b = na[qn], nb[qn]
        la = _slab_live(box[a], org[q], inv[q], best[q])
        lb = _slab_live(box[b], org[q], inv[q], best[q])
        push = la & lb & (sp[q] < STACK_DEPTH)
        qp = q[push]
        stack[qp, sp[qp]] = b[push]
        sp[qp] += 1
        node[q[la]] = a[la]
        only_b = ~la & lb
        node[q[only_b]] = b[only_b]
        # pop: leaves and inner nodes with no live child
        p = torch.cat([r, q[~la & ~lb]])
        empty = sp[p] == 0
        p2 = p[~empty]
        sp[p2] -= 1
        node[p2] = stack[p2, sp[p2]]
        done = torch.zeros(n, dtype=torch.bool, device=dev)
        done[p[empty]] = True
        live = live[~done[live]]
    return best, btri, bal, bbe, work


_lib_handle = None


def load_kernels(log=None) -> ctypes.CDLL:
    """Build csrc/packet_bvh.cu for sm_90a (once) and load it."""
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(device_mod.build_cuda('packet_bvh', log=log))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.packet_bvh_hit.argtypes = [ptr, i32, i32] + [ptr] * 5 \
            + [i32] + [ptr] * 7
        lib.packet_bvh_hit.restype = i32
        lib.packet_bvh_info.argtypes = [i32, ptr]
        lib.packet_bvh_info.restype = i32
        _lib_handle = lib
    return _lib_handle


def kernel_info(packed: PackedBVH) -> tuple:
    """(registers per thread, resident blocks per SM, shared bytes per
    block, threads per block) of the packet kernel on this tree, from the
    CUDA runtime."""
    buf = (ctypes.c_int * 4)()
    rc = load_kernels().packet_bvh_info(packed.depth, buf)
    if rc != 0:
        raise RuntimeError(f'packet_bvh_info failed: CUDA error {rc}')
    return tuple(buf)


def _soup_table(soup: TriSoup) -> torch.Tensor:
    """(T, 16) per-triangle rows in TriSoup field order, one 64-byte row
    per triangle for the kernel."""
    return torch.stack(list(soup), dim=1).contiguous()


def packet_hit(packed: PackedBVH, soup: TriSoup, org, dirn, tmax, tmin=None,
               work=None):
    """Closest hit for N rays: (t, tri, alpha, beta).  CPU tensors take
    packet_hit_plain; CUDA tensors launch the hand-written kernel
    (replaces the TPU kernel pallas_bvh._traverse_kernel) or raise.
    `work` (N, WORK) int32, optional: the kernel writes each ray's
    counters there (see WORK).  A ray input that requires grad raises
    (device.refuse_grad; ops/cluster.py, "Gradients")."""
    device_mod.refuse_grad('packet_hit', org, dirn, tmax, tmin)
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
    checks = ((packed.pairs, f32, (packed.pairs.shape[0], PAIR_WORDS)),
              (table, f32, (table.shape[0], 16)),
              (org, f32, (n, 3)), (dirn, f32, (n, 3)), (tmax, f32, (n,)),
              (tmin, f32, (n,)))
    for k, (x, dt, shape) in enumerate(checks):
        if x.device != dev or x.dtype != dt or not x.is_contiguous() \
                or tuple(x.shape) != shape or (k < 2 and x.data_ptr() % 16):
            raise ValueError('packet_hit inputs must be contiguous tensors '
                             'of the kernel types on one device (records '
                             'and soup rows 16-byte aligned)')
    if work is not None and (work.device != dev or work.dtype != i32
                             or tuple(work.shape) != (n, WORK)):
        raise ValueError(f'packet_hit work must be an (N, {WORK}) int32 '
                         f'tensor')
    t = torch.empty_like(tmax)
    tri = torch.empty((n,), dtype=i32, device=dev)
    al = torch.empty_like(tmax)
    be = torch.empty_like(tmax)
    if n == 0:
        return t, tri, al, be
    root_cnt = int(packed.nb[0]) if packed.pairs.shape[0] == 0 else 0
    next_ray = torch.zeros(1, dtype=i32, device=dev)
    rc = load_kernels().packet_bvh_hit(
        packed.pairs.data_ptr(), root_cnt, packed.depth, table.data_ptr(),
        org.data_ptr(), dirn.data_ptr(), tmax.data_ptr(), tmin.data_ptr(), n,
        next_ray.data_ptr(),
        t.data_ptr(), tri.data_ptr(), al.data_ptr(), be.data_ptr(),
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
