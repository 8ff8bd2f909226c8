"""Content-keyed cache of host-side mesh builds.

A scene rebuilt from the same triangles (render_video builds the scene
anew for every frame; several scenes may share one mesh) reuses the BVH
(ops.bvh.build_bvh), the cluster build's host arrays
(ops.cluster.build_clustered) and the orientation gate
(scene.topology.closed_orientation) instead of recomputing them: for a
2.4M-triangle mesh these are most of a build's time.  A key is a BLAKE2
digest of the input arrays' dtypes, shapes and bytes and of the build's
parameters, so equal inputs give the very result a fresh build gives.
Cached numpy arrays are read-only, since every later build shares them.
The cache holds the MAX_ENTRIES results used last; `clear` empties it.
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np

MAX_ENTRIES = 8
STATS = {'hits': 0, 'misses': 0}
_entries: collections.OrderedDict = collections.OrderedDict()


def digest(*parts) -> bytes:
    """A digest of numpy arrays (dtype, shape and bytes) and of other
    values (their repr)."""
    h = hashlib.blake2b(digest_size=20)
    for p in parts:
        if isinstance(p, np.ndarray):
            a = np.ascontiguousarray(p)
            h.update(f'{a.dtype.str}{a.shape}'.encode())
            h.update(a.view(np.uint8).reshape(-1) if a.ndim else a.tobytes())
        else:
            h.update(repr(p).encode())
        h.update(b'|')
    return h.digest()


def _freeze(x):
    if isinstance(x, np.ndarray):
        x.flags.writeable = False
    elif isinstance(x, tuple):                  # NamedTuples too
        for v in x:
            _freeze(v)
    return x


def cached(kind: str, key: bytes, build):
    """The result of build() for (kind, key): the stored one when there is
    one, else build()'s, stored with its arrays made read-only."""
    k = (kind, key)
    if k in _entries:
        _entries.move_to_end(k)
        STATS['hits'] += 1
        return _entries[k]
    STATS['misses'] += 1
    out = _freeze(build())
    _entries[k] = out
    while len(_entries) > MAX_ENTRIES:
        _entries.popitem(last=False)
    return out


def clear():
    _entries.clear()
