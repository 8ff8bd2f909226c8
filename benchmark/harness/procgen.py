"""The benchmark's own triangle generator: a closed, displaced UV sphere.

A numpy copy of the port's `utils.procgen.sphere_mesh`, the mesh of the
project's big-mesh scene (bench.py:118-127): the same grid, the same six
displacement waves drawn from the configuration's mesh seed, the same
dropped slivers.  The mesh is the configuration's and not the run's: its
work per wave sets the cell's rate, so every run's seed leaves it as it
is.  The arrays go to the program and, unchanged, to the reference.
"""

from __future__ import annotations

import numpy as np

WAVES = 6


def displaced_sphere(n_lat: int, n_lon: int, radius: float,
                     displace_amp: float, seed: int):
    """(vertices (V, 3) f32, triangles (T, 3) int32, unit radial normals
    (V, 3) f32, uvs (V, 2) f32) of a sphere of about 2 n_lat n_lon
    triangles, the zero-area polar slivers dropped."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)[:-1]
    LAT, LON = np.meshgrid(lat, lon, indexing='ij')
    x = np.sin(LAT) * np.cos(LON)
    y = np.cos(LAT)
    z = np.sin(LAT) * np.sin(LON)
    # pole rows exact, so every pole-ring vertex is the same point
    x[0, :] = 0.0; z[0, :] = 0.0; y[0, :] = 1.0
    x[-1, :] = 0.0; z[-1, :] = 0.0; y[-1, :] = -1.0
    r = np.full_like(x, radius)
    if displace_amp > 0.0:
        rng = np.random.default_rng(seed)
        env = np.sin(LAT)
        env[0, :] = 0.0; env[-1, :] = 0.0
        for _ in range(WAVES):
            f = rng.uniform(2.0, 9.0, 3)
            ph = rng.uniform(0, 2 * np.pi, 3)
            r = r + env * displace_amp * radius / 6.0 * (
                np.sin(f[0] * LAT + ph[0]) * np.cos(f[1] * LON + ph[1])
                + 0.5 * np.sin(f[2] * (LAT + LON) + ph[2]))
    verts = np.stack([x * r, y * r, z * r], -1).reshape(-1, 3)
    normals = np.stack([x, y, z], -1).reshape(-1, 3)
    uvs = np.stack([LON / (2 * np.pi), 1.0 - LAT / np.pi], -1).reshape(-1, 2)

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    ii, jj = np.meshgrid(np.arange(n_lat), np.arange(n_lon), indexing='ij')
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    v00, v10 = vid(ii, jj), vid(ii + 1, jj)
    v01, v11 = vid(ii, jj + 1), vid(ii + 1, jj + 1)
    tris = np.concatenate([np.stack([v00, v10, v11], -1),
                           np.stack([v00, v11, v01], -1)], 0)
    tv = verts[tris]
    area2 = np.linalg.norm(np.cross(tv[:, 1] - tv[:, 0],
                                    tv[:, 2] - tv[:, 0]), axis=1)
    diag2 = float(np.sum((verts.max(0) - verts.min(0)) ** 2))
    tris = tris[area2 > 1e-10 * diag2]
    return (verts.astype(np.float32), tris.astype(np.int32),
            normals.astype(np.float32), uvs.astype(np.float32))
