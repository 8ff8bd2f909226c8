"""Ablate the cluster sweep's per-slot cost on the card: staging against
the plane products against the epilogue.

    python -m pathtracer_tpu_torch.scripts.ablate_sweep [--device cpu]
        [--grid 708] [--packets 512]

Counterpart of scripts/tpu_ablate_sweep.py, on the port's own sweep (the
TPU script no longer runs against the JAX package; ops/sweep_ablate.py
says why).  The workload is the TPU script's: a G x G-cell sine terrain
(G = 708: 1,002,528 triangles) built with the port's build_clustered,
1080p rays from (0, 60, 0) looking down in 32 x 32 tile order, one cull,
the first 512 packets (262,144 rays) with their slot counts clamped to 8.
Each variant of ops/sweep_ablate.VARIANTS is timed with CUDA events and
printed as ms per launch, microseconds per swept slot (fixed costs
included) and the share of lanes that hit.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..ops import cluster
from ..ops import sweep_ablate as sa
from . import device_line, resolve_device, time_us

G = 708
H, W = 1080, 1920
TS = 32
PACKETS = 512
LAUNCHES = 4        # timed launches per variant


def terrain(g: int = G) -> np.ndarray:
    """(2 g^2, 3, 3) f32 triangles of the TPU script's sine terrain."""
    xs = np.linspace(-20, 20, g + 1, dtype=np.float32)
    x, z = np.meshgrid(xs, xs, indexing='ij')
    y = 3.0 * np.sin(x * 0.6) * np.cos(z * 0.5) + 1.2 * np.sin(x * 1.7 + 2.0)
    v = np.stack([x, y, z], -1)
    q00, q10, q01, q11 = v[:-1, :-1], v[1:, :-1], v[:-1, 1:], v[1:, 1:]
    return np.concatenate([
        np.stack([q00, q10, q11], 2).reshape(-1, 3, 3),
        np.stack([q00, q11, q01], 2).reshape(-1, 3, 3)], 0).astype(np.float32)


def camera_rays(n: int):
    """The first n of the TPU script's 1080p rays in 32 x 32 tile order:
    (org, dirn) as (n, 3) f32 numpy arrays."""
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    d = np.stack([(jj - W / 2) / W * 0.55,
                  -np.ones_like(ii).astype(np.float32),
                  (ii - H / 2) / H * 0.3], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hc = (H // TS) * TS
    d = (d[:hc].reshape(hc // TS, TS, W // TS, TS, 3)
         .transpose(0, 2, 1, 3, 4).reshape(-1, 3))
    d = np.concatenate([d, d[:H * W - len(d)]], 0)[:n]
    org = np.broadcast_to(np.array([0.0, 60.0, 0.0], np.float32), d.shape)
    return np.ascontiguousarray(org), np.ascontiguousarray(d)


@dataclasses.dataclass
class Workload:
    cm: cluster.ClusteredMesh
    ids: torch.Tensor        # (nb, MAXC) int32
    counts: torch.Tensor     # (nb, 1) int32, clamped to SLOTS
    org: torch.Tensor
    dirn: torch.Tensor
    tmax: torch.Tensor
    tmin: torch.Tensor

    def args(self):
        return (self.cm, self.ids, self.counts, self.org, self.dirn,
                self.tmax, self.tmin)

    @property
    def slots(self) -> int:
        return int(self.counts.clamp(max=cluster.MAXC).sum())


def workload(dev, g: int = G, packets: int = PACKETS, log=print) -> Workload:
    """Build the terrain on `dev`, cull the first `packets` packets of the
    camera rays once, and clamp the counts to SLOTS."""
    t0 = time.perf_counter()
    tris = terrain(g)
    cm = cluster.build_clustered(tris, dev=dev)
    n = packets * cluster.BLOCK
    o, d = (torch.as_tensor(x, device=dev) for x in camera_rays(n))
    tmax = torch.full((n,), cluster.BIG_T, device=dev)
    ids, count, _ = cluster.cluster_cull(cm, o, d, tmax)
    log(f'tris: {tris.shape[0]} clusters: {cm.n_clusters} (build and cull '
        f'{time.perf_counter() - t0:.1f} s, host clock)')
    return Workload(cm, ids, count.clamp(max=sa.SLOTS).contiguous(), o, d,
                    tmax, torch.full((n,), -1.0, device=dev))


def run(w: Workload, log=print) -> dict:
    """Time each variant; returns {variant: ms per launch}."""
    dev = w.org.device
    log(device_line(dev))
    out = {}
    for v in sa.VARIANTS:
        ms = time_us(lambda v=v: sa.sweep_ablate(*w.args(), v), LAUNCHES,
                     dev) / 1e3
        t = sa.sweep_ablate(*w.args(), v)[0]
        out[v] = ms
        log(f'{v:11s}: {ms:8.3f}ms  ({ms / max(w.slots, 1) * 1e3:.3f}us/slot '
            f'incl. fixed)  hitfrac={float((t < 1e29).float().mean()):.3f}')
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--grid', type=int, default=G)
    ap.add_argument('--packets', type=int, default=PACKETS)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    w = workload(dev, a.grid, a.packets)
    print(f'{w.ids.shape[0]} packets, {w.slots} slots swept', flush=True)
    return run(w)


if __name__ == '__main__':
    main()
