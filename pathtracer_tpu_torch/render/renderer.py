"""Top-level renderer: sample scheduling, camera draws, waves, film
(counterpart of pathtracer_tpu/render/renderer.py).

A wave renders every pixel for a few samples.  Path (pixel p, sample k)
owns the PCG32 stream keyed (seed << 32) | (p * nspp + k), seeded as
pcg32(key, key), so an image depends only on the seed, never on the wave
split.  `render_unsplatted` is differentiable with respect to the
material and light leaves (the detached-sampling estimator of
render/integrator.py); with `remat_samples` each sample's body runs under
activation checkpointing and is recomputed in backward, from the same
streams, so one sample's graph is alive at a time.  The denoiser feed is
not ported yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils import checkpoint

from ..core import camera as cam_mod
from ..core import qmc
from ..core import rng as prng
from ..core import rng_host
from ..scene import scene as scn
from . import film as film_mod
from . import integrator


class RenderConfig(NamedTuple):
    width: int = 1000
    height: int = 800
    nrays: int = 100            # samples per pixel
    nb_bounces: int = 3
    sigma_filter: float = 0.5
    gamma: float = 2.2
    seed: int = 0
    samples_per_wave: int = 4
    double_frustum_start_t: float = 0.0
    has_denoiser: bool = False  # not ported yet
    tile_size: int = -1         # >0 tile-major lanes, 0 row-major, -1 AUTO
                                # (32 when the scene holds meshes)
    sort_rays: bool = False     # octant re-sort between bounces
    compact_rays: bool = False  # bounces > 0 on the live prefix only
                                # (implies the octant sort)
    remat_samples: bool = False  # render_unsplatted: checkpoint each
                                 # sample, recomputed in backward


def _check_config(cfg: RenderConfig):
    if cfg.has_denoiser:
        raise NotImplementedError('the denoiser feed is not ported yet '
                                  '(ROADMAP Queue 1 item 10)')


def _near_divisor(n: int, ts: int) -> int:
    """The divisor of n closest to ts (searching up to 2*ts)."""
    best = 1
    for d in range(1, min(n, ts * 2) + 1):
        if n % d == 0 and abs(d - ts) < abs(best - ts):
            best = d
    return best


def _pixel_order(w, h, tile_size, device):
    """Pixel index tensors in lane order + an `untile` mapping lane order
    back to row-major.  tile_size > 0 walks ~ts x ~ts pixel tiles (tight
    packet frustums for the cluster sweeps)."""
    ii, jj = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing='ij')
    if tile_size > 0:
        tsh = _near_divisor(h, tile_size)
        tsw = _near_divisor(w, tile_size)
        if tsh > 1 or tsw > 1:
            ht, wt = h // tsh, w // tsw

            def tile(a):
                return a.reshape(ht, tsh, wt, tsw).permute(0, 2, 1, 3) \
                    .reshape(-1)

            def untile(x):
                lead = x.shape[1:]
                return (x.reshape(ht, wt, tsh, tsw, *lead)
                        .permute(0, 2, 1, 3, *(4 + i for i in range(len(lead))))
                        .reshape(h * w, *lead))

            return tile(ii), tile(jj), untile
    return ii.reshape(-1), jj.reshape(-1), (lambda x: x)


def _background_pixels(sc, pix_i, pix_j, w, h):
    """Per-lane background photo colour (reference: Raytracer.cpp:260-266
    index math), or None without a photo."""
    if sc.background is None:
        return None
    bgh, bgw = sc.background.shape[0], sc.background.shape[1]
    bi = torch.clamp((pix_i.to(torch.float32) / h * bgh).to(torch.int64),
                     0, bgh - 1)
    bj = torch.clamp((pix_j.to(torch.float32) / w * bgw).to(torch.int64),
                     0, bgw - 1)
    return sc.background[bi, bj]


def _camera_paths(cam, cfg: RenderConfig, pix_i, pix_j, k: int, cp_table):
    """Per-path streams, camera draws (dx, dy, dxa, dya), primary rays and
    the rotated lattice sample for sample index k."""
    pix_flat = pix_i * cfg.width + pix_j
    key_lo = (pix_flat * cfg.nrays + k) & prng.M32
    key_hi = torch.full_like(key_lo, cfg.seed & prng.M32)
    st = prng.make_stream(key_hi, key_lo)
    u_dx, st = prng.next_uniform(st)
    u_dy, st = prng.next_uniform(st)
    u_ax, st = prng.next_uniform(st)
    u_ay, st = prng.next_uniform(st)
    dx, dy = u_dx - 0.5, u_dy - 0.5
    org, dirn = cam_mod.generate_rays(
        cam, pix_i, pix_j, dx, dy, (u_ax - 0.5) * cam.aperture,
        (u_ay - 0.5) * cam.aperture, cfg.width, cfg.height,
        init_t=cfg.double_frustum_start_t)
    lattice = qmc.extensible_lattice_2d(
        torch.tensor(k, dtype=torch.int64, device=pix_i.device))
    return st, org, dirn, dx, dy, qmc.cranley_patterson(lattice[None, :],
                                                         cp_table)


def render_unsplatted(sc: scn.SceneArrays, cam: cam_mod.Camera, cp_table,
                      cfg: RenderConfig):
    """Per-pixel mean radiance over all cfg.nrays samples, no pixel filter,
    row-major lanes.  Returns ((h, w, 3) mean, (h, w, nspp, 3) samples).

    Differentiable with respect to the scene's material and light tensors
    (`sc.replace(kd=...)`, `mesh.replace(g_kd=...)` with requires_grad).
    cfg.remat_samples checkpoints each sample (jax.checkpoint of the JAX
    renderer): backward recomputes it, bit for bit, from its PCG streams.
    Time a forward alone under torch.no_grad(): with leaves that require
    grad every sample's graph would stay alive.  Unlike the JAX function,
    the camera backface gate applies here too, as in Renderer."""
    _check_config(cfg)
    sc = scn.camera_backface_gate(sc, cam.position.cpu().numpy())
    w, h = cfg.width, cfg.height
    pix_i, pix_j, _ = _pixel_order(w, h, 0, sc.device)
    bg_pixel = _background_pixels(sc, pix_i, pix_j, w, h)

    def per_sample(k):
        st, org, dirn, _, _, cp_r12 = _camera_paths(cam, cfg, pix_i, pix_j,
                                                    k, cp_table)
        return integrator.trace_paths(
            sc, org, dirn, st, cp_r12, cfg.nb_bounces, bg_pixel=bg_pixel,
            sort_rays=cfg.sort_rays or cfg.compact_rays,
            compact_rays=cfg.compact_rays)[0]

    samples = []
    for k in range(cfg.nrays):
        if cfg.remat_samples:
            # the draws are PCG streams of their own, not torch's RNG
            color = checkpoint.checkpoint(per_sample, k, use_reentrant=False,
                                          preserve_rng_state=False)
        else:
            color = per_sample(k)
        samples.append(color)
    samples = torch.stack(samples, dim=1).reshape(h, w, cfg.nrays, 3)
    return samples.mean(dim=2), samples


class Renderer:
    """Host-side orchestrator: film accumulators, per-pixel CP table and
    the progressive sample schedule.  Runs on the scene's device."""

    def __init__(self, sc: scn.SceneArrays, cam: cam_mod.Camera,
                 cfg: RenderConfig):
        _check_config(cfg)
        # a camera inside a closed mesh must see its back faces
        self.scene = scn.camera_backface_gate(sc, cam.position.cpu().numpy())
        self.device = sc.device
        self.cam = cam.to(self.device)
        self.cfg = cfg
        self.film = film_mod.make_film(cfg.width, cfg.height, cfg.sigma_filter,
                                       device=self.device)
        self.cp_table = torch.as_tensor(
            rng_host.random_per_pixel_fast(cfg.width, cfg.height),
            device=self.device)
        ts = cfg.tile_size
        if ts < 0:
            ts = 32 if self.scene.meshes else 0
        self._order = _pixel_order(cfg.width, cfg.height, ts, self.device)
        self.reset()

    def reset(self):
        self.image, self.sample_count = film_mod.alloc(self.film)
        self.samples_done = 0
        self._rays = []         # per-bounce live-lane counts (device)
        self._ss_over = []      # reservoir-march overflows per sample

    def step(self, nsamples: Optional[int] = None):
        """Trace the next `nsamples` samples per pixel (default: one wave)."""
        nsamples = nsamples or self.cfg.samples_per_wave
        cfg = self.cfg
        pix_i, pix_j, untile = self._order
        bg_pixel = _background_pixels(self.scene, pix_i, pix_j, cfg.width,
                                      cfg.height)
        for k in range(self.samples_done, self.samples_done + nsamples):
            # lane i takes CP shift cp_table[i] in lane (tile) order, as
            # the JAX renderer does (ROADMAP Queue 3)
            st, org, dirn, dx, dy, cp_r12 = _camera_paths(
                self.cam, cfg, pix_i, pix_j, k, self.cp_table)
            color, _, _, live, ss_over = integrator.trace_paths(
                self.scene, org, dirn, st, cp_r12, cfg.nb_bounces,
                bg_pixel=bg_pixel, sort_rays=cfg.sort_rays or cfg.compact_rays,
                compact_rays=cfg.compact_rays)
            film_mod.splat(self.film, self.image, self.sample_count,
                           untile(color), untile(dx), untile(dy))
            # live-lane accounting: one closest-hit and one NEE shadow
            # sweep per live lane per bounce
            self._rays.append(2 * torch.stack(live).sum())
            self._ss_over.append(ss_over)
        self.samples_done += nsamples
        return self

    def render(self):
        """Full offline render: all nrays samples."""
        while self.samples_done < self.cfg.nrays:
            self.step(min(self.cfg.samples_per_wave,
                          self.cfg.nrays - self.samples_done))
        return self

    @property
    def rays_traced(self) -> int:
        return int(sum(int(r) for r in self._rays))

    def display(self):
        return film_mod.to_display(film_mod.crop(self.film, self.image),
                                   film_mod.crop(self.film, self.sample_count),
                                   gamma=self.cfg.gamma)

    def u8(self):
        return film_mod.to_u8(self.display())

    def stats(self, seconds: float):
        """rays/s and time per sample over `seconds` of wall time; rays
        are the MEASURED live-lane count."""
        spp = max(self.samples_done, 1)
        rays = self.rays_traced
        return {
            'samples_done': self.samples_done,
            'time_per_sample_s': seconds / spp,
            'rays_traced': rays,
            'rays_per_second': rays / max(seconds, 1e-12),
            # subsurface probes lost to the crossing march's slot budget
            # (RESERVOIR_MAX_CROSSINGS), each a biased miss
            'ss_reservoir_overflow': int(sum(int(x) for x in self._ss_over)),
        }
