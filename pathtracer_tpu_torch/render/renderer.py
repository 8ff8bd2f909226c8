"""Top-level renderer: sample scheduling, camera draws, waves, film
(counterpart of pathtracer_tpu/render/renderer.py).

A wave renders every pixel for a few samples.  Path (pixel p, sample k)
owns the PCG32 stream keyed (seed << 32) | (p * nspp + k), seeded as
pcg32(key, key), so an image depends only on the seed, never on the wave
split.  `render_unsplatted` is differentiable with respect to the
material and light leaves (the detached-sampling estimator of
render/integrator.py); with `remat_samples` each sample's body runs under
activation checkpointing and is recomputed in backward, from the same
streams, so one sample's graph is alive at a time.  With has_denoiser the
renderer also accumulates the unsplatted (color, albedo, normal) buffers
that feed the denoisers (render/denoise.py, render/denoise_net.py).
`render_resumable` checkpoints the film to an .npz and resumes it bit for
bit; `preview` and `display_fill_in` give the reference's low-res
progressive fill-in.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
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
    has_denoiser: bool = False  # accumulate unsplatted aux for denoising
    tile_size: int = -1         # >0 tile-major lanes, 0 row-major, -1 AUTO
                                # (32 when the scene holds meshes)
    sort_rays: bool = False     # octant re-sort between bounces
    compact_rays: bool = False  # bounces > 0 on the live prefix only
                                # (implies the octant sort)
    remat_samples: bool = False  # render_unsplatted: checkpoint each
                                 # sample, recomputed in backward


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
    the progressive sample schedule.  Runs on the scene's device.
    `render()` is the offline path, `step()` the progressive one."""

    PREVIEW_FACTOR = 16       # 1/16-per-axis low-res buffer (the
                              # reference's Wlr/Hlr, Raytracer.cpp:1508)
    PREVIEW_BLEND_SPP = 6     # blend while sample_count <= 5
                              # (mainApp.cpp:1219-1238: alpha = count/6)

    def __init__(self, sc: scn.SceneArrays, cam: cam_mod.Camera,
                 cfg: RenderConfig):
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
            sc = self.scene
            ts = 32 if (sc.meshes or sc.pointsets or sc.yarns) else 0
        self._order = _pixel_order(cfg.width, cfg.height, ts, self.device)
        self._preview_lin = None
        self.reset()

    def reset(self):
        self.image, self.sample_count = film_mod.alloc(self.film)
        h, w = self.cfg.height, self.cfg.width
        # unsplatted (color, albedo, normal) sums, the denoiser feed (the
        # reference's OIDN buffers, Raytracer.cpp:1631-1645)
        self.aux = tuple(torch.zeros((h, w, 3), device=self.device)
                         for _ in range(3))
        self.samples_done = 0
        self._rays = []         # per-bounce live-lane counts (device)
        self._ss_over = []      # reservoir-march overflows per sample

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def step(self, nsamples: Optional[int] = None):
        """Trace the next `nsamples` samples per pixel (default: one wave)."""
        nsamples = nsamples or self.cfg.samples_per_wave
        cfg = self.cfg
        h, w = cfg.height, cfg.width
        pix_i, pix_j, untile = self._order
        bg_pixel = _background_pixels(self.scene, pix_i, pix_j, cfg.width,
                                      cfg.height)
        for k in range(self.samples_done, self.samples_done + nsamples):
            # lane i takes CP shift cp_table[i] in lane (tile) order, as
            # the JAX renderer does (ROADMAP Queue 3)
            st, org, dirn, dx, dy, cp_r12 = _camera_paths(
                self.cam, cfg, pix_i, pix_j, k, self.cp_table)
            color, naux, aaux, live, ss_over = integrator.trace_paths(
                self.scene, org, dirn, st, cp_r12, cfg.nb_bounces,
                bg_pixel=bg_pixel, sort_rays=cfg.sort_rays or cfg.compact_rays,
                compact_rays=cfg.compact_rays)
            color_rm = untile(color)
            film_mod.splat(self.film, self.image, self.sample_count,
                           color_rm, untile(dx), untile(dy))
            if cfg.has_denoiser:
                self.aux = (self.aux[0] + color_rm.reshape(h, w, 3),
                            self.aux[1] + untile(aaux).reshape(h, w, 3),
                            self.aux[2] + untile(naux).reshape(h, w, 3))
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
        self._sync()
        return self

    def render_resumable(self, path: str, guard=None,
                         save_every: Optional[int] = None):
        """Preemption-safe render: resume `path` if present, checkpoint on
        preemption (and every `save_every` samples), delete the checkpoint
        on completion.

        `guard` is a parallel.distributed.PreemptionGuard (or anything
        with a `requested` flag); when it trips, the wave in flight
        finishes, the state is saved, and the call returns early with
        `samples_done < cfg.nrays`.  Calling it again picks up where it
        left off: samples are keyed by absolute index, so the resumed
        image is bit-equal to an uninterrupted render."""
        if not path.endswith('.npz'):
            raise ValueError('np.savez appends .npz; pass a path ending in '
                             f'.npz, not {path!r}')
        if os.path.exists(path):
            self.load_checkpoint(path)
        last_saved = self.samples_done
        while self.samples_done < self.cfg.nrays:
            self.step(min(self.cfg.samples_per_wave,
                          self.cfg.nrays - self.samples_done))
            preempted = guard is not None and guard.requested
            if preempted or (save_every is not None
                             and self.samples_done - last_saved
                             >= save_every):
                self._sync()
                self.save_checkpoint(path)
                last_saved = self.samples_done
                if preempted:
                    return self
        self._sync()
        if os.path.exists(path):
            os.remove(path)
        return self

    @property
    def rays_traced(self) -> int:
        return int(sum(int(r) for r in self._rays))

    @property
    def ss_overflow(self) -> int:
        return int(sum(int(x) for x in self._ss_over))

    def hdr(self):
        """Accumulated HDR image (before tone mapping), divided by the
        splat weights."""
        img = film_mod.crop(self.film, self.image)
        cnt = film_mod.crop(self.film, self.sample_count)
        return img / film_mod.RADIANCE_SCALE / torch.clamp_min(
            cnt, 1e-9)[..., None]

    def preview(self, spp: int = 1):
        """Render (once) the 1/16-per-axis low-res preview buffer, (hlr,
        wlr, 3) linear radiance: the reference's Wlr = W/16 accumulation
        image (Raytracer.cpp:1508-1510), 1/256 of a wave's rays, so an
        early progressive view is dense."""
        if self._preview_lin is None:
            f = self.PREVIEW_FACTOR
            wlr = max(self.cfg.width // f, 2)
            hlr = max(self.cfg.height // f, 2)
            pcfg = self.cfg._replace(width=wlr, height=hlr, nrays=spp,
                                     remat_samples=False)
            cp = torch.as_tensor(rng_host.random_per_pixel_fast(wlr, hlr),
                                 device=self.device)
            self._preview_lin = render_unsplatted(self.scene, self.cam, cp,
                                                  pcfg)[0]
        return self._preview_lin

    def display_fill_in(self):
        """Display image with the reference's low-res fill-in blend:
        pixels with sample_count <= 5 mix toward the bilinear-upsampled
        preview with alpha = count/6 (mainApp.cpp:1214-1240); the plain
        display once every pixel has PREVIEW_BLEND_SPP samples."""
        cnt = film_mod.crop(self.film, self.sample_count)
        if int(cnt.min()) >= self.PREVIEW_BLEND_SPP:
            return self.display()
        low = self.preview()
        h, w = self.cfg.height, self.cfg.width
        # half-pixel centres with the source coordinate clamped: for an
        # upsampling this is jax.image.resize's 'bilinear' (which
        # renormalises the taps that fall outside instead)
        up = F.interpolate(low.permute(2, 0, 1)[None], size=(h, w),
                           mode='bilinear', align_corners=False)[0] \
            .permute(1, 2, 0)
        img = film_mod.crop(self.film, self.image)
        lin = img / film_mod.RADIANCE_SCALE / torch.clamp_min(
            cnt, 1.0)[..., None]
        alpha = torch.clamp(cnt / float(self.PREVIEW_BLEND_SPP),
                            0.0, 1.0)[..., None]
        blended = alpha * lin + (1.0 - alpha) * up
        return torch.clamp(torch.pow(torch.clamp_min(blended, 0.0),
                                     1.0 / self.cfg.gamma), 0.0, 1.0)

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
            'ss_reservoir_overflow': self.ss_overflow,
        }

    def save_checkpoint(self, path: str):
        """Mid-render checkpoint: film, splat weights, the denoiser feed
        and progress, with the JAX renderer's .npz keys.  The config is
        stored as its repr, which differs from the JAX package's, so a
        checkpoint resumes in the package that wrote it only."""
        def host(x):
            return x.detach().cpu().numpy()

        np.savez(path, image=host(self.image),
                 sample_count=host(self.sample_count),
                 aux0=host(self.aux[0]), aux1=host(self.aux[1]),
                 aux2=host(self.aux[2]), samples_done=self.samples_done,
                 rays_traced=self.rays_traced, ss_overflow=self.ss_overflow,
                 cfg=repr(self.cfg))

    def load_checkpoint(self, path: str):
        """Resume a checkpoint written by save_checkpoint with the same
        RenderConfig; raises ValueError for any other config."""
        with np.load(path, allow_pickle=False) as d:
            if str(d['cfg']) != repr(self.cfg):
                raise ValueError('checkpoint was written with a different '
                                 f'RenderConfig: {d["cfg"]}')

            def dev(k):
                return torch.as_tensor(d[k], device=self.device)

            self.image, self.sample_count = dev('image'), dev('sample_count')
            self.aux = (dev('aux0'), dev('aux1'), dev('aux2'))
            self.samples_done = int(d['samples_done'])
            self._rays = [torch.tensor(int(d['rays_traced']))]
            self._ss_over = [torch.tensor(int(d['ss_overflow']))]
        return self

    def denoised_display(self, iterations: int = 4):
        """Display image denoised from the aux buffers by the a-trous
        filter (the reference's OIDN path, Raytracer.cpp:1719-1756).
        Needs cfg.has_denoiser."""
        from . import denoise as dn
        if not self.cfg.has_denoiser:
            raise ValueError('denoised_display needs a render with '
                             'RenderConfig(has_denoiser=True)')
        n = max(self.samples_done, 1)
        color = self.aux[0] / n
        albedo = self.aux[1] / n
        nrm = self.aux[2]
        nrm = nrm / torch.clamp_min(torch.linalg.vector_norm(
            nrm, dim=-1, keepdim=True), 1e-9)
        out = dn.atrous_denoise(color, albedo, nrm, iterations=iterations)
        # the buffers are per-sample means, unsplatted; rows flip to image
        # orientation as the splat does
        out = out.flip(0) / film_mod.RADIANCE_SCALE
        return torch.clamp(torch.pow(torch.clamp_min(out, 0.0),
                                     1.0 / self.cfg.gamma), 0.0, 1.0)
