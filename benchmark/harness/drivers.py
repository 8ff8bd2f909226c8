"""The traffic drivers.  A traffic file names one of them and holds its
parameters; the driver builds the cell's program object in set-up,
warms up every shape the window uses, runs one unit of work per `unit()`
call in the window, and afterwards hands what the window produced to the
reference.

frames: progressive images as a user renders them.  `Renderer.step`
    waves of `samples_per_wave` samples; when an image holds the
    configuration's `spp` samples it is read to the host as `u8()`, the
    film is reset and the next image takes the next render seed.  The
    checked pixels of each image are read from its film (`hdr()`) at the
    same moment.
grad_steps: inverse-rendering steps.  Each step is the mean of an
    unfiltered `spp` image (`render_unsplatted`, remat per sample) and its
    gradient by `torch.autograd.grad` with respect to the scene's `kd`
    table and `light_intensity`, at materials and light drawn for that
    step from the seed, with that step's render seed.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from . import scenes

M32 = 0xFFFFFFFF


def _sync(device):
    import torch
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


class Frames:
    """Progressive frames through Renderer.step."""

    def __init__(self, cfg, traffic, check, seed, device, host):
        self.cfg, self.traffic, self.check_spec = cfg, traffic, check
        self.device, self.host = device, host
        self.rng = np.random.default_rng([seed, 0xF4A3])
        self.spw = traffic['samples_per_wave']
        if cfg['spp'] % self.spw:
            raise ValueError('samples_per_wave must divide the image spp')
        self.images = []       # (render seed, rows, cols, hdr (P, 3) numpy)
        t0 = time.perf_counter()
        self.mesh = scenes.mesh_arrays(cfg)
        host['mesh_s'] = time.perf_counter() - t0

    def _next_image(self):
        """Reset the film and give the next image its seed and pixels."""
        import torch
        w, h = self.cfg['resolution']
        n = self.check_spec['pixels_per_image']
        self.seed = int(self.rng.integers(0, M32, endpoint=True))
        self.rows = self.rng.integers(0, h, n)
        self.cols = self.rng.integers(0, w, n)
        self._idx = (torch.as_tensor(self.rows, device=self.device),
                     torch.as_tensor(self.cols, device=self.device))
        self.r.reset()
        self.r.cfg = self.r.cfg._replace(seed=self.seed)

    def setup(self):
        import pathtracer_tpu_torch as pt
        cfg, prog = self.cfg, self.cfg.get('program', {})
        t0 = time.perf_counter()
        sc, cam = scenes.program_scene(cfg, self.mesh, self.device)
        _sync(self.device)
        t1 = time.perf_counter()
        if self.mesh is not None:
            self.host['scene_build_s'] = t1 - t0
        w, h = cfg['resolution']
        rc = pt.RenderConfig(
            width=w, height=h, nrays=cfg['spp'], nb_bounces=cfg['bounces'],
            sigma_filter=cfg['sigma_filter'], gamma=cfg['gamma'],
            samples_per_wave=self.spw, tile_size=cfg['lane_tile'],
            compact_rays=bool(prog.get('compact_rays', False)))
        self.r = pt.Renderer(sc, cam, rc)
        self._next_image()
        t2 = time.perf_counter()
        for _ in range(self.traffic['warmup_waves']):
            self.r.step()
        self.r.u8()
        self.r.hdr()[self._idx].cpu()
        self._next_image()
        _sync(self.device)
        self.host.update(renderer_s=t2 - t1,
                         warmup_s=time.perf_counter() - t2)

    def answered(self) -> bool:
        return bool(self.images)

    def unit(self):
        r = self.r
        r.step()
        if r.samples_done >= self.cfg['spp']:
            r.u8()
            vals = r.hdr()[self._idx].double().cpu().numpy()
            self.images.append((self.seed, self.rows, self.cols, vals))
            self._next_image()
        return {'waves': 1, 'samples': self.spw}

    @contextlib.contextmanager
    def traced(self):
        from . import trace
        with trace.annotated():
            yield

    def compare(self, dtype=None):
        """Program's and reference's HDR values of every checked pixel of
        the window's images (at most `max_images`, the first), each (P, 3)
        float64."""
        import torch
        sc, cam = scenes.reference_scene(self.cfg, self.mesh, self.device,
                                         dtype)
        from ..reference import tracer
        pairs = []
        for seed, rows, cols, vals in self.images[
                :self.check_spec['max_images']]:
            ref = tracer.film_pixels(
                sc, cam, self.cfg, seed,
                torch.as_tensor(rows, device=self.device),
                torch.as_tensor(cols, device=self.device),
                self.cfg['lane_tile'], dtype or torch.float32)
            pairs.append((vals, ref.cpu().numpy()))
        return pairs

    def close(self):
        self.r = None


class GradSteps:
    """Forward and backward of the mean image, remat per sample."""

    def __init__(self, cfg, traffic, check, seed, device, host):
        self.cfg, self.traffic, self.check_spec = cfg, traffic, check
        self.device, self.host = device, host
        self.rng = np.random.default_rng([seed, 0x6AD])
        self.steps = []        # (kd (O, 3) f32, li f32, seed, loss, grads)
        self.mesh = scenes.mesh_arrays(cfg)
        self._label = contextlib.nullcontext
        self._pick = None

    def _inputs(self):
        """The next step's kd table, light intensity and render seed."""
        lo, hi = self.traffic['material_scale']
        kd = (self.kd0 * self.rng.uniform(lo, hi, (len(self.kd0), 1))
              ).astype(np.float32)
        li = np.float32(self.li0 * self.rng.uniform(lo, hi))
        return kd, li, int(self.rng.integers(0, M32, endpoint=True))

    def setup(self):
        import torch
        import pathtracer_tpu_torch as pt
        from pathtracer_tpu_torch.core import rng_host
        cfg = self.cfg
        self.sc, cam = scenes.program_scene(cfg, self.mesh, self.device)
        self.cam = cam.to(self.device)
        # the materials and light of the configuration, which each step
        # scales; both sides get the same float32 values
        self.kd0 = np.asarray([o.get('kd', (1.0, 1.0, 1.0))
                               for o in cfg['objects']], np.float64)
        self.li0 = float(np.float32(cfg['light_intensity']))
        w, h = cfg['resolution']
        self.rc = pt.RenderConfig(width=w, height=h, nrays=cfg['spp'],
                                  nb_bounces=cfg['bounces'],
                                  remat_samples=bool(
                                      self.traffic['remat_samples']))
        self.cp = torch.as_tensor(rng_host.random_per_pixel_fast(w, h),
                                  device=self.device)
        t0 = time.perf_counter()
        for _ in range(self.traffic['warmup_steps']):
            self._step(*self._inputs())
        self.steps.clear()
        _sync(self.device)
        self.host['warmup_s'] = time.perf_counter() - t0

    def _step(self, kd, li, seed):
        import torch
        from pathtracer_tpu_torch.render import renderer as rnd
        kd_t = torch.as_tensor(kd, device=self.device).requires_grad_()
        li_t = torch.as_tensor(li, device=self.device).requires_grad_()
        img = rnd.render_unsplatted(
            self.sc.replace(kd=kd_t, light_intensity=li_t), self.cam,
            self.cp, self.rc._replace(seed=seed))[0]
        loss = img.mean()
        with self._label():
            g_kd, g_li = torch.autograd.grad(loss, [kd_t, li_t])
        self.steps.append((kd, li, seed, float(loss.detach()),
                           {'kd': g_kd.double().cpu().numpy(),
                            'light_intensity': g_li.double().cpu().numpy()}))

    def answered(self) -> bool:
        return bool(self.steps)

    def unit(self):
        self._step(*self._inputs())
        return {'steps': 1, 'samples': self.cfg['spp']}

    @contextlib.contextmanager
    def traced(self):
        import torch

        def label():
            return torch.profiler.record_function('backward')

        self._label = label
        try:
            yield
        finally:
            self._label = contextlib.nullcontext

    def compare(self, dtype=None):
        """Program's and reference's (loss, grads) at up to `max_steps`
        steps of the window drawn from the seed."""
        import torch
        from ..reference import tracer
        sc, cam = scenes.reference_scene(self.cfg, self.mesh, self.device,
                                         dtype)
        if self._pick is None:
            n = min(self.check_spec['max_steps'], len(self.steps))
            self._pick = sorted(self.rng.choice(len(self.steps), n,
                                                replace=False))
        pick = self._pick
        out = []
        for i in pick:
            kd, li, seed, loss, grads = self.steps[i]
            leaves = {'kd': torch.as_tensor(kd, device=self.device),
                      'light_intensity': torch.as_tensor(
                          li, device=self.device)}
            ref_loss, ref_g = tracer.mean_image_grad(
                sc, cam, dict(self.cfg, seed=seed), leaves,
                dtype or torch.float32)
            out.append(((loss, grads),
                        (ref_loss, {k: v.cpu().numpy()
                                    for k, v in ref_g.items()})))
        return out

    def close(self):
        self.sc = self.cp = None


DRIVERS = {'frames': Frames, 'grad_steps': GradSteps}
