"""Multi-rank rendering and training: pixel rows and samples sharded over
a mesh of torch.distributed ranks (counterpart of
pathtracer_tpu/parallel/sharding.py).

The reference's only parallelism is OpenMP threads over pixel rows on one
machine (Raytracer.cpp:1455-1459, 1590-1597).  Here, as in the JAX
package:

  * the 'dp' axis shards image rows: each rank traces its block of rows;
  * the 'sp' axis shards samples per pixel: each rank traces a
    contiguous block of sample ids of the same pixels;
  * the optional 'scene' axis shards the geometry
    (parallel/scene_shard.py): rays are replicated over it and the hits
    combine inside the hit queries.

Each rank splats its block into a full padded film (the splat windows
cross row borders) and the films are summed over the dp and sp ranks,
in place of a halo exchange.  The JAX package runs the mesh inside one
program (shard_map); here each rank is a process, the mesh is a grid of
ranks with one process group per axis, and the collectives are
torch.distributed calls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import checkpoint

from ..render import film as film_mod
from ..render import integrator
from ..render import renderer as rnd
from ..scene import scene as scn
from . import distributed as pd


@dataclasses.dataclass
class Mesh:
    """A (dp, sp[, scene]) grid over ranks 0..need-1 of the default group.

    shape: axis name -> size; coords: this rank's coordinate on each
    axis, or None for a rank outside the grid; groups: axis name -> the
    process group of the ranks that differ from this one on that axis
    only, and 'dpsp' -> the ranks that share its scene coordinate (the
    film sum); a group is None when no process group exists (one
    process)."""

    shape: dict
    coords: Optional[dict]
    groups: dict


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              sp: int = 1, scene: int = 1) -> Mesh:
    """The ('dp', 'sp'[, 'scene']) mesh over the first dp*sp*scene ranks
    (dp defaults to n_devices // (sp * scene), n_devices to the world
    size).  Every rank of the default group must call it, in the same
    order as its other group calls: new_group is collective."""
    rank, n_world = pd.world()
    n = n_devices or n_world
    if dp is None:
        dp = n // (sp * scene)
    need = dp * sp * scene
    assert need <= n_world, f'need {need} ranks, have {n_world}'
    shape = {'dp': dp, 'sp': sp}
    if scene > 1:
        shape['scene'] = scene
    grid = np.arange(need).reshape(dp, sp, scene)
    coords = None
    if rank < need:
        i, j, k = (int(x) for x in np.argwhere(grid == rank)[0])
        coords = {'dp': i, 'sp': j, 'scene': k}
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(shape, coords, {a: None for a in
                                    ('dp', 'sp', 'scene', 'dpsp')})
    # one group per line of the grid along each axis (new_group is
    # collective: every rank creates every group, in this order)
    lines = {'dp': [grid[:, j, k] for j in range(sp) for k in range(scene)],
             'sp': [grid[i, :, k] for i in range(dp) for k in range(scene)],
             'scene': [grid[i, j, :] for i in range(dp) for j in range(sp)],
             'dpsp': [grid[:, :, k].reshape(-1) for k in range(scene)]}
    groups = {}
    for axis, ls in lines.items():
        for ranks in ls:
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                groups[axis] = g
    for axis in lines:
        groups.setdefault(axis, None)
    return Mesh(shape, coords, groups)


def _shard_sample(sc, cam, cfg, pix_i, pix_j, k, cp_shard, bg_pixel):
    """One sample of this rank's rows: the camera draws and the traced
    colours (the keys of renderer._camera_paths, as _render_shard)."""
    st, org, dirn, dx, dy, cp_r12 = rnd._camera_paths(cam, cfg, pix_i, pix_j,
                                                      k, cp_shard)
    color = integrator.trace_paths(
        sc, org, dirn, st, cp_r12, cfg.nb_bounces, bg_pixel=bg_pixel,
        sort_rays=cfg.sort_rays or cfg.compact_rays,
        compact_rays=cfg.compact_rays)[0]
    return color, dx, dy


def make_sharded_render(mesh: Mesh, cfg, film_ratio=None):
    """(scene, camera, cp_table) -> (image, count), the padded film
    accumulators summed over the dp and sp ranks (every rank of the mesh
    returns them).

    A rank renders pixel rows [row0, row0 + H/dp) of its dp coordinate
    over its sp coordinate's contiguous block of sample ids, with the
    cp_table rows of those pixels (cp_table is (H*W, 2), row-major).  A
    scene-axis scene is bound to the mesh's scene group first
    (scene_shard.localize_scene).  Differentiable with respect to the
    scene's material and light tensors (the sum passes the cotangent
    through); with cfg.remat_samples each sample runs under
    torch.utils.checkpoint and is recomputed in backward.  Unlike the JAX
    function, which ignores them, cfg.sort_rays and cfg.compact_rays apply
    as in render_unsplatted (off by default), and so does the camera
    backface gate.  film_ratio is unused (the film is rebuilt here), as in
    JAX."""
    w, h = cfg.width, cfg.height
    dp, sp = mesh.shape['dp'], mesh.shape['sp']
    assert h % dp == 0, f'height {h} must divide dp={dp}'
    assert cfg.nrays % sp == 0, f'nrays {cfg.nrays} must divide sp={sp}'
    rows = h // dp
    spp = cfg.nrays // sp
    has_scene = 'scene' in mesh.shape

    def render(sc, cam, cp_table):
        if mesh.coords is None:
            raise ValueError('this rank is outside the mesh')
        if has_scene:
            from . import scene_shard
            sc = scene_shard.localize_scene(sc, mesh)
        dev = sc.device
        cam = cam.to(dev)
        sc = scn.camera_backface_gate(sc, cam.position.cpu().numpy())
        film = film_mod.make_film(w, h, cfg.sigma_filter, device=dev)
        image, count = film_mod.alloc(film)
        row0 = mesh.coords['dp'] * rows
        ii, jj = torch.meshgrid(torch.arange(row0, row0 + rows, device=dev),
                                torch.arange(w, device=dev), indexing='ij')
        pix_i, pix_j = ii.reshape(-1), jj.reshape(-1)
        cp_shard = cp_table[row0 * w:(row0 + rows) * w].to(dev)
        bg_pixel = rnd._background_pixels(sc, pix_i, pix_j, w, h)
        k0 = mesh.coords['sp'] * spp
        for k in range(k0, k0 + spp):
            args = (sc, cam, cfg, pix_i, pix_j, k, cp_shard, bg_pixel)
            if cfg.remat_samples:
                # the draws are PCG streams of their own, not torch's RNG
                color, dx, dy = checkpoint.checkpoint(
                    _shard_sample, *args, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                color, dx, dy = _shard_sample(*args)
            film_mod.splat(film, image, count, color, dx, dy, row0=row0,
                           block_rows=rows)
        # film partials are identical across 'scene' (every scene rank
        # sees the combined hits), so the sum runs over dp and sp only
        group = mesh.groups['dpsp']
        return pd.group_sum(image, group), pd.group_sum(count, group)

    return render


def make_loss_and_grads(mesh: Mesh, cfg, film_ratio=None):
    """(params, sc, cam, cp_table, target) -> (loss, grads): the loss of
    make_train_step and the gradients of params (dict of kd, ks,
    light_intensity), summed over the dp and sp ranks, so every rank
    holds the whole gradient."""
    render = make_sharded_render(mesh, cfg, film_ratio)
    group = mesh.groups['dpsp']

    def loss_and_grads(params, sc, cam, cp_table, target):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        film = film_mod.make_film(cfg.width, cfg.height, cfg.sigma_filter,
                                  device=sc.device)
        image, count = render(sc.replace(**leaves), cam, cp_table)
        image = film_mod.crop(film, image)
        count = film_mod.crop(film, count)
        hdr = image / film_mod.RADIANCE_SCALE / torch.clamp_min(
            count, 1e-9)[..., None]
        loss = torch.mean((hdr - target) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), {k: pd.group_sum_(g.contiguous(), group)
                               for k, g in zip(leaves, grads)}

    return loss_and_grads


def make_train_step(mesh: Mesh, cfg, film_ratio=None, lr=1e-2):
    """Differentiable-render training step: fit the scene's kd, ks and
    light_intensity to a target image by gradient descent.

    Returns (params, sc, cam, cp_table, target) -> (loss, new_params),
    params = dict(kd, ks, light_intensity).  The loss is the MSE of the
    cropped film's HDR image (image / RADIANCE_SCALE / max(count, 1e-9))
    against target (H, W, 3).  Autograd runs through the sharded render;
    each rank's parameter gradients cover its own rows and samples and are
    summed over the dp and sp ranks (make_loss_and_grads), then every rank
    takes the same SGD step.  The JAX step's gradient does not depend on
    the mesh, and neither does this one."""
    loss_and_grads = make_loss_and_grads(mesh, cfg, film_ratio)

    def step(params, sc, cam, cp_table, target):
        loss, grads = loss_and_grads(params, sc, cam, cp_table, target)
        return loss, {k: params[k] - lr * grads[k] for k in params}

    return step
