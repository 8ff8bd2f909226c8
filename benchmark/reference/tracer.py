"""Plain PyTorch path tracer: the reference that decides `correct`.

The renderer's documented semantics, stated path by path and vectorised
over a batch of paths: camera rays through a thin lens (Raytracer.cpp's
generateDirection), then per bounce the closest hit, next-event
estimation to the spherical light with a shadow ray, mirror reflection,
Fresnel-weighted reflection or refraction by one draw, and the Phong
mixture of a cosine and a specular lobe for the indirect ray, taking the
rotated lattice point as its 2D sample; paths whose throughput has
squared norm below 1e-4 end.  Draw order per path: four camera draws,
then per bounce two NEE draws (diffuse hits), the Fresnel draw
(transparent hits), the lobe choice (diffuse hits).  Gradients follow the
detached-sampling estimator: the sampled indirect direction and its pdf
are constants.

Scope: what the configuration files of this benchmark state (spheres,
planes, one mesh, Phong materials, mirrors, glass, no texture, medium,
subsurface or environment map); scene.build_scene refuses anything else.
Nothing here imports the program: no weights, tables or orders of it are
read.  `dtype` runs the whole reference in another float type (the
control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import pcg
from . import scene as scn

M_PI = float(np.float32(np.pi))
M_TWO_PI = float(np.float32(2.0 * np.pi))
TWO_PI = 6.283185307179586
WEIGHT_CULL = 1e-4
RADIANCE_SCALE = float(np.float32(196964.7))


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def normalize(a):
    return a / torch.sqrt(torch.clamp_min(dot(a, a), 1e-20))[..., None]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def tangent(n):
    """Zero the smallest |component| and swap the other two with one sign
    change (ties: x before y before z)."""
    a = n.abs()
    xm = (a[..., 0] <= a[..., 1]) & (a[..., 0] <= a[..., 2])
    ym = ~xm & (a[..., 1] <= a[..., 2])
    z = torch.zeros_like(n[..., 0])
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    t = torch.where(xm[..., None], torch.stack([z, -nz, ny], -1),
                    torch.where(ym[..., None], torch.stack([-nz, z, nx], -1),
                                torch.stack([-ny, nx, z], -1)))
    return normalize(t)


def around(n, lz, lx, ly):
    t1 = tangent(n)
    t2 = cross(t1, n)
    return lz[..., None] * n + lx[..., None] * t1 + ly[..., None] * t2


def random_cos(n, r1, r2):
    s = torch.sqrt(torch.clamp_min(1.0 - r2, 0.0))
    return around(n, torch.sqrt(torch.clamp_min(r2, 0.0)),
                  torch.cos(TWO_PI * r1) * s, torch.sin(TWO_PI * r1) * s)


def random_phong(r, e, r1, r2):
    z = torch.pow(torch.clamp_min(r2, 1e-38), 1.0 / (e + 1.0))
    f = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return around(r, z, torch.cos(TWO_PI * r1) * f, torch.sin(TWO_PI * r1) * f)


def phong(kd, ks, ne, wi, wo, n):
    """kd / pi plus, where the mirror of wo is within 90 degrees of wi,
    ks (ne + 2) / (2 pi) cos^ne."""
    c = dot(reflect(-wo, n), wi)
    front = c > 0
    lobe = torch.pow(torch.where(front, c, torch.ones_like(c))[..., None],
                     ne) * (ne + 2.0) / M_TWO_PI
    diffuse = kd / M_PI
    return torch.where(front[..., None], diffuse + lobe * ks, diffuse)


class Camera:
    def __init__(self, cfg: dict, device, dtype=torch.float32):
        c = cfg['camera']

        def f(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        self.pos = f(c['position'])
        self.dir = normalize(f(c['direction']))
        self.up = normalize(f(c['up']))
        self.fov = f(c['fov_deg'] * math.pi / 180.0)
        self.focus = f(c['focus_distance'])
        self.aperture = f(c['aperture'])
        self.dtype = dtype

    def rays(self, i, j, u, w: int, h: int):
        """Primary rays of sensor rows i, columns j from the four camera
        draws u = (dx, dy, lens x, lens y) uniforms."""
        dt = self.dtype
        pos, dirn, up = (x.to(dt) for x in (self.pos, self.dir, self.up))
        k = (w / (2.0 * torch.tan(self.fov / 2.0))).to(dt)
        right = cross(dirn, up)
        dx, dy = u[0] - 0.5, u[1] - 0.5
        ax = (u[2] - 0.5) * self.aperture.to(dt)
        ay = (u[3] - 0.5) * self.aperture.to(dt)
        v = normalize(torch.stack([j.to(dt) - w / 2.0 + 0.5 + dx,
                                   i.to(dt) - h / 2.0 + 0.5 + dy,
                                   k.expand(i.shape)], -1))
        wd = v[:, 0:1] * right + v[:, 1:2] * up + v[:, 2:3] * dirn
        dest = pos + self.focus.to(dt) / dot(wd, dirn).abs()[:, None] * wd
        org = pos + ax[:, None] * right + ay[:, None] * up
        return org, normalize(dest - org), dx, dy


def trace(sc: scn.Scene, org, dirn, st: pcg.Streams, cp, bounces: int,
          dtype=torch.float32):
    """Radiance (N, 3) of paths starting at (org, dirn), their streams past
    the camera draws, and their (N, 2) rotated lattice samples."""
    n = org.shape[0]
    dev = org.device
    w = torch.ones((n, 3), device=dev, dtype=dtype)
    color = torch.zeros((n, 3), device=dev, dtype=dtype)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    show_light = torch.ones_like(alive)
    power = sc.light_intensity
    lc, lr = sc.light_center, sc.light_radius
    one = torch.ones(n, device=dev, dtype=dtype)
    for _ in range(bounces):
        alive = alive & (dot(w, w) >= WEIGHT_CULL)
        h = scn.intersect(sc, org, dirn)
        hit = alive & h['hit']
        p, nrm, obj = h['p'], h['n'], h['obj']
        at_light = hit & (obj == 0)
        surf = hit & (obj >= 2)
        mirror = surf & h['miroir']
        glass = surf & h['transp'] & ~h['miroir']
        diffuse = surf & ~h['miroir'] & ~h['transp']
        kd, ks, ne = h['kd'], h['ks'], h['ne']

        # next-event estimation toward a point on the light's near cap
        u1 = st.uniform(diffuse, dtype)
        u2 = st.uniform(diffuse, dtype)
        axis = normalize(p - lc)
        on_light = random_cos(axis, u1, u2)
        to_l = (on_light * lr + lc) - p
        d2 = dot(to_l, to_l)
        wi = normalize(to_l)
        cos_s = dot(nrm, wi)
        lim = torch.where(diffuse & (cos_s >= 0),
                          torch.sqrt(d2) - 0.01, torch.zeros_like(d2))
        blocked = scn.occluded(sc, p + 0.01 * wi, wi, lim * 0.999)
        jac = dot(on_light, -wi) / torch.clamp_min(d2, 1e-12)
        pdf_l = dot(axis, on_light) / (M_PI * lr * lr)
        nee = (power * torch.clamp_min(cos_s, 0.0) * jac
               / torch.where(pdf_l > 0, pdf_l, one))[:, None] \
            * phong(kd, ks, ne, wi, -dirn, nrm)
        nee_ok = diffuse & (cos_s >= 0) & ~blocked & (pdf_l > 0)
        color = color + torch.where((at_light & show_light)[:, None],
                                    w * power, torch.zeros_like(w))
        color = color + torch.where(nee_ok[:, None], w * nee,
                                    torch.zeros_like(w))

        # glass: reflect or refract by the Fresnel term
        uf = st.uniform(glass, dtype)
        cos_in = dot(dirn, nrm)
        out = cos_in > 0
        n1 = torch.where(out, h['refr'], one)
        n2 = torch.where(out, one, h['refr'])
        nt = torch.where(out[:, None], -nrm, nrm)
        eta = n1 / n2
        ct = dot(nt, dirn)
        rad = 1.0 - eta * eta * (1.0 - ct * ct)
        rdir = eta[:, None] * (dirn - ct[:, None] * nt) \
            - nt * torch.sqrt(torch.clamp_min(rad, 0.0))[:, None]
        r0 = ((n1 - n2) / (n1 + n2)) ** 2
        c5 = torch.where(out, 1.0 - dot(rdir, nrm), 1.0 + cos_in)
        fres = r0 + (1.0 - r0) * torch.pow(torch.clamp_min(c5, 0.0), 5.0)
        refl = (rad <= 0) | (uf < fres)
        g_dir = torch.where(refl[:, None], reflect(dirn, nrm), rdir)
        g_org = torch.where(refl[:, None], p + 0.001 * nt, p - 0.001 * nt)

        # diffuse: the Phong mixture, sampled with the lattice point
        uc = st.uniform(diffuse, dtype)
        mir = reflect(dirn, nrm)
        pd = 1.0 - ks.mean(-1)
        e = ne.mean(-1)
        take_d = uc < pd
        idir = torch.where(take_d[:, None],
                           random_cos(nrm, cp[:, 0], cp[:, 1]),
                           random_phong(mir, e, cp[:, 0], cp[:, 1]))
        ipdf = pd * dot(nrm, idir) / M_PI + (1.0 - pd) * (
            (e + 1.0) / M_TWO_PI
            * torch.pow(torch.clamp_min(dot(mir, idir), 0.0), e))
        idir, ipdf = idir.detach(), ipdf.detach()
        reject = (dot(idir, nrm) < 0) | (dot(idir, mir) < 0) | (ipdf <= 0)
        iw = w * phong(kd, ks, ne, idir, -dirn, nrm) * (
            dot(nrm, idir) / torch.where(ipdf > 0, ipdf, one))[:, None]
        cont = diffuse & ~reject

        nxt = mirror | glass | cont
        new_org = torch.where(mirror[:, None], p + 0.001 * nrm,
                              torch.where(glass[:, None], g_org,
                                          p + 0.01 * idir))
        new_dir = torch.where(mirror[:, None], mir,
                              torch.where(glass[:, None], g_dir, idir))
        org = torch.where(nxt[:, None], new_org, org)
        dirn = torch.where(nxt[:, None], new_dir, dirn)
        w = torch.where((nxt & cont)[:, None], iw, w)
        show_light = show_light & ~cont
        alive = nxt
    return color


def lane_of(i, j, w: int, h: int, tile: int):
    """Lane index of sensor pixel (i, j) in the renderer's order: row-major,
    or tiles of about tile x tile pixels (the divisors of h and w nearest
    to it) walked row-major, each tile row-major."""
    if tile <= 0:
        return i * w + j

    def near(n):
        best = 1
        for d in range(1, min(n, 2 * tile) + 1):
            if n % d == 0 and abs(d - tile) < abs(best - tile):
                best = d
        return best

    th, tw = near(h), near(w)
    if th == 1 and tw == 1:
        return i * w + j
    return (((i // th) * (w // tw) + j // tw) * th + i % th) * tw + j % tw


def path_colors(sc, cam, cfg: dict, seed: int, i, j, k, tile: int,
                dtype=torch.float32, batch: int = 1 << 16):
    """Radiance and jitter (dx, dy) of paths (sensor row i, column j,
    sample k) of a render with seed `seed`: (N, 3), (N,), (N,)."""
    w, h = cfg['resolution']
    dev = i.device
    cp_all = torch.as_tensor(
        pcg.cp_shifts(lane_of(i, j, w, h, tile).cpu().numpy()), device=dev)
    cols, dxs, dys = [], [], []
    for s0 in range(0, i.shape[0], batch):
        sl = slice(s0, s0 + batch)
        ii, jj, kk = i[sl], j[sl], k[sl]
        st = pcg.Streams(seed, (ii * w + jj) * cfg['spp'] + kk)
        u = [st.uniform(None, dtype) for _ in range(4)]
        org, dirn, dx, dy = cam.rays(ii, jj, u, w, h)
        lat = torch.stack([pcg.lattice(int(x), dev) for x in range(
            int(kk.max()) + 1)])[kk]
        cp = torch.remainder(lat + cp_all[sl], 1.0).to(dtype)
        cols.append(trace(sc, org, dirn, st, cp, cfg['bounces'], dtype))
        dxs.append(dx)
        dys.append(dy)
    return torch.cat(cols), torch.cat(dxs), torch.cat(dys)


def film_ratio(w: int, h: int, sigma: float) -> np.ndarray:
    """(h, w) float32 border normalisation: 1 / the product of the in-image
    1D Gaussian tap sums of the pixel's row and column."""
    fs = int(math.ceil(sigma * 2.0))
    offs = np.arange(-fs, fs + 1, dtype=np.float64)
    f1 = np.exp(-offs ** 2 / (2.0 * sigma * sigma)) / (
        math.sqrt(2.0 * math.pi) * sigma)

    def sums(n):
        idx = np.arange(n)
        lo = np.maximum(0, idx - fs) - idx + fs
        hi = np.minimum(idx + fs, n - 1) - idx + fs
        c = np.concatenate([[0.0], np.cumsum(f1)])
        return c[hi + 1] - c[lo]

    return (1.0 / np.outer(sums(h), sums(w))).astype(np.float32)


def film_pixels(sc, cam, cfg: dict, seed: int, rows, cols, tile: int,
                dtype=torch.float32):
    """HDR values (P, 3), float64, of image pixels (rows, cols) of one
    image of cfg['spp'] samples rendered with `seed`: every sample of every
    pixel within the filter's reach, splatted with the Gaussian weight
    exp(-((di - dy)^2 + (dj - dx)^2) / (2 sigma^2)) times the source
    pixel's border ratio, divided by the summed weights.  Image row r is
    sensor row h - 1 - r."""
    w, h = cfg['resolution']
    sigma = cfg['sigma_filter']
    fs = int(math.ceil(sigma * 2.0))
    dev = sc.kd.device
    spp = cfg['spp']
    src = {}
    for r, c in zip(rows.tolist(), cols.tolist()):
        for y in range(max(0, r - fs), min(h, r + fs + 1)):
            for x in range(max(0, c - fs), min(w, c + fs + 1)):
                src.setdefault((y, x), len(src))
    keys = list(src)
    ys = torch.tensor([k[0] for k in keys], device=dev)
    xs = torch.tensor([k[1] for k in keys], device=dev)
    ii = (h - 1 - ys).repeat_interleave(spp)
    jj = xs.repeat_interleave(spp)
    kk = torch.arange(spp, device=dev).repeat(len(keys))
    col, dx, dy = path_colors(sc, cam, cfg, seed, ii, jj, kk, tile, dtype)
    col = col.double().view(len(keys), spp, 3)
    dx = dx.double().view(len(keys), spp)
    dy = dy.double().view(len(keys), spp)
    ratio = torch.as_tensor(film_ratio(w, h, sigma), device=dev).double()
    base = 1.0 / (sigma * sigma * 2.0 * math.pi)
    out = torch.zeros((len(rows), 3), dtype=torch.float64, device=dev)
    for n, (r, c) in enumerate(zip(rows.tolist(), cols.tolist())):
        num = torch.zeros(3, dtype=torch.float64, device=dev)
        den = torch.zeros((), dtype=torch.float64, device=dev)
        for y in range(max(0, r - fs), min(h, r + fs + 1)):
            for x in range(max(0, c - fs), min(w, c + fs + 1)):
                s = src[(y, x)]
                wt = torch.exp(-(((y - r) - dy[s]) ** 2 + ((c - x) - dx[s])
                                 ** 2) / (2.0 * sigma * sigma)) \
                    * ratio[h - 1 - y, x] * base
                num = num + (wt[:, None] * col[s]).sum(0)
                den = den + wt.sum()
        out[n] = num / RADIANCE_SCALE / torch.clamp_min(den, 1e-9)
    return out


def mean_image_grad(sc: scn.Scene, cam, cfg: dict, leaves: dict,
                    dtype=torch.float32, samples_per_pass: int = 4):
    """The mean over pixels, channels and samples of an unfiltered
    cfg['spp'] render with seed cfg['seed'] (row-major lanes), and its
    gradient with respect to the scene fields named in `leaves` (name to
    tensor), `samples_per_pass` samples at a time so that one pass's graph
    is alive at a time.  Returns (loss float64, {name: grad float64})."""
    w, h = cfg['resolution']
    spp = cfg['spp']
    dev = sc.kd.device
    ii = torch.arange(h, device=dev).repeat_interleave(w)
    jj = torch.arange(w, device=dev).repeat(h)
    cp_tab = torch.as_tensor(pcg.cp_shifts(np.arange(w * h)), device=dev)
    loss = 0.0
    grads = {k: torch.zeros(v.shape, dtype=torch.float64, device=dev)
             for k, v in leaves.items()}
    for k0 in range(0, spp, samples_per_pass):
        ks = range(k0, min(k0 + samples_per_pass, spp))
        lv = {name: v.detach().to(dtype).requires_grad_()
              for name, v in leaves.items()}
        s = sc.replace(**lv)
        kk = torch.tensor(list(ks), device=dev).repeat_interleave(w * h)
        pi, pj = ii.repeat(len(ks)), jj.repeat(len(ks))
        st = pcg.Streams(cfg['seed'], (pi * w + pj) * spp + kk)
        u = [st.uniform(None, dtype) for _ in range(4)]
        org, dirn, _, _ = cam.rays(pi, pj, u, w, h)
        lat = torch.stack([pcg.lattice(k, dev) for k in ks])
        cp = torch.remainder(lat.repeat_interleave(w * h, 0)
                             + cp_tab.repeat(len(ks), 1), 1.0).to(dtype)
        col = trace(s, org, dirn, st, cp, cfg['bounces'], dtype)
        part = col.double().sum() / (w * h * 3 * spp)
        g = torch.autograd.grad(part, list(lv.values()), allow_unused=True)
        loss += float(part.detach())
        for name, gi in zip(lv, g):
            if gi is not None:
                grads[name] += gi.double()
    return loss, grads
