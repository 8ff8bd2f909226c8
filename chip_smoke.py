"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

1. Refuses to run without a CUDA device (no CPU fallback); prints the
   torch version and the card's name and power limit.
2. Builds the hand-written CUDA kernels (csrc/cluster_sweep.cu) with nvcc
   and prints the build time and the ptxas report.
3. Kernel phase: the bench's 2.4M-triangle displaced sphere, 1080p primary
   rays and one batch of shadow rays from their hits to the light.  Each
   kernel runs on the whole first-round cull output at those shapes and is
   held against its plain PyTorch version: tri equal on >= 99.9% of lanes,
   every other lane a tie within 2^-16 relative t, t within 1e-5 relative
   on equal lanes; occlusion equal on >= 99.9% of lanes.  Both are timed
   with CUDA events.
4. Reference phase: a 64x48 render of the 2k-triangle mesh scene through
   the kernels on the card against the plain versions on the CPU, per
   sample with the boundary-flip allowance of the CPU tests.
5. Main path: Renderer on the 2.4M-triangle scene at 1920x1080, 3
   bounces, one sample per wave, compaction on; one warm-up wave, two
   timed waves.  Both kernels' launch counters must rise; the image must
   be finite and lit.

Every failure raises.  The last three lines are the card line, the
kernel JSON and the contract line.
"""

import json
import subprocess
import sys
import time

import numpy as np

W, H, BOUNCES = 1920, 1080, 3
TIE = 2.0 ** -16


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=1):
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    import torch
    fn()                                    # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_hits(t_p, tri_p, t_k, tri_k):
    """Closest-hit agreement of kernel (k) with plain version (p)."""
    same = tri_p == tri_k
    frac = float(same.float().mean())
    if frac < 0.999:
        raise AssertionError(f'tri agrees on only {frac:.5f} of lanes')
    d = ~same
    if bool(((tri_p[d] < 0) | (tri_k[d] < 0)).any()):
        raise AssertionError('a lane hit in one version and missed in the '
                             'other')
    if bool(((t_k[d] - t_p[d]).abs() > TIE * t_p[d].abs()).any()):
        raise AssertionError('differing tri beyond the 2^-16 tie allowance')
    hit = same & (tri_p >= 0)
    err = (t_k[hit] - t_p[hit]).abs()
    if bool((err > 1e-5 * t_p[hit].abs() + 1e-6).any()):
        raise AssertionError('t differs beyond 1e-5 relative')
    return frac, float(err.max()) if err.numel() else 0.0


def big_scene(dev):
    from pathtracer_tpu_torch.scene import scene as scn
    from pathtracer_tpu_torch.utils import procgen
    md = procgen.sphere_mesh(1100, 1100, radius=14.0, displace_amp=0.25)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    return scn.build_scene(objs, scn.default_light_intensity(),
                           device=dev), md.num_triangles


def primary_rays(cam, dev):
    """1080p camera rays in the renderer's 32x32 tile order, sample 0."""
    import torch
    from pathtracer_tpu_torch.render import renderer as rnd
    cfg = rnd.RenderConfig(width=W, height=H, nrays=1)
    pix_i, pix_j, _ = rnd._pixel_order(W, H, 32, dev)
    cp = torch.zeros((W * H, 2), device=dev)
    _, org, dirn, _, _, _ = rnd._camera_paths(cam, cfg, pix_i, pix_j, 0, cp)
    return org, dirn


def kernel_phase(sc, cam, dev):
    import torch
    from pathtracer_tpu_torch.ops import cluster as cl
    from pathtracer_tpu_torch.scene import scene as scn
    mesh = sc.meshes[0]
    cm = mesh.clustered
    org, dirn = primary_rays(cam, dev)
    # the mesh query of the main path: mesh-local rays pruned by the
    # analytic closest hit
    t_all = scn._candidate_ts(sc, org, dirn)[0]
    tmax0 = t_all.amin(dim=-1)
    org_l, dir_l = scn._local_ray_row(sc, mesh.obj_row, org, dirn)

    def first_round(o, d, tmax):
        o, d, tmax, tmin = cl._prepare(cm, o, d, tmax, None)
        tx = cl.root_exit_clamp(cm.bounds, o, d, tmax)
        chunks = []
        for sl in cl._chunks(o.shape[0]):
            ids, counts, keys, _ = cl._cull(
                cm, o[sl], d[sl], tx[sl],
                cm.nrm if mesh.backface_cull else None)
            chunks.append((ids, counts, keys, o[sl], d[sl], tx[sl], tmin[sl]))
        return chunks

    results = []
    # ---- closest hit ----
    chunks = first_round(org_l, dir_l, tmax0)
    n_packets = sum(c[0].shape[0] for c in chunks)

    def run(fn):
        return [fn(cm, *c) for c in chunks]

    out_k = run(cl.cluster_sweep)
    out_p = run(cl.cluster_sweep_plain)
    torch.cuda.synchronize()
    t_k = torch.cat([o[0] for o in out_k])
    tri_k = torch.cat([o[1] for o in out_k])
    t_p = torch.cat([o[0] for o in out_p])
    tri_p = torch.cat([o[1] for o in out_p])
    frac, err = check_hits(t_p, tri_p, t_k, tri_k)
    ms_k = cuda_ms(lambda: run(cl.cluster_sweep), reps=3)
    ms_p = cuda_ms(lambda: run(cl.cluster_sweep_plain), reps=1)
    log(f'closest sweep: {n_packets} packets, tri agreement {frac:.6f}, '
        f'max |dt| {err:.3g}, kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms')
    results.append(dict(
        name='cluster_sweep_closest', route='cuda',
        source='pathtracer_tpu_torch/csrc/cluster_sweep.cu',
        replaces='pathtracer_tpu/ops/pallas_cluster.py:668',
        max_abs_err=err, agree=frac, ms=ms_k, plain_ms=ms_p,
        packets=n_packets))

    # ---- shadow rays from the primary hits to the light ----
    n0 = org_l.shape[0]
    hit = tri_k[:n0] >= 0
    p = org_l + t_k[:n0, None] * dir_l
    rng = np.random.default_rng(0)
    jit = torch.as_tensor(rng.normal(size=(n0, 3)).astype(np.float32),
                          device=dev)
    light = (sc.center_light - sc.trans[mesh.obj_row, [3, 7, 11]]
             + 0.5 * sc.radius_light * jit)
    to_l = light - p
    dist = to_l.norm(dim=1)
    wi = to_l / dist[:, None]
    s_org = p + 0.01 * wi
    limit = torch.where(hit, (dist - 0.01) * 0.999, torch.zeros_like(dist))
    chunks = first_round(s_org, wi, limit)
    occ_k = torch.cat(run(cl.cluster_sweep_any))
    occ_p = torch.cat(run(cl.cluster_sweep_any_plain))
    torch.cuda.synchronize()
    agree = float((occ_k == occ_p).float().mean())
    if agree < 0.999:
        raise AssertionError(f'occlusion agrees on only {agree:.5f}')
    live = occ_p[:n0][hit]
    ms_k = cuda_ms(lambda: run(cl.cluster_sweep_any), reps=3)
    ms_p = cuda_ms(lambda: run(cl.cluster_sweep_any_plain), reps=1)
    log(f'shadow sweep: occlusion agreement {agree:.6f}, occluded share of '
        f'hit lanes {float(live.float().mean()):.3f}, kernel {ms_k:.3f} ms, '
        f'plain {ms_p:.3f} ms')
    results.append(dict(
        name='cluster_sweep_any', route='cuda',
        source='pathtracer_tpu_torch/csrc/cluster_sweep.cu',
        replaces='pathtracer_tpu/ops/pallas_cluster.py:885',
        max_abs_err=float((occ_k != occ_p).float().max()), agree=agree,
        ms=ms_k, plain_ms=ms_p))
    return results


def reference_phase():
    """Kernels on the card against plain versions on the CPU, per sample."""
    import torch
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.core import rng_host
    from pathtracer_tpu_torch.render import renderer as rnd
    from pathtracer_tpu_torch.scene import scene as scn
    from pathtracer_tpu_torch.utils import procgen
    md = procgen.sphere_mesh(32, 32, radius=12.0, displace_amp=0.25)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    w, h = 64, 48
    cfg = rnd.RenderConfig(width=w, height=h, nrays=2, nb_bounces=BOUNCES,
                           compact_rays=True)
    cp = rng_host.random_per_pixel_fast(w, h)
    out = {}
    for dev in ('cuda', 'cpu'):
        sc = scn.build_scene(objs, scn.default_light_intensity(), device=dev)
        cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0)).to(dev)
        _, smp = rnd.render_unsplatted(sc, cam, torch.as_tensor(cp,
                                                                device=dev),
                                       cfg)
        out[dev] = smp.cpu().numpy()
    if not np.isfinite(out['cuda']).all():
        raise AssertionError('non-finite samples on the card')
    scale = max(np.abs(out['cpu']).max(), 1e-6)
    rel = np.abs(out['cuda'] - out['cpu']).max(-1) / scale
    flipped = rel > 1e-3
    mean_rel = abs(out['cuda'].mean() - out['cpu'].mean()) / scale
    log(f'reference 64x48x2spp vs CPU plain path: flipped '
        f'{flipped.mean():.5f}, unflipped max rel {rel[~flipped].max():.3g},'
        f' mean rel {mean_rel:.3g}')
    if flipped.mean() >= 0.05 or rel[~flipped].max() >= 1e-3 \
            or mean_rel >= 0.02:
        raise AssertionError('card render disagrees with the CPU reference')


def main_path(sc, cam, card):
    import torch
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.ops import cluster as cl
    cfg = pt.RenderConfig(width=W, height=H, nrays=8, nb_bounces=BOUNCES,
                          samples_per_wave=1, compact_rays=True)
    r = pt.Renderer(sc, cam, cfg)
    cl.cluster_sweep.launches = 0
    cl.cluster_sweep_any.launches = 0
    r.step()                                    # warm-up wave
    torch.cuda.synchronize()
    rays0 = r.rays_traced
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    r.step()
    r.step()
    stop.record()
    torch.cuda.synchronize()
    launches = {'cluster_sweep_closest': cl.cluster_sweep.launches,
                'cluster_sweep_any': cl.cluster_sweep_any.launches}
    ms_wave = start.elapsed_time(stop) / 2
    live = r.rays_traced - rays0
    img = r.display().cpu().numpy()
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError('image not finite / wrong shape')
    # the mesh (world y in [-29, -1], centred in x) covers the lower middle
    region = img[int(H * 0.55):int(H * 0.9), int(W * 0.4):int(W * 0.6)]
    if not region.std() > 0.05 or not region.mean() > 0.02:
        raise AssertionError(f'mesh region not lit: mean {region.mean():.4f}'
                             f' std {region.std():.4f}')
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f'{name} never launched on the main path')
    log(f'main path 1080p x 2.4M tris, 3 bounces, compaction: '
        f'{ms_wave:.1f} ms/wave, {live / (2 * ms_wave / 1e3):.4g} live '
        f'rays/s ({card}); launches {launches}; mesh region mean '
        f'{region.mean():.3f} std {region.std():.3f}')
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py needs a CUDA device; none found')
    log(f'python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda}')
    card = card_line()
    log(card)
    dev = torch.device('cuda:0')
    from pathtracer_tpu_torch.ops import cluster as cl
    import pathtracer_tpu_torch as pt

    t0 = time.perf_counter()
    cl.load_kernels(log=log)
    log(f'kernel build {time.perf_counter() - t0:.1f} s')

    t0 = time.perf_counter()
    sc, n_tris = big_scene(dev)
    log(f'scene build {time.perf_counter() - t0:.1f} s: {n_tris} tris, '
        f'{sc.meshes[0].n_clusters} clusters, backface cull '
        f'{sc.meshes[0].backface_cull}')
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0)).to(dev)

    kernels = kernel_phase(sc, cam, dev)
    reference_phase()
    launches = main_path(sc, cam, card)
    for k in kernels:
        k['launches'] = launches[k['name']]
    log(card)
    log(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
