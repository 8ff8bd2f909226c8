"""One rank of the port's multi-process CPU tests (gloo).

    python tests/torch_dist_worker.py SUITE RANK WORLD INIT_FILE OUT_DIR

Joins a gloo group of WORLD processes through a FileStore at INIT_FILE
(parallel.distributed.init_multihost), runs every multi-rank case of
SUITE in one go and writes its results to OUT_DIR/SUITE_r<RANK>.npz,
which the test module reads (tests/test_torch_sharding.py,
test_torch_scene_shard.py, test_torch_distributed.py spawn it once per
module through `spawn`).  Imports torch, numpy and the port only; the
tests build their single-process references from the same helpers
(cluster_scene, train_inputs, hit_inputs) and seeds.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from pathtracer_tpu_torch.core import rng_host  # noqa: E402
from pathtracer_tpu_torch.core.camera import make_camera  # noqa: E402
from pathtracer_tpu_torch.parallel import distributed as pd  # noqa: E402
from pathtracer_tpu_torch.parallel import scene_shard  # noqa: E402
from pathtracer_tpu_torch.parallel import sharding  # noqa: E402
from pathtracer_tpu_torch.render import film as film_mod  # noqa: E402
from pathtracer_tpu_torch.render import renderer as rnd  # noqa: E402
from pathtracer_tpu_torch.scene import mesh as mesh_mod  # noqa: E402
from pathtracer_tpu_torch.scene import scene as scn  # noqa: E402
from pathtracer_tpu_torch.utils import procgen  # noqa: E402

CAM = ((0, 0, 50), (0, 0, -1), (0, 1, 0))
# the sharded render and train step (test_torch_sharding.py)
SH_W, SH_H, SH_SPP, SH_BOUNCES = 16, 8, 2, 2
# the two-rank row render (test_torch_distributed.py, test_multihost.py's)
MH_W, MH_H, MH_SPP = 24, 16, 2
# the scene axis on the card (test_torch_gpu.py)
GPU_LAT, GPU_SIZE = 60, (160, 90)
# the hit forms (test_torch_scene_shard.py)
HIT_LAT, HIT_RAYS, RING_RAYS, ROUTE_BLOCK = 100, 4096, 4095, 1024


def cluster_scene(lat=32, device='cpu'):
    """The default slate and a displaced sphere_mesh(lat, lat) on the
    cluster tier (tests/test_scene_axis_render.py's scene)."""
    md = procgen.sphere_mesh(lat, lat, radius=10.0, displace_amp=0.3)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(md, translation=(0.0, -14.0, 0.0),
                                kd=(0.6, 0.4, 0.3)))
    sc = scn.build_scene(objs, scn.default_light_intensity(), device=device)
    m = mesh_mod.upload_mesh(md, obj_row=sc.meshes[0].obj_row,
                             use_cluster=True, dev=device)
    return sc.replace(meshes=(m,))


def train_inputs(sc):
    """cp table, target image and params of the train-step cases."""
    cp = rng_host.random_per_pixel_fast(SH_W, SH_H)
    target = np.random.default_rng(5).uniform(
        0.0, 1.0, (SH_H, SH_W, 3)).astype(np.float32)
    params = dict(kd=sc.kd, ks=sc.ks, light_intensity=sc.light_intensity)
    return cp, target, params


def sh_cfg():
    return rnd.RenderConfig(width=SH_W, height=SH_H, nrays=SH_SPP,
                            nb_bounces=SH_BOUNCES)


def hit_inputs():
    """A ~20k-triangle sphere and HIT_RAYS rays toward it from a seed."""
    md = procgen.sphere_mesh(HIT_LAT, HIT_LAT, radius=8.0, displace_amp=0.4)
    tris = md.vertices[md.vtx_idx]
    rng = np.random.default_rng(11)
    org = rng.uniform(-14, 14, (HIT_RAYS, 3)).astype(np.float32)
    d = -org + rng.normal(0, 3, (HIT_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tris.astype(np.float32), org, d.astype(np.float32)


def run_sharding(rank, out):
    sc = cluster_scene()
    cam = make_camera(*CAM)
    cp, target, params = train_inputs(sc)
    cp, target = torch.as_tensor(cp), torch.as_tensor(target)
    cfg = sh_cfg()
    for name, kw in (('dp2sp2', dict(dp=2, sp=2)), ('dp4', dict(dp=4)),
                     ('dp2', dict(n_devices=2, dp=2))):
        mesh = sharding.make_mesh(**kw)
        if mesh.coords is None:
            continue
        if name == 'dp2sp2':
            img, cnt = sharding.make_sharded_render(mesh, cfg)(sc, cam, cp)
            out['render_image'], out['render_count'] = img.numpy(), cnt.numpy()
            loss, new = sharding.make_train_step(mesh, cfg, lr=1e-2)(
                params, sc, cam, cp, target)
            out['step_loss'] = float(loss)
            for k, v in new.items():
                out[f'step_{k}'] = v.numpy()
        loss, grads = sharding.make_loss_and_grads(mesh, cfg)(
            params, sc, cam, cp, target)
        out[f'{name}_loss'] = float(loss)
        for k, g in grads.items():
            out[f'{name}_grad_{k}'] = g.numpy()


def run_scene_shard(rank, out):
    mesh = sharding.make_mesh(dp=1, scene=2)
    tris, org, d = hit_inputs()
    org_t, d_t = torch.as_tensor(org), torch.as_tensor(d)
    sm = scene_shard.partition_mesh(tris, 2, device='cpu')
    out['sharded_t'], out['sharded_tri'] = (
        x.numpy() for x in scene_shard.make_sharded_hit(mesh)(sm, org_t, d_t))
    sb = scene_shard.partition_mesh_bvh(tris, 2, device='cpu')
    out['routed_t'], out['routed_tri'] = (
        x.numpy() for x in scene_shard.make_routed_hit(
            mesh, sb.max_leaf, block=ROUTE_BLOCK)(sb, org_t, d_t))
    out['ring_t'], out['ring_tri'] = (
        x.numpy() for x in scene_shard.make_ring_hit(mesh, sb.max_leaf)(
            sb, org_t[:RING_RAYS], d_t[:RING_RAYS]))
    cam = make_camera(*CAM)
    cfg = sh_cfg()
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(SH_W, SH_H))
    render = sharding.make_sharded_render(mesh, cfg)
    for name, lat in (('scene', 32), ('tiny', 12)):
        sc = cluster_scene(lat)
        shards = scene_shard.shard_clustered_mesh(sc.meshes[0], 2)
        out[f'{name}_rows'] = np.array([s.shard_rows for s in shards])
        img, cnt = render(sc.replace(meshes=(shards[rank],)), cam, cp)
        out[f'{name}_image'], out[f'{name}_count'] = img.numpy(), cnt.numpy()


def run_distributed(rank, out):
    mesh = pd.global_mesh(sp=1)
    out['dp'] = mesh.shape['dp']
    sc = scn.build_scene(scn.default_objects(),
                         scn.default_light_intensity(), device='cpu')
    cfg = rnd.RenderConfig(width=MH_W, height=MH_H, nrays=MH_SPP,
                           nb_bounces=2, samples_per_wave=MH_SPP)
    film = film_mod.make_film(MH_W, MH_H, cfg.sigma_filter, device='cpu')
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(MH_W, MH_H))
    image, count = sharding.make_sharded_render(mesh, cfg)(
        sc, make_camera(*CAM), cp)
    image = film_mod.crop(film, image)
    count = film_mod.crop(film, count)
    # host-local assembly: keep this rank's rows, rebuild the image
    row0, row1, _ = pd.host_shard_rows(MH_H, mesh)
    out['rows'] = np.array([row0, row1])
    out['image'] = pd.assemble_rows(image[row0:row1].clone(), mesh).numpy()
    out['count'] = pd.assemble_rows(count[row0:row1].clone(), mesh).numpy()
    out['reassembled_equal'] = bool(np.array_equal(out['image'],
                                                   image.numpy()))
    out['ckpt'] = pd.checkpoint_path('/x/ck.npz')


def run_gpu_scene(rank, out):
    """The scene axis on the card: two processes share it over gloo."""
    mesh = sharding.make_mesh(dp=1, scene=2)
    sc = cluster_scene(GPU_LAT, device='cuda')
    shard = scene_shard.shard_clustered_mesh(sc.meshes[0], 2)[rank]
    w, h = GPU_SIZE
    cfg = rnd.RenderConfig(width=w, height=h, nrays=1, nb_bounces=2)
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(w, h), device='cuda')
    with torch.no_grad():
        img, cnt = sharding.make_sharded_render(mesh, cfg)(
            sc.replace(meshes=(shard,)), make_camera(*CAM), cp)
    out['image'], out['count'] = img.cpu().numpy(), cnt.cpu().numpy()


SUITES = {'sharding': run_sharding, 'scene_shard': run_scene_shard,
          'distributed': run_distributed, 'gpu_scene': run_gpu_scene}


def main():
    suite, rank, world, init_file, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    got = pd.init_multihost(f'file://{init_file}', world, rank,
                            backend='gloo')
    assert got == (rank, world), got
    out = {}
    SUITES[suite](rank, out)
    np.savez(os.path.join(out_dir, f'{suite}_r{rank}.npz'), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f'rank {rank}: ok', flush=True)


if __name__ == '__main__':
    main()


def spawn(suite, world, out_dir, timeout=180):
    """Run SUITE in WORLD worker processes; returns each rank's results
    (dicts of numpy arrays).  Each process is waited for at most
    `timeout` s, so a hung collective fails the test instead of the
    suite; on any failure every process is killed."""
    import subprocess
    init = os.path.join(out_dir, f'{suite}.init')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(r), str(world),
         init, out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f'rank {r} failed:\n{log[-4000:]}'
    return [dict(np.load(os.path.join(out_dir, f'{suite}_r{r}.npz')))
            for r in range(world)]
