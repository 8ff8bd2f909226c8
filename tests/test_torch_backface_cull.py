"""PyTorch port, the cluster tier's backface cull: the cases of
tests/test_backface_cull.py through the port, each against the JAX
package on the same numpy inputs (JAX's Pallas in interpret mode, the
port's plain versions on CPU tensors).

The normal-bound cull may fire only on closed, consistently oriented,
fully opaque meshes, where it is exact for rays from outside.  Here: the
orientation detector, dense-cull hit parity (cull on = cull off bit for
bit, and the cull-on hits against JAX's), the upload gating, the scene
gates, and inside-origin queries that need the flag off.  The
hierarchical-cull parity and the end-to-end render are in
tests/test_torch_backface_render.py.

Hits against JAX's: tri equal on >= 99.9% of lanes, every other lane a
tie within 2^-16 relative t (tests/test_torch_cluster.py), and t within
1e-5 relative plus 1e-5 absolute where tri agrees.  The absolute term is
new beside that file's 1e-6: half the rays here start 1e-3 off the
surface, where t is small and the sweep's plane formula rounds at the
scale of the cluster's centroid offset, not of t (the 1e-5 of
tests/test_torch_tiers.py's sweep against the edge-matrix formula).
"""

import numpy as np
import torch
import jax.numpy as jnp

from pathtracer_tpu.ops import pallas_cluster as pc
from pathtracer_tpu.scene import mesh as jmesh
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.scene import topology as jtp
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.scene import mesh as tmesh
from pathtracer_tpu_torch.scene import scene as tscn
from pathtracer_tpu_torch.scene import topology as ttp
from pathtracer_tpu_torch.sim import fluid as tfluid

from test_torch_cluster import TIE
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)


def assert_hits_match(t_j, tri_j, t_t, tri_t):
    """The module docstring's hit agreement."""
    t_j, tri_j = np.asarray(t_j), np.asarray(tri_j)
    t_t, tri_t = t_t.numpy(), tri_t.numpy()
    same = tri_j == tri_t
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(t_t[same], t_j[same], rtol=1e-5, atol=1e-5)
    diff = ~same
    assert (tri_t[diff] >= 0).all() and (tri_j[diff] >= 0).all()
    assert (np.abs(t_t[diff] - t_j[diff]) <= TIE * np.abs(t_j[diff])).all()


def outside_and_escaping_rays(ct, n, rng, radius=10.0):
    """tests/test_backface_cull.py's rays, traced with the port: half
    from a far shell aimed inward, half bounce-style rays relaunched from
    the first half's hits (offset outward along the geometric normal,
    into the outward hemisphere).  Returns float32 numpy (org, dirn)."""
    o = rng.normal(size=(n, 3))
    o /= np.linalg.norm(o, axis=1, keepdims=True)
    o *= 3.0 * radius
    tgt = rng.normal(size=(n, 3)) * 0.5 * radius
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    m = n // 2
    t, tri = tc.two_level_hit(ct, torch.as_tensor(o[:m], dtype=torch.float32),
                              torch.as_tensor(d[:m], dtype=torch.float32),
                              torch.full((m,), 1e6))
    t, tri = t.numpy(), tri.numpy()
    hitm = tri >= 0
    tv = ct.host_tris[np.maximum(tri, 0)]
    gn = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
    gn[np.sum(gn * d[:m], axis=1) > 0] *= -1.0
    p = o[:m] + t[:, None] * d[:m] + 1e-3 * gn
    nd = gn + 0.8 * rng.normal(size=(m, 3))
    nd /= np.linalg.norm(nd, axis=1, keepdims=True)
    nd[np.sum(nd * gn, axis=1) < 0] *= -1.0
    o[:m] = np.where(hitm[:, None], p, o[:m])
    d[:m] = np.where(hitm[:, None], nd, d[:m])
    return o.astype(np.float32), d.astype(np.float32)


def cull_parity(md, n, seed, min_hits, **build):
    """Port: the closest hits with the cull on equal those with it off,
    and the cull-on hits match JAX's.  Returns the port's mesh, the rays
    and tmax."""
    sign = ttp.closed_orientation(md.vertices, md.vtx_idx)
    assert sign != 0
    tri = md.vertices[md.vtx_idx]
    ct = tc.build_clustered(tri, nrm_sign=float(sign), dev='cpu', **build)
    cj = pc.build_clustered(tri, nrm_sign=float(sign), **build)
    o, d = outside_and_escaping_rays(ct, n, np.random.default_rng(seed))
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    tmax = torch.full((n,), 1e6)
    t0, tri0 = tc.two_level_hit(ct, ot, dt, tmax, backface_cull=False)
    t1, tri1 = tc.two_level_hit(ct, ot, dt, tmax, backface_cull=True)
    assert int((tri0 >= 0).sum()) > min_hits
    np.testing.assert_array_equal(tri0.numpy(), tri1.numpy())
    np.testing.assert_allclose(t0.numpy(), t1.numpy())
    t_j, tri_j, _, _ = pc.two_level_hit(
        cj, jnp.asarray(o), jnp.asarray(d), jnp.full((n,), 1e6, jnp.float32),
        interpret=True, with_bary=False, backface_cull=True)
    assert_hits_match(t_j, tri_j, t1, tri1)
    return ct, ot, dt, tmax


def test_closed_orientation_detector():
    md = procgen.sphere_mesh(32, 32, radius=5.0, displace_amp=0.25)
    terrain = procgen.terrain_mesh(24)
    for v, f, want in ((md.vertices, md.vtx_idx, None),
                       (md.vertices, md.vtx_idx[:, ::-1], 'flipped'),
                       (terrain.vertices, terrain.vtx_idx, 0),
                       (md.vertices, md.vtx_idx[1:], 0)):
        s = ttp.closed_orientation(v, f)
        assert s == jtp.closed_orientation(v, f)
        if want is None:
            assert s in (-1, 1)
            sign = s
        else:
            assert s == (-sign if want == 'flipped' else want)


def test_two_level_hit_backface_parity():
    """Dense cull (< 256 clusters): winners identical with the cull on and
    off, occlusion too, and the cull-on hits equal JAX's."""
    md = procgen.sphere_mesh(64, 64, radius=10.0, displace_amp=0.3)
    ct, ot, dt, tmax = cull_parity(md, 2048, 0, 500)
    assert ct.n_clusters <= tc.HIER_MIN_CLUSTERS
    np.testing.assert_array_equal(
        tc.two_level_any(ct, ot, dt, tmax, backface_cull=False).numpy(),
        tc.two_level_any(ct, ot, dt, tmax, backface_cull=True).numpy())


def test_upload_gating():
    md = procgen.sphere_mesh(48, 48, radius=6.0, displace_amp=0.2)
    alpha = np.zeros((4, 4, 3), np.float32)
    cases = [(md, {}, True), (procgen.terrain_mesh(48), {}, False),
             (md, dict(default_transp=True), False),
             (md, dict(default_ksub=(0.5, 0, 0)), False),
             (md, dict(allow_backface=False), False),
             (md, dict(texture_overrides=[{'alpha': alpha}]), False)]
    for m, kw, want in cases:
        got = tmesh.upload_mesh(m, obj_row=2, use_cluster=True, dev='cpu',
                                **kw).backface_cull
        assert got == want == jmesh.upload_mesh(
            m, obj_row=2, use_cluster=True, **kw).backface_cull, kw


def _gates(mod, md, **build):
    """The scene-gate decisions of tests/test_backface_cull.py in one
    package (`mod`: its scene module)."""
    objs = mod.default_objects()
    objs.append(mod.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    sc = mod.build_scene(objs, mod.default_light_intensity(), **build)
    if mod is jscn:
        m = jmesh.upload_mesh(md, obj_row=sc.meshes[0].obj_row,
                              use_cluster=True)
        sc = sc.replace(meshes=(sc.meshes[0].replace(
            clustered=m.clustered, use_cluster=True,
            n_clusters=m.n_clusters,
            cluster_top_max_leaf=m.cluster_top_max_leaf,
            backface_cull=m.backface_cull),))
    mesh = sc.meshes[0]
    out = [mesh.backface_cull]
    for extra in ([],
                  [mod.sphere((0.0, -15.0, 0.0), 2.0, kd=(1, 0, 0))],
                  [mod.sphere((0.0, -15.0, 0.0), 2.0, ksub=(0.5, 0.2, 0.1))],
                  [mod.sphere((0.0, 40.0, 0.0), 2.0, ksub=(0.5, 0.2, 0.1))]):
        o2 = objs + extra
        trans = np.stack([mod._build_matrices(o)[0] for o in o2])
        out.append(mod._gate_backface_overlap(mesh, o2, trans).backface_cull)
    for cam in ((0.0, -15.0, 0.0), (0.0, 0.0, 50.0)):
        out.append(mod.camera_backface_gate(
            sc, np.asarray(cam)).meshes[0].backface_cull)
    ghost = mod.default_objects()
    ghost.append(mod.mesh_object(md, translation=(0, -15, 0), ghost=True))
    out.append(mod.build_scene(ghost, mod.default_light_intensity(),
                               **build).meshes[0].backface_cull)
    return out


def test_scene_gates():
    """Keeps, keeps (opaque overlap), clears (subsurface overlap), keeps
    (distant subsurface), clears (camera inside), keeps (outside), ghost
    never: the port's decisions equal JAX's and the expected."""
    md = procgen.sphere_mesh(48, 48, radius=6.0, displace_amp=0.2)
    want = [True, True, True, False, True, False, True, False]
    assert _gates(tscn, md, device='cpu') == want
    assert _gates(jscn, md) == want


def test_inside_origin_queries_need_flag_off():
    """Rays from inside a closed mesh see back faces, which the cull
    removes: every ray hits with the cull off, most hits vanish with it
    on (equal to JAX's there), and the fluid's inside test (which casts from
    inside and clears the flag) stays right on the cluster tier."""
    md = procgen.sphere_mesh(180, 180, radius=10.0, displace_amp=0.0)
    sign = ttp.closed_orientation(md.vertices, md.vtx_idx)
    tri = md.vertices[md.vtx_idx]
    ct = tc.build_clustered(tri, nrm_sign=float(sign), tris_c=256,
                            dev='cpu')
    cj = pc.build_clustered(tri, nrm_sign=float(sign), tris_c=256)
    rng = np.random.default_rng(5)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = np.zeros((16, 3), np.float32)
    hits = {bf: tc.two_level_hit(ct, torch.as_tensor(org),
                                 torch.as_tensor(d), torch.full((16,), 1e6),
                                 backface_cull=bf) for bf in (False, True)}
    assert (hits[False][1].numpy() >= 0).all()
    assert (hits[True][1].numpy() < 0).mean() > 0.5
    t_j, tri_j, _, _ = pc.two_level_hit(
        cj, jnp.asarray(org), jnp.asarray(d),
        jnp.full((16,), 1e6, jnp.float32), interpret=True, with_bary=False,
        backface_cull=True)
    np.testing.assert_array_equal(hits[True][1].numpy(), np.asarray(tri_j))
    np.testing.assert_allclose(hits[True][0].numpy(), np.asarray(t_j),
                               rtol=1e-5)
    cfg = tfluid.FluidConfig(lo=(-12, -12, -12), hi=(12, 12, 12),
                             nx=10, ny=10, nz=10)
    objs = tscn.default_objects()
    objs.append(tscn.mesh_object(md))
    inside, _ = tfluid.cells_inside_object(cfg, objs, len(objs) - 1,
                                           device='cpu')
    r = np.linalg.norm(tfluid._cell_centers(cfg), axis=-1)
    assert (inside == (r < 10.0)).mean() > 0.9
