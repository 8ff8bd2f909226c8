"""PyTorch port, materials: the JAX package's material system against the
port's, on the same inputs from a numpy seed.

Tolerances:
  * texture sampling (sample_point, sample_red, sample_bilinear,
    sample_atlas, point and bilinear), the colour and normal loaders,
    setup_tangents and upload_mesh's shade_cols / shade_pack: bit for bit;
  * merl_eval, titopo_eval and _envmap_ke on 4,096 random direction pairs:
    the local frame and acos / atan2 differ by ulps between XLA and torch,
    so a lane on a cell boundary may pick the neighbouring cell: the same
    cell on >= 99.9% of lanes, and there the values within 1e-6 relative
    (Titopo: its grid coordinates within 2e-5 of a cell, its values on a
    smooth table);
  * renders, one scene per feature (32x24, 2 spp, 2 bounces: the primary
    hit's NEE and one indirect bounce; 1 spp on the cluster tier), compared
    per sample with the allowance of tests/test_torch_render.py: fewer
    than 5% of samples beyond 1e-3 of the image scale, the rest within
    1e-3, means within 2%.  The JAX scene is carried across with
    convert.scene_from_numpy (meshes on the brute-force tier, or
    re-uploaded on the cluster tier where the cut-out rounds run on the
    sweeps, Pallas in interpret mode).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.io import obj as jobj
from pathtracer_tpu.models import merl as jmerl
from pathtracer_tpu.models import texture as jtex
from pathtracer_tpu.render import renderer as jrnd
from pathtracer_tpu.scene import mesh as jmesh
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.io import obj as tobj
from pathtracer_tpu_torch.models import merl as tmerl
from pathtracer_tpu_torch.models import texture as ttex
from pathtracer_tpu_torch.render import renderer as trnd
from pathtracer_tpu_torch.scene import mesh as tmesh
from pathtracer_tpu_torch.scene import scene as tscn

from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

W, H, SPP, BOUNCES = 32, 24, 2, 2
CAM = ((0, 0, 50), (0, 0, -1), (0, 1, 0))
N_DIRS = 4096


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# Sampling, loaders, tangents, shading pack: bit for bit
# ---------------------------------------------------------------------------

def _uv(rng, n=2048):
    """UVs over several wraps, with exact texel edges, integers, tiny
    negatives and huge values among them."""
    u = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    v = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    special = np.asarray([0.0, 1.0, -1e-9, -1e-30, 1.0 - 2 ** -24, 0.5,
                          0.25, 2.0, -2.0, 1e7, -0.0, 3.5], np.float32)
    u[:len(special)] = special
    v[:len(special)] = special[::-1]
    return u, v


def test_sample_point_red_bilinear_bit_equal():
    rng = np.random.default_rng(1)
    u, v = _uv(rng)
    for h, w in ((8, 8), (5, 13), (1, 7), (16, 1)):
        img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        _same(ttex.sample_point(_t(img), _t(u), _t(v)),
              jtex.sample_point(jnp.asarray(img), jnp.asarray(u),
                                jnp.asarray(v)))
        _same(ttex.sample_red(_t(img), _t(u), _t(v)),
              jtex.sample_red(jnp.asarray(img), jnp.asarray(u),
                              jnp.asarray(v)))
        _same(ttex.sample_bilinear(_t(img), _t(u), _t(v)),
              jtex.sample_bilinear(jnp.asarray(img), jnp.asarray(u),
                                   jnp.asarray(v)))


@pytest.mark.parametrize('bilinear', [False, True], ids=['point', 'bilinear'])
def test_sample_atlas_bit_equal(bilinear):
    """The atlas against JAX's, and in point mode against per-group
    sampling (bilinear stays inside each group's rows)."""
    rng = np.random.default_rng(2)
    imgs = [rng.uniform(0, 1, (8, 8, 3)).astype(np.float32), None,
            rng.uniform(0, 1, (5, 12, 3)).astype(np.float32),
            rng.uniform(0, 1, (3, 4, 3)).astype(np.float32), None]
    at_j = jtex.build_atlas(imgs)
    at_t = ttex.build_atlas(imgs, device='cpu')
    for name in ('img', 'y0', 'h', 'w', 'has'):
        _same(getattr(at_t, name), getattr(at_j, name))
    u, v = _uv(rng)
    grp = rng.integers(0, len(imgs), u.shape[0]).astype(np.int32)
    val_t, has_t = ttex.sample_atlas(at_t, _t(grp), _t(u), _t(v), bilinear)
    val_j, has_j = jtex.sample_atlas(at_j, jnp.asarray(grp), jnp.asarray(u),
                                     jnp.asarray(v), bilinear)
    _same(val_t, val_j)
    _same(has_t, has_j)
    samp = ttex.sample_bilinear if bilinear else ttex.sample_point
    for g, im in enumerate(imgs):
        sel = grp == g
        if im is None:
            assert not has_t[sel].any()
            continue
        want = samp(_t(im), _t(u[sel]), _t(v[sel]))
        if bilinear:
            np.testing.assert_allclose(val_t[sel].numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-6)
        else:
            _same(val_t[sel], want)


def _png(path, arr):
    from PIL import Image
    Image.fromarray(arr).save(path)
    return str(path)


def test_loaders_bit_equal(tmp_path):
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, (6, 9, 3)).astype(np.uint8)
    raw[0, 0] = 128                        # the normal decode's zero vector
    p = _png(tmp_path / 'a.png', raw)
    _same(ttex.load_color_image(p), jtex.load_color_image(p))
    _same(ttex.load_normal_image(p), jtex.load_normal_image(p))
    _same(ttex.load_raw_image(p), jtex.load_raw_image(p))
    gray = _png(tmp_path / 'g.png', raw[..., 0])
    for ch in ('kd', 'normal', 'alpha', 'refr'):
        jt = jtex.make_group_textures({ch: gray})
        tt = ttex.make_group_textures({ch: gray}, device='cpu')
        _same(getattr(tt, ch), getattr(jt, ch))
    with pytest.raises(ValueError, match='channel'):
        ttex.make_group_textures({'bogus': raw})


def _grouped_sphere(n=12, groups=3, radius=10.0, uv_scale=1.0):
    """A procgen sphere with its triangles in latitude-band groups and
    tangents (the same MeshData for both packages)."""
    md = procgen.sphere_mesh(n, n, radius=radius, displace_amp=0.2)
    md.uvs = md.uvs * np.float32(uv_scale)
    c = md.vertices[md.vtx_idx].mean(1)
    md.group = np.clip(((c[:, 1] / radius + 1.0) * 0.5 * groups)
                       .astype(np.int32), 0, groups - 1)
    md.materials = [jobj.GroupMaterial(kd=np.asarray(
        [0.4 + 0.2 * g, 0.5, 0.7 - 0.2 * g], np.float32))
        for g in range(groups)]
    md.group_names = {f'g{g}': g for g in range(groups)}
    return jobj.setup_tangents(md)


def _to_torch_md(md):
    return tobj.MeshData(**{k: getattr(md, k) for k in (
        'vertices', 'normals', 'uvs', 'vtx_idx', 'uv_idx', 'n_idx', 'group',
        'show_edges', 'vertex_colors', 'group_names', 'tangents',
        'bitangents', 'obj_dir')}, materials=[tobj.GroupMaterial(
            kd=m.kd, ks=m.ks, ns=m.ns) for m in md.materials])


def test_setup_tangents_bit_equal():
    md_j = procgen.sphere_mesh(9, 11, radius=3.0, displace_amp=0.3)
    md_j.uv_idx[::7] = -1                  # faces without UVs
    md_t = _to_torch_md(md_j)
    jobj.setup_tangents(md_j)
    tobj.setup_tangents(md_t)
    _same(md_t.tangents, md_j.tangents)
    _same(md_t.bitangents, md_j.bitangents)


def _stripes(h, w, period=2):
    """An alpha map whose red channel cuts away every other column."""
    a = np.zeros((h, w, 3), np.float32)
    a[:, ::period] = 1.0
    return a


def test_upload_mesh_shade_pack_bit_equal(tmp_path):
    """shade_cols and shade_pack of a textured, normal-mapped,
    vertex-coloured, face-coloured, edge-displayed mesh with an edge CSV
    equal JAX's upload_mesh on the cluster tier; the textures, the atlas
    and the backface gate too."""
    rng = np.random.default_rng(4)
    md = _grouped_sphere(8, groups=5)
    md.vertex_colors = rng.uniform(0, 1, md.vertices.shape).astype(
        np.float32)
    t = md.num_triangles
    fc = rng.uniform(0, 1, (t, 3)).astype(np.float32)
    ec = (rng.uniform(0, 1, (t, 3, 3)).astype(np.float32),
          rng.uniform(0, 1, (t, 3)) > 0.5)
    tex = [{'kd': rng.uniform(0, 1, (4 + g, 6, 3)).astype(np.float32),
            'normal': rng.normal(0, 1, (4, 4, 3)).astype(np.float32),
            'alpha': _stripes(4, 4)} for g in range(5)]
    kw = dict(display_edges=True, facecolors=fc, edge_colors=ec,
              texture_overrides=tex)
    m_j = jmesh.upload_mesh(md, obj_row=3, use_cluster=True, **kw)
    m_t = tmesh.upload_mesh(_to_torch_md(md), obj_row=3, dev='cpu', **kw)
    assert m_t.shade_cols == tuple(m_j.shade_cols)
    assert [c[0] for c in m_t.shade_cols] == [
        'n0', 'n1', 'n2', 'grp', 'uv0', 'uv1', 'uv2', 't0', 't1', 't2',
        'vc0', 'vc1', 'vc2', 'fc', 'se', 'ec', 'em', 'bary']
    _same(m_t.shade_pack, m_j.shade_pack)
    assert m_t.backface_cull is False and m_j.backface_cull is False
    for gt_t, gt_j in zip(m_t.textures, m_j.textures):
        for ch in ttex.CHANNELS:
            a, b = getattr(gt_t, ch), getattr(gt_j, ch)
            assert (a is None) == (b is None)
            if a is not None:
                _same(a, b)
    assert len(m_t.atlases) == len(m_j.atlases) == len(ttex.CHANNELS)
    for a, b in zip(m_t.atlases, m_j.atlases):
        assert (a is None) == (b is None)
        if a is not None:
            _same(a.img, b.img)
            _same(a.y0, b.y0)
    # a lean-sized untextured mesh keeps no uv columns; textured, it does
    plain = tmesh.upload_mesh(_to_torch_md(md), obj_row=3, dev='cpu')
    assert plain.col('uv0') is None and plain.atlases == ()


def test_seg_lab_edge_csv_bit_equal(tmp_path):
    md = procgen.sphere_mesh(6, 6, radius=2.0)
    t = md.num_triangles
    rng = np.random.default_rng(5)
    seg = tmp_path / 'm.seg'
    seg.write_text('\n'.join(str(x) for x in rng.integers(0, 40, t + 3)))
    _same(tobj.load_seg(str(seg), t), jobj.load_seg(str(seg), t))
    lab = tmp_path / 'm.lab'
    lines = []
    for s in range(4):
        lines += [f'seg{s}', ' '.join(str(x) for x in
                                      rng.integers(0, t + 5, 9))]
    lab.write_text('\n'.join(lines) + '\n')
    _same(tobj.load_lab(str(lab), t), jobj.load_lab(str(lab), t))
    _same(tobj.seg_colors(np.arange(300)), jobj.seg_colors(np.arange(300)))
    # a cut CSV over every edge shared by two faces
    csv = tmp_path / 'cuts.csv'
    csv.write_text(_edge_csv(md, rng))
    for a, b in zip(tobj.load_edge_csv(str(csv), _to_torch_md(md)),
                    jobj.load_edge_csv(str(csv), md)):
        _same(a, b)


def _edge_csv(md, rng):
    """Cut-analysis CSV lines for the face pairs sharing an edge."""
    e2f = {}
    for f, tri in enumerate(md.vtx_idx):
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[0], tri[2])):
            e2f.setdefault((min(a, b), max(a, b)), []).append(f)
    rows = []
    for faces in e2f.values():
        if len(faces) == 2 and rng.uniform() < 0.6:
            v0, v1 = rng.uniform(-0.2, 1.2, 2)
            rows.append(f'1 {v0:.4f} {v1:.4f} {faces[0]} 0 0 1 '
                        f'{faces[1]} 0 1 0')
    return '\n'.join(rows) + '\nheader line ignored\n'


# ---------------------------------------------------------------------------
# Measured BRDFs and the env map: cells and values
# ---------------------------------------------------------------------------

def _dirs(seed, n=N_DIRS):
    rng = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)

    nrm = unit(rng.normal(size=(n, 3)))
    wi = unit(rng.normal(size=(n, 3)))
    wo = unit(rng.normal(size=(n, 3)))
    # mostly above the horizon
    wi = np.where((wi * nrm).sum(-1, keepdims=True) < 0, -wi, wi)
    wo = np.where((wo * nrm).sum(-1, keepdims=True) < 0, -wo, wo)
    wo[::16] = -wo[::16]
    return wi, wo, nrm


def _cells_and_values(got_cell, want_cell, got_val, want_val):
    same = got_cell == want_cell
    assert same.mean() >= 0.999, same.mean()
    g, w = got_val[same], want_val[same]
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-30)


def test_merl_eval_cells_and_values():
    n = jmerl.RES_TH * jmerl.RES_TD * jmerl.RES_PD // 2
    wi, wo, nrm = _dirs(6)
    # a table holding its own cell index identifies the cell of a lookup
    ident = np.tile(np.arange(n, dtype=np.float32) * 1500.0, (3, 1))
    smooth = np.stack([(np.sin(np.arange(n) * 1e-3 + c) + 1.3) * 50.0
                       for c in range(3)]).astype(np.float32)
    out = {}
    for name, data in (('ident', ident), ('smooth', smooth)):
        jt = jmerl.MeasuredBRDF(data=jnp.asarray(data), kind=jmerl.MERL)
        tt = tmerl.MeasuredBRDF(data=_t(data), kind=tmerl.MERL)
        out[name] = (tmerl.merl_eval(tt, _t(wi), _t(wo), _t(nrm)).numpy(),
                     np.asarray(jmerl.merl_eval(jt, jnp.asarray(wi),
                                                jnp.asarray(wo),
                                                jnp.asarray(nrm))))
    cell_t = np.rint(out['ident'][0][:, 0]).astype(np.int64)
    cell_j = np.rint(out['ident'][1][:, 0]).astype(np.int64)
    above = out['smooth'][1].max(-1) > 0
    assert above.mean() > 0.8
    idx, ab = tmerl.merl_index(_t(wi), _t(wo), _t(nrm))
    np.testing.assert_array_equal(ab.numpy(), above)
    np.testing.assert_array_equal(np.where(above, idx.numpy(), 0), cell_t)
    _cells_and_values(cell_t[above], cell_j[above], out['smooth'][0][above],
                      out['smooth'][1][above])
    assert not out['smooth'][0][~above].any()


def _jax_titopo_coords(dims, wi, wo, nrm):
    """JAX's continuous grid coordinates (fi, fo, fp) of titopo_eval, by
    its own expressions."""
    nti, nto, npd = dims
    wi_l, wo_l = jmerl._local_frame(jnp.asarray(nrm), jnp.asarray(wi),
                                    jnp.asarray(wo))
    thetai = jnp.arccos(jnp.clip(wi_l[..., 2], -1.0, 1.0))
    thetao = jnp.arccos(jnp.clip(wo_l[..., 2], -1.0, 1.0))
    phid = jnp.mod(jnp.arctan2(wo_l[..., 1], wo_l[..., 0])
                   - jnp.arctan2(wi_l[..., 1], wi_l[..., 0]), 2.0 * np.pi)
    return [np.asarray(x) for x in (thetai / (np.pi / 2.0) * nti,
                                    thetao / (np.pi / 2.0) * nto,
                                    phid / (2.0 * np.pi) * npd)]


def test_titopo_eval_cells_and_values():
    """Titopo interpolates trilinearly, so where both packages pick the
    same cell an ulp of difference in a grid coordinate (XLA's local frame
    and acos / atan2 against torch's) moves the value by that ulp times
    the table's step between neighbouring cells.  The grid coordinates
    agree within 2e-5 of a cell (measured 1.1e-5; acos is steep near the
    normal, so this is more than a few ulps of the result), and on a smooth
    table, as measured BRDFs are, the values within 1e-6 relative.  A
    white-noise table checks the horizon and the dispatch."""
    dims = (45, 45, 180)
    rng = np.random.default_rng(7)
    i, o, p_ = np.meshgrid(*(np.arange(d, dtype=np.float64) for d in dims),
                           indexing='ij')
    smooth = np.stack([0.4 + 0.3 * np.cos(i / 30.0 + c) * np.cos(o / 35.0)
                       + 0.1 * np.sin(p_ * np.pi / 90.0 + c)
                       for c in range(3)], -1).reshape(-1, 3)
    noise = rng.uniform(0.05, 2.0, smooth.shape)
    wi, wo, nrm = _dirs(8)
    fi, fo, fp, above = tmerl.titopo_coords(dims, _t(wi), _t(wo), _t(nrm))
    got_c = [x.numpy() for x in (fi, fo, fp)]
    want_c = _jax_titopo_coords(dims, wi, wo, nrm)
    cell_t = np.stack([np.clip(x.astype(np.int32), 0, d - 1)
                       for x, d in zip(got_c, dims)], -1)
    cell_j = np.stack([np.clip(x.astype(np.int32), 0, d - 1)
                       for x, d in zip(want_c, dims)], -1)
    ab = above.numpy()
    same = (cell_t == cell_j).all(-1) & ab
    assert ab.mean() > 0.8 and same.sum() >= 0.999 * ab.sum()
    for g, w in zip(got_c, want_c):
        assert np.abs(g[same] - w[same]).max() < 2e-5
    vals = []
    for data in (smooth, noise):
        data = data.astype(np.float32)
        jt = jmerl.MeasuredBRDF(data=jnp.asarray(data), kind=jmerl.TITOPO,
                                dims=dims)
        tt = tmerl.MeasuredBRDF(data=_t(data), kind=tmerl.TITOPO, dims=dims)
        got = tmerl.titopo_eval(tt, _t(wi), _t(wo), _t(nrm)).numpy()
        want = np.asarray(jmerl.titopo_eval(
            jt, jnp.asarray(wi), jnp.asarray(wo), jnp.asarray(nrm)))
        assert not got[~ab].any() and not want[~ab].any()
        np.testing.assert_array_equal(
            tmerl.measured_eval(tt, _t(wi), _t(wo), _t(nrm)).numpy(), got)
        vals.append((got, want))
    got, want = vals[0]
    _cells_and_values(cell_t[same], cell_j[same], got[same], want[same])


def test_envmap_ke_cells_and_values():
    eh, ew = 37, 61
    rng = np.random.default_rng(9)
    nrm = rng.normal(size=(N_DIRS, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    nrm[:6] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1],
               [0, 0, -1]]
    ident = (np.arange(eh * ew, dtype=np.float32).reshape(eh, ew, 1)
             * np.ones((1, 1, 3), np.float32))
    smooth = rng.uniform(0.1, 4.0, (eh, ew, 3)).astype(np.float32)
    res = {}
    for name, env in (('ident', ident), ('smooth', smooth)):
        tsc = type('S', (), {'envmap': _t(env)})
        jsc = type('S', (), {'envmap': jnp.asarray(env)})
        cols = [nrm[:, k] for k in range(3)]
        res[name] = (tscn._envmap_ke(tsc, *map(_t, cols)).numpy(),
                     np.asarray(jscn._envmap_ke(jsc, *map(jnp.asarray,
                                                         cols))))
    scale = np.float32(100000.0 / 255.0)
    cell_t = np.rint(res['ident'][0][:, 0] / scale)
    cell_j = np.rint(res['ident'][1][:, 0] / scale)
    _cells_and_values(cell_t, cell_j, res['smooth'][0], res['smooth'][1])


# ---------------------------------------------------------------------------
# Renders, per sample
# ---------------------------------------------------------------------------

def _compare_samples_of(jsc, tsc, jcam, tcam, w, h, spp, bounces):
    """Render both scenes' samples and hold them to the allowance."""
    cp = rng_host.random_per_pixel_fast(w, h)
    cfg = dict(width=w, height=h, nrays=spp, nb_bounces=bounces)
    _, s_j = jrnd.render_unsplatted(jsc, jcam, jnp.asarray(cp),
                                    jrnd.RenderConfig(**cfg))
    _, s_t = trnd.render_unsplatted(tsc, tcam, torch.as_tensor(cp),
                                    trnd.RenderConfig(**cfg))
    s_j, s_t = np.asarray(s_j), s_t.detach().numpy()
    assert (s_j.max(-1) > 0).mean() > 0.2          # non-vacuous: lit
    scale = max(np.abs(s_j).max(), 1e-6)
    rel = np.abs(s_t - s_j).max(-1) / scale
    flipped = rel > 1e-3
    print(f'flipped {flipped.mean():.5f} tight max {rel[~flipped].max():.3g}'
          f' mean rel {abs(s_t.mean() - s_j.mean()) / scale:.3g}')
    assert flipped.mean() < 0.05
    assert rel[~flipped].max() < 1e-3
    assert abs(s_t.mean() - s_j.mean()) / scale < 0.02
    return s_j, s_t


def _compare(jsc, tsc, aperture=None, spp=SPP):
    kw = {} if aperture is None else dict(focus_distance=48.0,
                                          aperture=aperture)
    return _compare_samples_of(jsc, tsc, jpt.make_camera(*CAM, **kw),
                               tpt.make_camera(*CAM, **kw), W, H, spp,
                               BOUNCES)


def tscn_from(jsc):
    return convert.scene_from_numpy(convert.numpy_fields(jsc), device='cpu')


def _scene(objs, cluster_rows=(), **kw):
    """The JAX scene of `objs`; meshes at `cluster_rows` re-uploaded on the
    cluster tier with their object's options.  Returns (jax, port)."""
    sc = jscn.build_scene(objs, jscn.default_light_intensity(),
                          merge_meshes=False, **kw)
    meshes = []
    for m in sc.meshes:
        if m.obj_row in cluster_rows:
            o = objs[m.obj_row]
            m = jmesh.upload_mesh(
                o.mesh_data, obj_row=m.obj_row, use_cluster=True,
                texture_overrides=o.textures, use_atlas=o.use_atlas,
                bilinear=o.bilinear, cutout_rounds=o.cutout_rounds,
                default_transp=o.transp, default_refr=o.refr_index,
                display_edges=o.display_edges)
        meshes.append(m)
    sc = sc.replace(meshes=tuple(meshes))
    return sc, tscn_from(sc)


def _cutout_textures(rng, groups, alpha_groups):
    return [{'kd': rng.uniform(0.1, 1.0, (8, 8, 3)).astype(np.float32),
             'normal': rng.normal(0, 1, (8, 8, 3)).astype(np.float32),
             **({'alpha': _stripes(8, 8)} if g in alpha_groups else {})}
            for g in range(groups)]


@pytest.mark.parametrize('atlas', [False, True], ids=['per_group', 'atlas'])
def test_kd_normal_alpha_mesh_renders(atlas):
    """kd, normal and alpha maps on a 3-group mesh: per-group sampling on
    the brute-force tier; the atlas (forced) on the cluster tier, where
    the cut-out rounds give the sweep a rising strict floor."""
    rng = np.random.default_rng(10)
    md = _grouped_sphere(12, groups=3, uv_scale=3.0)
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(
        md, translation=(0.0, -15.0, 0.0), use_atlas=atlas,
        bilinear=atlas, textures=_cutout_textures(rng, 3, (0, 2))))
    jsc, tsc = _scene(objs, cluster_rows=(3,) if atlas else ())
    m = tsc.meshes[0]
    assert m.has_alpha and bool(m.atlases) == atlas
    assert m.use_cluster == atlas
    tscn.CUTOUT_LOG = []
    try:
        _compare(jsc, tsc, spp=1 if atlas else SPP)
        assert any(len(e['lanes']) > 1 for e in tscn.CUTOUT_LOG)
    finally:
        tscn.CUTOUT_LOG = None


def test_cutout_shadows_render():
    """An alpha-striped plate between the light and a sphere: its cut-out
    texels let shadow rays through (closest-hit path bounded by the light
    distance, cluster tier)."""
    rng = np.random.default_rng(11)
    md = _grouped_sphere(10, groups=1, radius=6.0, uv_scale=4.0)
    md.vertices[:, 1] *= 0.1                       # a flattened disc
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(4.0, 8.0, 6.0),
                                 textures={'alpha': _stripes(8, 8)}))
    objs.append(jscn.sphere((2.0, -17.0, 2.0), 9.0, kd=(0.6, 0.6, 0.5)))
    jsc, tsc = _scene(objs, cluster_rows=(3,))
    assert tsc.meshes[0].use_cluster and tsc.meshes[0].has_alpha
    org = torch.tensor([[4.0, -17.0 + 9.0 + 0.01, 6.0]]).expand(256, 3)
    ang = torch.linspace(0.0, 6.2, 256)
    dirn = torch.stack([0.3 * torch.cos(ang), torch.ones(256),
                        0.3 * torch.sin(ang)], -1)
    dirn = dirn / dirn.norm(dim=-1, keepdim=True)
    blocked = tscn.intersect_shadow(tsc, org, dirn, torch.full((256,), 60.0))
    blocked_j = jscn.intersect_shadow(jsc, jnp.asarray(org.numpy()),
                                      jnp.asarray(dirn.numpy()),
                                      jnp.full((256,), 60.0))
    _same(blocked, blocked_j)
    assert 0 < int(blocked.sum()) < 256
    _compare(jsc, tsc, spp=1)


def test_analytic_textures_render():
    """kd / ks / roughness maps on a sphere (spherical UV of the pre-flip
    normal) and a kd map on the ground plane (0.1 (x, z))."""
    rng = np.random.default_rng(12)
    objs = jscn.default_objects()
    objs[2].textures = {'kd': rng.uniform(0.1, 1.0, (16, 16, 3))}
    objs.append(jscn.sphere(
        (0.0, -17.0, 0.0), 10.0, kd=(0.9, 0.8, 0.7), ks=(0.3, 0.3, 0.3),
        ne=(40.0, 40.0, 40.0),
        textures={'kd': rng.uniform(0.1, 1.0, (12, 24, 3)),
                  'ks': rng.uniform(0.0, 1.0, (6, 6)),
                  'roughness': rng.uniform(0.2, 1.0, (6, 6))}))
    jsc, tsc = _scene(objs)
    assert tsc.obj_textures[3].kd is not None
    _compare(jsc, tsc)


def test_transp_refr_maps_render():
    """transp and refr maps on a mesh (getBool / getValRed) and on a glass
    sphere."""
    rng = np.random.default_rng(13)
    md = _grouped_sphere(12, groups=2, radius=8.0, uv_scale=2.0)
    transp = np.zeros((8, 8, 3), np.float32)
    transp[::2] = 1.0
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(-6.0, -17.0, 0.0),
                                 refr_index=1.5, textures=[
                                     {'transp': transp,
                                      'refr': rng.uniform(0.8, 1.1,
                                                          (8, 8, 3))},
                                     {'refr': rng.uniform(0.9, 1.0,
                                                          (4, 4, 3))}]))
    objs.append(jscn.sphere((12.0, -19.0, 4.0), 7.0, transp=True,
                            refr_index=1.4,
                            textures={'refr': rng.uniform(0.8, 1.2, (6, 6)),
                                      'transp': transp}))
    jsc, tsc = _scene(objs)
    assert not tsc.meshes[0].backface_cull
    _compare(jsc, tsc)


def test_vertex_colours_render():
    rng = np.random.default_rng(14)
    md = procgen.sphere_mesh(12, 12, radius=10.0, displace_amp=0.2)
    md.vertex_colors = rng.uniform(0, 1, md.vertices.shape).astype(
        np.float32)
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    jsc, tsc = _scene(objs)
    assert tsc.meshes[0].col('vc0') is not None
    _compare(jsc, tsc)


def test_seg_face_colours_render(tmp_path):
    rng = np.random.default_rng(15)
    md = procgen.sphere_mesh(12, 12, radius=10.0, displace_amp=0.2)
    seg = tmp_path / 'sphere.seg'
    seg.write_text('\n'.join(str(x) for x in
                             rng.integers(0, 9, md.num_triangles)))
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(0.0, -15.0, 0.0),
                                 seg_path=str(seg)))
    jsc, tsc = _scene(objs)
    assert tsc.meshes[0].col('fc') is not None
    # the port's own build reads the .seg into the same column
    own = tscn.build_scene(objs_to_torch(objs), tscn.default_light_intensity(),
                           device='cpu')
    fc = own.meshes[0].col('fc')
    np.testing.assert_array_equal(own.meshes[0].shade_pack[:, fc].numpy(),
                                  tsc.meshes[0].shade_pack[:, fc].numpy())
    _compare(jsc, tsc)


def objs_to_torch(objs):
    """The JAX ObjectSpecs as the port's (the same fields)."""
    import dataclasses
    out = []
    for o in objs:
        kw = {f.name: getattr(o, f.name) for f in dataclasses.fields(
            tscn.ObjectSpec) if hasattr(o, f.name)}
        if o.mesh_data is not None:
            kw['mesh_data'] = _to_torch_md(o.mesh_data)
        out.append(tscn.ObjectSpec(**kw))
    return out


@pytest.mark.parametrize('csv', [False, True], ids=['wireframe', 'edge_csv'])
def test_edge_display_render(tmp_path, csv):
    md = procgen.sphere_mesh(10, 10, radius=10.0, displace_amp=0.2)
    kw = dict(display_edges=True, interp_normals=False)
    if csv:
        p = tmp_path / 'cuts.csv'
        p.write_text(_edge_csv(md, np.random.default_rng(16)))
        kw['edge_csv'] = str(p)
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(0.0, -15.0, 0.0), **kw))
    jsc, tsc = _scene(objs)
    assert (tsc.meshes[0].col('ec') is not None) == csv
    _compare(jsc, tsc)


def test_envmap_dome_render():
    rng = np.random.default_rng(17)
    env = rng.uniform(0.05, 3.0, (16, 32, 3)).astype(np.float32)
    objs = jscn.default_objects()
    objs.append(jscn.sphere((0.0, -17.0, 0.0), 10.0, miroir=True))
    objs.append(jscn.sphere((-15.0, -20.0, -5.0), 7.0, kd=(0.6, 0.5, 0.4)))
    jsc, tsc = _scene(objs, envmap=env, envmap_intensity=0.7)
    assert tsc.envmap is not None
    s_j, _ = _compare(jsc, tsc)
    assert s_j[:4].max() > 0                        # the sky is lit


def _write_titopo(path, dims, seed):
    rng = np.random.default_rng(seed)
    rng.uniform(0.05, 0.6, dims[0] * dims[1] * dims[2] * 3).astype(
        np.float32).tofile(path)


@pytest.mark.parametrize('kind', ['merl', 'titopo'])
def test_measured_brdf_dof_render(tmp_path, kind):
    """MERL (the synthetic full-size table of tests/test_config_parity.py)
    and Titopo (.titopoh, 45 x 45 x 180) spheres, wide-aperture DoF."""
    import test_config_parity as tcp
    if kind == 'merl':
        path = str(tmp_path / 'm.binary')
        tcp._write_merl(path)
    else:
        path = str(tmp_path / 'm.titopoh')
        _write_titopo(path, (45, 45, 180), 18)
    table = jmerl.load_measured(path)
    objs = jscn.default_objects()
    objs.append(jscn.sphere((0.0, -17.0, 0.0), 10.0, measured_brdf=table))
    objs.append(jscn.sphere((14.0, -20.0, -6.0), 7.0, measured_brdf=table))
    jsc, tsc = _scene(objs)
    assert len(tsc.measured_brdfs) == 1
    _same(tsc.brdf_type, [0, 0, 0, 1, 1])
    own = tmerl.load_measured(path, device='cpu')
    _same(own.data, table.data)
    assert own.kind == table.kind and own.dims == tuple(table.dims)
    _compare(jsc, tsc, aperture=1.5)


def test_merged_meshes_render():
    """Two textured mesh objects, one of them transformed, merged into one
    world-space mesh by both packages (the default for two or more
    eligible meshes); the port's own build equals the conversion."""
    rng = np.random.default_rng(19)
    a = _grouped_sphere(10, groups=2, radius=7.0)
    b = procgen.sphere_mesh(10, 10, radius=5.0, displace_amp=0.2, seed=3)
    tex = [{'kd': rng.uniform(0.1, 1.0, (8, 8, 3)).astype(np.float32)},
           None]

    def objs_of(mod, a, b):
        objs = mod.default_objects()
        objs.append(mod.mesh_object(a, translation=(-8.0, -18.0, 0.0),
                                    textures=tex))
        objs.append(mod.mesh_object(b, translation=(10.0, -20.0, -4.0),
                                    rotation=np.asarray(
                                        [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0],
                                         [-1.0, 0.0, 0.0]]), miroir=True))
        return objs

    jsc = jscn.build_scene(objs_of(jscn, a, b),
                           jscn.default_light_intensity())
    own = tscn.build_scene(objs_of(tscn, _to_torch_md(a), _to_torch_md(b)),
                           tscn.default_light_intensity(), device='cpu')
    (jm,), (om,) = jsc.meshes, own.meshes
    assert jm.world_space and om.world_space
    _same(om.group_rows, jm.group_rows)
    assert om.shade_cols[:-1] == tuple(jm.shade_cols)     # + 'bary'
    conv = tscn_from(jsc)
    assert conv.meshes[0].world_space and not conv.meshes[0].use_cluster
    np.testing.assert_array_equal(om.shade_pack[:, :-13].numpy(),
                                  conv.meshes[0].shade_pack.numpy())
    _compare(jsc, conv)
