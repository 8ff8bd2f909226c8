"""PyTorch port, loaders: the OBJ/MTL loader (native tokenizer and Python
twin), the image and HDR I/O, the scene JSON loader, the conversion of a
textured JAX scene, and gradients of the material leaves, against the JAX
package on the same inputs.

Tolerances:
  * read_obj (native and Python) on the grammar cases of
    tests/test_obj_native.py with MTL binding, read_off, read_vrml,
    load_mesh, save_obj / export_mtl, load_image, and HDR written by either
    package and read by the other: bit for bit;
  * configs 1-5 from their JSON with tests/test_config_parity.py's
    stand-in assets (config 5: fog and a subsurface mesh), loaded by both packages (each its own loader and
    build_scene) and rendered at 12x10 x 2 spp with the config's bounces:
    per sample with tests/test_torch_render.py's allowance (fewer than 5%
    beyond 1e-3 of the image scale, the rest within 1e-3, means within 2%);
  * convert.scene_from_numpy of a JAX scene with group textures, an
    atlas, analytic textures, an env map and a MERL table: the same arrays
    as the port's own build_scene, and the same samples bit for bit;
  * gradients of a kd texture, the env map and a MERL table (16x12, 2 spp,
    3 bounces) against jax.grad: within 5e-4 of the leaf's largest |grad|
    (tests/test_torch_grad.py).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.io import image as jimg
from pathtracer_tpu.io import obj as jobj
from pathtracer_tpu.io import scene_json as jjson
from pathtracer_tpu.models import merl as jmerl
from pathtracer_tpu.models import presets as jpresets
from pathtracer_tpu.render import renderer as jrnd
from pathtracer_tpu.scene import mesh as jmesh
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.io import image as timg
from pathtracer_tpu_torch.io import obj as tobj
from pathtracer_tpu_torch.io import scene_json as tjson
from pathtracer_tpu_torch.models import merl as tmerl
from pathtracer_tpu_torch.models import presets as tpresets
from pathtracer_tpu_torch.render import renderer as trnd
from pathtracer_tpu_torch.scene import scene as tscn

import test_config_parity as tcp
import test_obj_native as ton
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)
from test_torch_materials import _compare_samples_of, _stripes

RADIANCE = 196964.7
MD_FIELDS = ton.FIELDS + ('vertex_colors', 'tangents', 'bitangents')


def _same_md(a, b):
    for f in MD_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.group_names == b.group_names
    assert len(a.materials) == len(b.materials)
    for ma, mb in zip(a.materials, b.materials):
        for f in ('kd', 'ks', 'ns'):
            np.testing.assert_array_equal(getattr(ma, f), getattr(mb, f))
        for f in ('map_kd', 'map_ks', 'map_bump', 'map_d'):
            assert getattr(ma, f) == getattr(mb, f), f


MTL = """\
newmtl red
Kd 0.9 0.1 0.2
Ks 0.5 0.5 0.5
Ns 12
map_Kd tex/red.png
map_Bump tex/red_n.png
newmtl blue
illum 1
Ks 0.3 0.3 0.3
Ns 3 4 5
map_Ks blue_s.png
map_d blue_a.png
newmtl unused
Kd 1 1 1
"""


@pytest.mark.parametrize('case', ['TRICKY', 'NO_GROUPS', 'ALL_COLORS'])
@pytest.mark.parametrize('native', [True, False], ids=['native', 'python'])
def test_read_obj_bit_equal(tmp_path, monkeypatch, case, native):
    text = getattr(ton, case).replace('ignored_because_missing.mtl', 'm.mtl')
    p = tmp_path / 'm.obj'
    p.write_text(text)
    (tmp_path / 'm.mtl').write_text(MTL)
    if not native:
        monkeypatch.setenv('PT_NO_NATIVE_OBJ', '1')
    else:
        assert tobj._load_native_obj() is not None
    _same_md(tobj.read_obj(str(p)), jobj.read_obj(str(p)))
    if native:   # the native arrays equal the Python twin's
        nat = tobj._read_obj_native(str(p))[0]
        py = tobj._read_obj_python(str(p), load_materials=False)
        for f in ton.FIELDS:
            np.testing.assert_array_equal(getattr(nat, f), getattr(py, f))


def test_load_mesh_off_vrml_and_writers_bit_equal(tmp_path):
    md = procgen.sphere_mesh(7, 9, radius=2.0, displace_amp=0.2)
    p = str(tmp_path / 'w.obj')
    jobj.save_obj(md, p, mtl_name='w.mtl')
    md.materials[0].map_kd = 'k.png'
    jobj.export_mtl(md, str(tmp_path / 'w.mtl'))
    tp = str(tmp_path / 't.obj')
    tmd = tobj.read_obj(p)
    tobj.save_obj(tmd, tp, mtl_name='w.mtl')
    tobj.export_mtl(tmd, str(tmp_path / 't.mtl'))
    assert open(tp).read() == open(p).read()
    assert (open(tmp_path / 't.mtl').read()
            == open(tmp_path / 'w.mtl').read())
    for kw in ({}, dict(scaling=12.0, offset=(1.0, -2.0, 3.0)),
               dict(preserve_input=True)):
        _same_md(tobj.load_mesh(p, **kw), jobj.load_mesh(p, **kw))
    off = tmp_path / 'q.off'
    off.write_text('OFF\n5 2 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n0.5 2 0\n'
                   '4 0 1 2 3\n3 3 2 4\n')
    _same_md(tobj.load_mesh(str(off)), jobj.load_mesh(str(off)))
    wrl = tmp_path / 'q.wrl'
    wrl.write_text('Coordinate { point [ 0 0 0, 1 0 0, 1 1 0, 0 1 0, '
                   '0.5 2 0 ] }\ncoordIndex [ 0, 1, 2, 3, -1, 3, 2, 4 ]\n')
    _same_md(tobj.load_mesh(str(wrl)), jobj.load_mesh(str(wrl)))
    a = tobj.transform_mesh(tobj.read_obj(p), 5.0)
    b = jobj.transform_mesh(jobj.read_obj(p), 5.0)
    _same_md(tobj.fill_face_normals(a), jobj.fill_face_normals(b))


def test_images_and_hdr_cross_packages(tmp_path):
    rng = np.random.default_rng(20)
    u8 = rng.integers(0, 256, (7, 11, 3)).astype(np.uint8)
    timg.save_image(str(tmp_path / 't.png'), u8)
    np.testing.assert_array_equal(jimg.load_image(str(tmp_path / 't.png')),
                                  timg.load_image(str(tmp_path / 't.png')))
    hdr = rng.uniform(0.0, 50.0, (9, 300, 3)).astype(np.float32)
    hdr[0, :140] = 1.5                     # runs for the RLE
    hdr[1, 5] = 0.0
    hdr[2, 7] = 1e-35                      # below the RGBE floor
    for writer, name in ((jimg.save_hdr, 'j.hdr'), (timg.save_hdr, 't.hdr')):
        writer(str(tmp_path / name), hdr)
        a = timg.load_hdr(str(tmp_path / name))
        np.testing.assert_array_equal(a, jimg.load_hdr(str(tmp_path / name)))
        # RGBE keeps 8 bits relative to each pixel's largest channel
        assert (np.abs(a - hdr)
                <= hdr.max(-1, keepdims=True) * 2 ** -7 + 1e-30).all()
    # the encodings are the same bytes past the header comment
    j = open(tmp_path / 'j.hdr', 'rb').read()
    t = open(tmp_path / 't.hdr', 'rb').read()
    assert j[j.index(b'\n\n'):] == t[t.index(b'\n\n'):]
    assert tpresets.PRESETS == jpresets.PRESETS
    assert tpresets.preset('gold') == jpresets.preset('gold')


# ---------------------------------------------------------------------------
# Scene JSON: configs 1-5 through both loaders
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def ladder_dir(tmp_path_factory):
    """Config JSONs + tests/test_config_parity.py's stand-in assets."""
    d = tmp_path_factory.mktemp('torch_ladder')
    for cfg in ('config1_analytic.json', 'config2_mesh.json',
                'config3_transparent.json', 'config4_merl_dof.json',
                'config5_office.json'):
        shutil.copy(os.path.join(tcp.CONFIG_DIR, cfg), d / cfg)
    tcp._write_obj(d / 'lion.obj', procgen.sphere_mesh(8, 8, radius=1.0))
    tcp._write_obj(d / 'bot.obj',
                   procgen.sphere_mesh(8, 8, radius=1.0, displace_amp=0.15))
    # tests/test_gradcheck_ladder.py:56-57's stand-in
    tcp._write_obj(d / 'antiqueOffice.obj',
                   procgen.sphere_mesh(6, 6, radius=1.0))
    rng = np.random.default_rng(7)
    jimg.save_hdr(str(d / 'env.hdr'),
                  rng.uniform(0.05, 3.0, (8, 16, 3)).astype(np.float32))
    tcp._write_merl(d / 'material.binary')
    return d


@pytest.mark.parametrize('name', ['config1_analytic', 'config2_mesh',
                                  'config3_transparent', 'config4_merl_dof',
                                  'config5_office'])
def test_configs_from_json_render(ladder_dir, name):
    path = str(ladder_dir / f'{name}.json')
    jo, jli, jcam, jcfg, jex = jjson.load_scene(path)
    to, tli, tcam, tcfg, tex = tjson.load_scene(path, device='cpu')
    assert tli == jli and tex == jex and tuple(tcfg) == tuple(jcfg)[
        :len(tcfg)]
    for f in ('position', 'direction', 'up', 'fov', 'focus_distance',
              'aperture'):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)))
    for a, b in zip(to, jo):
        if b.mesh_data is not None:
            _same_md(a.mesh_data, b.mesh_data)
        if b.measured_brdf is not None:
            np.testing.assert_array_equal(a.measured_brdf.data.numpy(),
                                          np.asarray(b.measured_brdf.data))
    env = (None if not jex['envmap']
           else jimg.load_hdr(str(ladder_dir / jex['envmap'])))
    tenv = (None if not tex['envmap']
            else timg.load_hdr(str(ladder_dir / tex['envmap'])))
    jsc = jscn.build_scene(jo, jli, envmap_intensity=jex['envmap_intensity'],
                           envmap=env, fog=jex['fog'])
    tsc = tscn.build_scene(to, tli, envmap_intensity=tex['envmap_intensity'],
                           envmap=tenv, fog=tex['fog'], device='cpu')
    assert (tsc.envmap is None) == (env is None)
    assert bool(tsc.measured_brdfs) == ('merl' in name)
    _compare_samples_of(jsc, tsc, jcam, tcam, 12, 10, 2, jcfg.nb_bounces)


def test_save_scene_round_trip(ladder_dir, tmp_path):
    """The port writes what the JAX package writes, and reads it back."""
    path = str(ladder_dir / 'config4_merl_dof.json')
    to, tli, tcam, tcfg, tex = tjson.load_scene(path, device='cpu')
    jo, jli, jcam, jcfg, jex = jjson.load_scene(path)
    for o in to[3:]:
        o.textures = {'kd': 'kd.png'}
    for o in jo[3:]:
        o.textures = {'kd': 'kd.png'}
    tjson.save_scene(str(tmp_path / 't.json'), to, tli, tcam, tcfg)
    jjson.save_scene(str(tmp_path / 'j.json'), jo, jli, jcam, jcfg)
    assert (json.load(open(tmp_path / 't.json'))
            == json.load(open(tmp_path / 'j.json')))


# ---------------------------------------------------------------------------
# Conversion of a textured JAX scene; gradients
# ---------------------------------------------------------------------------

def _textured_objects(mod, md, table, rng):
    """Five textured groups (the atlas), an analytic texture, a MERL
    sphere; `mod` is either package's scene module."""
    tex = [{'kd': rng.uniform(0.1, 1.0, (6, 6, 3)),
            'normal': rng.normal(0, 1, (4, 4, 3)),
            **({'alpha': _stripes(4, 4)} if g == 1 else {})}
           for g in range(5)]
    objs = mod.default_objects()
    objs[2].textures = {'kd': rng.uniform(0.2, 1.0, (8, 8, 3))}
    objs.append(mod.mesh_object(md, translation=(0.0, -15.0, 0.0),
                                textures=tex))
    objs.append(mod.sphere((14.0, -20.0, -6.0), 7.0, measured_brdf=table))
    return objs


def test_convert_textured_scene_equals_build_scene(tmp_path):
    from test_torch_materials import _grouped_sphere, _to_torch_md
    tcp._write_merl(tmp_path / 'm.binary')
    md = _grouped_sphere(10, groups=5, uv_scale=2.0)
    env = np.random.default_rng(21).uniform(0.1, 2.0, (8, 16, 3)).astype(
        np.float32)
    jtable = jmerl.load_measured(str(tmp_path / 'm.binary'))
    ttable = tmerl.load_measured(str(tmp_path / 'm.binary'), device='cpu')
    jobjs = _textured_objects(jscn, md, jtable, np.random.default_rng(22))
    tobjs = _textured_objects(tscn, _to_torch_md(md), ttable,
                              np.random.default_rng(22))
    jsc = jscn.build_scene(jobjs, jscn.default_light_intensity(),
                           envmap=env)
    o = jobjs[3]
    m = jmesh.upload_mesh(md, obj_row=3, use_cluster=True,
                          texture_overrides=o.textures)
    jsc = jsc.replace(meshes=(m,))
    conv = convert.scene_from_numpy(convert.numpy_fields(jsc), device='cpu')
    own = tscn.build_scene(tobjs, tscn.default_light_intensity(),
                           envmap=env, device='cpu')
    (mc,), (mo,) = conv.meshes, own.meshes
    assert mo.atlases and mo.has_alpha and mc.shade_cols == mo.shade_cols
    np.testing.assert_array_equal(mc.shade_pack.numpy(),
                                  mo.shade_pack.numpy())
    for a, b in zip(mc.atlases, mo.atlases):
        assert (a is None) == (b is None)
        if a is not None:
            for f in ('img', 'y0', 'h', 'w', 'has'):
                np.testing.assert_array_equal(getattr(a, f).numpy(),
                                              getattr(b, f).numpy())
    np.testing.assert_array_equal(conv.envmap.numpy(), own.envmap.numpy())
    np.testing.assert_array_equal(conv.obj_textures[2].kd.numpy(),
                                  own.obj_textures[2].kd.numpy())
    np.testing.assert_array_equal(conv.brdf_type.numpy(),
                                  own.brdf_type.numpy())
    np.testing.assert_array_equal(conv.measured_brdfs[0].data.numpy(),
                                  own.measured_brdfs[0].data.numpy())
    cam = tpt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(16, 12))
    cfg = trnd.RenderConfig(width=16, height=12, nrays=2, nb_bounces=3)
    s_c = trnd.render_unsplatted(conv, cam, cp, cfg)[1]
    s_o = trnd.render_unsplatted(own, cam, cp, cfg)[1]
    assert float(s_o.max()) > 0
    np.testing.assert_array_equal(s_c.numpy(), s_o.numpy())


LEAVES = ('tex', 'env', 'merl')


def _grad_scene(tmp_path):
    from test_torch_materials import _grouped_sphere
    tcp._write_merl(tmp_path / 'g.binary')
    rng = np.random.default_rng(23)
    md = _grouped_sphere(8, groups=1, uv_scale=1.0)
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(-6.0, -17.0, 0.0),
                                 textures={'kd': rng.uniform(0.2, 1.0,
                                                             (4, 4, 3))}))
    objs.append(jscn.sphere((12.0, -19.0, -3.0), 8.0,
                            measured_brdf=jmerl.load_measured(
                                str(tmp_path / 'g.binary'))))
    env = rng.uniform(0.5, 3.0, (4, 8, 3)).astype(np.float32)
    return jscn.build_scene(objs, jscn.default_light_intensity(), envmap=env)


def _with(sc, leaves):
    """Either package's scene with the texture, env map and MERL leaves."""
    mesh = sc.meshes[0]
    gt = mesh.textures[0].replace(kd=leaves['tex'])
    return sc.replace(
        envmap=leaves['env'],
        measured_brdfs=(sc.measured_brdfs[0].replace(data=leaves['merl']),),
        meshes=(mesh.replace(textures=(gt,)),))


def _leaves(sc):
    return {'tex': sc.meshes[0].textures[0].kd, 'env': sc.envmap,
            'merl': sc.measured_brdfs[0].data}


def test_texture_env_merl_grads_match_jax(tmp_path):
    w, h = 16, 12
    jsc = _grad_scene(tmp_path)
    tsc = convert.scene_from_numpy(convert.numpy_fields(jsc), device='cpu')
    cp = rng_host.random_per_pixel_fast(w, h)
    cam = ((0, 0, 50), (0, 0, -1), (0, 1, 0))

    def jloss(leaves):
        img, _ = jrnd.render_unsplatted(
            _with(jsc, leaves), jpt.make_camera(*cam), jnp.asarray(cp),
            jrnd.RenderConfig(width=w, height=h, nrays=2, nb_bounces=3))
        return jnp.mean(img) / RADIANCE

    want = {k: np.asarray(v) for k, v in jax.grad(jloss)(_leaves(jsc))
            .items()}
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in _leaves(tsc).items()}
    img, _ = trnd.render_unsplatted(
        _with(tsc, leaves), tpt.make_camera(*cam), torch.as_tensor(cp),
        trnd.RenderConfig(width=w, height=h, nrays=2, nb_bounces=3))
    got = dict(zip(LEAVES, (g.numpy() for g in torch.autograd.grad(
        img.mean() / RADIANCE, [leaves[k] for k in LEAVES]))))
    for k in LEAVES:
        scale = np.abs(want[k]).max()
        assert scale > 0 and np.count_nonzero(want[k]) > 1, k
        err = np.abs(got[k] - want[k]).max() / scale
        print(f'{k}: {err:.3g} of the largest |grad|, '
              f'{np.count_nonzero(want[k])} non-zero entries')
        assert err <= 5e-4, f'{k}: {err:.3g} of its largest |grad|'
