"""PyTorch port, the headless entry point against the JAX package: the
.scn importer and writer, the CLI (`python -m pathtracer_tpu_torch.cli
... --cpu`), checkpoint/resume and the preemption guard.

The .scn tests read tests/test_scn_import.py's reference text and a
programmatic scene (keyframes, fog, a lenticular camera, a mesh) through
both packages and require the same fields; the port's writer must write
the JAX writer's bytes.  The CLI runs as a subprocess with --cpu (the
mirror of test_hdr_autosave.py, test_scn_roundtrip.py:110-138 and
test_checkpoint.py); its preemption is forced by a guard that is
requested from the start, so --checkpoint exits 75 after one wave and a
second run resumes bit-equal to a straight render.
"""

import dataclasses
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu.core import camera as jcam
from pathtracer_tpu.io import obj as jobj
from pathtracer_tpu.io import scn_export as jexp
from pathtracer_tpu.io import scn_import as jimp
from pathtracer_tpu.render.renderer import RenderConfig as JConfig
from pathtracer_tpu.scene import scene as jscn
import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.io import image as image_io
from pathtracer_tpu_torch.io import obj as tobj
from pathtracer_tpu_torch.io import scene_json
from pathtracer_tpu_torch.io import scn_export as texp
from pathtracer_tpu_torch.io import scn_import as timp
from pathtracer_tpu_torch.parallel import distributed as tdist
from pathtracer_tpu_torch.render import renderer as trnd
from pathtracer_tpu_torch.scene import scene as tscn
from pathtracer_tpu_torch.utils import procgen

from test_scn_import import SCN
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE = ((0, 0, 50), (0, 0, -1), (0, 1, 0))
SPEC_FIELDS = ('obj_type', 'miroir', 'ghost', 'transp', 'flip_normals',
               'interp_normals', 'display_edges', 'scale', 'refr_index',
               'center', 'radius', 'normal', 'translation', 'rotation',
               'rotation_center', 'kd', 'ks', 'ne', 'ksub', 'edge_csv',
               'name', 'envmap_file')


def _assert_same_specs(jobjs, tobjs):
    assert len(jobjs) == len(tobjs)
    for a, b in zip(jobjs, tobjs):
        for f in SPEC_FIELDS:
            u, v = getattr(a, f, None), getattr(b, f)
            if f == 'envmap_file' and u is None:
                assert v is None, f
            elif isinstance(u, (str, type(None))):
                assert u == v, f
            else:
                np.testing.assert_array_equal(np.asarray(v, np.float64),
                                              np.asarray(u, np.float64),
                                              err_msg=f)
        assert (a.keyframes is None) == (b.keyframes is None)
        if a.keyframes:
            assert sorted(a.keyframes) == sorted(b.keyframes)
            for k in a.keyframes:
                for c, x in a.keyframes[k].items():
                    np.testing.assert_array_equal(
                        np.asarray(b.keyframes[k][c]), np.asarray(x))
        if a.mesh_data is not None:
            assert getattr(a, 'is_centered', True) == b.is_centered
            np.testing.assert_array_equal(b.mesh_data.vertices,
                                          a.mesh_data.vertices)
            np.testing.assert_array_equal(b.mesh_data.vtx_idx,
                                          a.mesh_data.vtx_idx)


def _assert_same_camera(cj, ct):
    for f in ('position', 'direction', 'up', 'fov', 'focus_distance',
              'aperture', 'lenticular_max_angle'):
        np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                      np.asarray(getattr(cj, f)), err_msg=f)
    for f in ('is_lenticular', 'lenticular_nb_images',
              'lenticular_pixel_width'):
        assert getattr(ct, f) == getattr(cj, f), f


def _assert_same_parse(pj, pt):
    oj, lj, cj, fj, ej = pj
    ot, lt, ct, ft, et = pt
    _assert_same_specs(oj, ot)
    assert lj == lt
    _assert_same_camera(cj, ct)
    assert tuple(fj) == tuple(ft) and ft._fields == fj._fields
    assert ej == et


def test_load_reference_scn_matches_jax(tmp_path):
    p = tmp_path / 'scene.scn'
    p.write_text(SCN)
    pj = jimp.load_scn(str(p))
    pt = timp.load_scn(str(p), device='cpu')
    _assert_same_parse(pj, pt)
    assert pt[3].width == 320 and pt[3].nrays == 12
    # the loaded scene builds and renders in the port
    objs, li, cam, cfg, ex = pt
    sc = tscn.build_scene(objs, li, fog=ex['fog'], device='cpu')
    img = trnd.Renderer(sc, cam, cfg._replace(width=16, height=12,
                                              nrays=1)).render().hdr()
    assert torch.isfinite(img).all() and float(img.max()) > 0


def _programmatic(mod, cam_mod, cfg_cls, obj_path):
    """Keyframes, fog, a lenticular camera, mirror / transparent flags and
    a mesh loaded from an OBJ (not centred)."""
    objs = [
        mod.sphere((10., 23., 15.), 10., kd=(1., 1., 1.)),
        mod.sphere((0., 0., 0.), 1e6, flip_normals=True),
        mod.plane((0., 0., 0.), (0., 1., 0.), translation=(0., -27.3, 0.)),
        mod.sphere((0., -17., 0.), 10., kd=(.7, .3, .2), miroir=True,
                   keyframes={0.0: {'translation': (0., 0., 0.)},
                              10.0: {'translation': (5., 0., 0.),
                                     'scale': 2.0}}),
        mod.sphere((15., -17., 0.), 6., transp=True, refr_index=1.5,
                   ks=(.2, .2, .2), ne=(80., 80., 80.)),
    ]
    obj_mod = jobj if mod is jscn else tobj
    md = obj_mod.load_mesh(obj_path, scaling=1.0, center=False)
    spec = mod.mesh_object(md, translation=(0., -15., 0.), kd=(.2, .5, .3))
    spec.name = os.path.basename(obj_path)
    spec.is_centered = False
    objs.append(spec)
    cam = cam_mod.make_camera((0, 1, 55), (0, 0, -1), (0, 1, 0), fov=0.7,
                              focus_distance=40.0, aperture=0.3,
                              is_lenticular=True, lenticular_nb_images=6,
                              lenticular_pixel_width=2)
    cfg = cfg_cls(width=640, height=360, nrays=32, nb_bounces=5,
                  sigma_filter=0.7, gamma=2.2, double_frustum_start_t=3.5,
                  has_denoiser=True)
    extras = {'envmap_intensity': 2.5,
              'fog': {'density': 0.1, 'absorption': 0.4,
                      'density_decay': 0.02, 'absorption_decay': 0.02,
                      'type': 1, 'phase_type': 2}}
    return objs, 2.5e9, cam, cfg, extras


@pytest.fixture
def obj_file(tmp_path):
    md = procgen.sphere_mesh(8, 8, radius=5.0, displace_amp=0.2)
    path = str(tmp_path / 'ball.obj')
    tobj.save_obj(tobj.MeshData(**{f.name: getattr(md, f.name) for f in
                                   dataclasses.fields(tobj.MeshData)}),
                  path)
    return path


def test_save_scn_matches_jax_writer(tmp_path, obj_file):
    """Both writers write the same bytes; each package parses the other's
    file to the same fields; load -> save is a fixed point."""
    pj = _programmatic(jscn, jcam, JConfig, obj_file)
    pt = _programmatic(tscn, tpt, trnd.RenderConfig, obj_file)
    fj, ft = tmp_path / 'j.scn', tmp_path / 't.scn'
    jexp.save_scn(str(fj), *pj)
    texp.save_scn(str(ft), *pt)
    assert ft.read_text() == fj.read_text()
    text = ft.read_text()
    assert 'is_lenticular: 1' in text and 'has_denoiser: 1' in text
    assert 'nb_transforms: 2' in text and 'is_centered: 0' in text
    back_t = timp.load_scn(str(ft), device='cpu')
    _assert_same_parse(jimp.load_scn(str(ft)), back_t)
    _assert_same_parse(jimp.load_scn(str(fj)),
                       timp.load_scn(str(fj), device='cpu'))
    assert back_t[2].is_lenticular and back_t[2].lenticular_nb_images == 6
    assert back_t[0][-1].mesh_data.num_triangles \
        == pt[0][-1].mesh_data.num_triangles > 0
    f2, f3 = tmp_path / 'b.scn', tmp_path / 'c.scn'
    texp.save_scn(str(f2), *back_t)
    texp.save_scn(str(f3), *timp.load_scn(str(f2), device='cpu'))
    assert f2.read_text() == f3.read_text()
    # the reference text round-trips in the port alone too
    p = tmp_path / 'ref.scn'
    p.write_text(SCN)
    texp.save_scn(str(f2), *timp.load_scn(str(p), device='cpu'))
    texp.save_scn(str(f3), *timp.load_scn(str(f2), device='cpu'))
    assert f2.read_text() == f3.read_text()


def test_loaded_scn_renders_lenticular(tmp_path, obj_file):
    """A file written by the port's writer (always with its lenticular
    block) loads and renders in the port, keyframes evaluated."""
    path = tmp_path / 'prog.scn'
    texp.save_scn(str(path), *_programmatic(tscn, tpt, trnd.RenderConfig,
                                            obj_file))
    objs, li, cam, cfg, ex = timp.load_scn(str(path), device='cpu')
    sc = tscn.build_scene(objs, li, fog=ex['fog'], frame=5.0, device='cpu')
    r = trnd.Renderer(sc, cam, cfg._replace(width=16, height=12, nrays=1,
                                            nb_bounces=2)).render()
    assert np.isfinite(r.hdr().numpy()).all() and float(r.hdr().max()) > 0
    # has_denoiser is written but, as in JAX, not read back: --denoise
    # sets it
    assert not cfg.has_denoiser


def _cli(args, cwd, preempt=False, timeout=300):
    """Run the port's CLI with --cpu in a subprocess; with `preempt` its
    PreemptionGuard is requested from the start."""
    code = ('import sys; from pathtracer_tpu_torch import cli\n'
            'from pathtracer_tpu_torch.parallel import distributed as d\n')
    if preempt:
        code += ('class G(d.PreemptionGuard):\n'
                 '    def __enter__(self):\n'
                 '        super().__enter__(); self.requested = True\n'
                 '        return self\n'
                 'd.PreemptionGuard = G\n')
    code += f'sys.exit(cli.main({list(args) + ["--cpu"]!r}))\n'
    return subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=cwd, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=REPO))


@pytest.fixture
def scene_file(tmp_path):
    objs = tscn.default_objects()
    objs.append(tscn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2)))
    cfg = trnd.RenderConfig(width=24, height=16, nrays=2)
    path = str(tmp_path / 'scene.json')
    scene_json.save_scene(path, objs, tscn.default_light_intensity(),
                          tpt.make_camera(*POSE), cfg)
    return path


def test_cli_autosave_names_and_hdr(tmp_path, scene_file):
    out = str(tmp_path / 'out.png')
    res = _cli([scene_file, out, '--progressive', '--autosave', '--frame',
                '7', '--denoise'], REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    for name in ('out.png', 'exportD7.jpg', 'exportE7.jpg',
                 'exportEFiltered7.jpg'):
        assert os.path.exists(tmp_path / name), name
    assert 'saved low-res preview' in res.stdout
    assert any(ln.startswith('rendered 24x16 @2spp in ') and
               'M live rays/s' in ln for ln in res.stdout.splitlines())
    res = _cli([scene_file, str(tmp_path / 'out.hdr')], REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    hdr = image_io.load_hdr(str(tmp_path / 'out.hdr'))
    assert hdr.shape == (16, 24, 3)
    assert np.isfinite(hdr).all() and hdr.max() > 0


def test_cli_save_scn(tmp_path, scene_file):
    scn_out = str(tmp_path / 'back.scn')
    res = _cli([scene_file, str(tmp_path / 'out.hdr'), '--save-scn',
                scn_out, '--spp', '1', '--size', '12x8'], REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    objs, _, _, cfg, _ = timp.load_scn(scn_out, device='cpu')
    assert len(objs) == 4
    assert (cfg.width, cfg.height, cfg.nrays) == (12, 8, 1)
    np.testing.assert_allclose(objs[3].kd, (.7, .3, .2), atol=1e-6)
    assert jimp.load_scn(scn_out)[3].width == 12      # JAX reads it too
    # the written .scn renders through the CLI in turn
    res = _cli([scn_out, str(tmp_path / 'again.hdr')], REPO)
    assert res.returncode == 0, res.stderr[-2000:]


def test_cli_checkpoint_preempted_then_resumed(tmp_path, scene_file):
    ck = str(tmp_path / 'ck.npz')
    # 8 samples, 4 a wave: preempted after the first wave
    args = [scene_file, str(tmp_path / 'out.hdr'), '--spp', '8',
            '--checkpoint', ck]
    res = _cli(args, REPO, preempt=True)
    assert res.returncode == 75, res.stderr[-2000:]
    assert 'preempted at 4/8 spp' in res.stdout and os.path.exists(ck)
    assert not os.path.exists(tmp_path / 'out.hdr')
    res = _cli(args, REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    assert not os.path.exists(ck)
    res = _cli([scene_file, str(tmp_path / 'straight.hdr'), '--spp', '8'],
               REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    np.testing.assert_array_equal(
        image_io.load_hdr(str(tmp_path / 'out.hdr')),
        image_io.load_hdr(str(tmp_path / 'straight.hdr')))


def _renderer(nrays=4, spw=1, width=24):
    objs = tscn.default_objects()
    objs.append(tscn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2)))
    sc = tscn.build_scene(objs, tscn.default_light_intensity(), device='cpu')
    cfg = trnd.RenderConfig(width=width, height=16, nrays=nrays,
                            samples_per_wave=spw, has_denoiser=True)
    return lambda c=cfg: trnd.Renderer(sc, tpt.make_camera(*POSE), c)


def test_resume_bit_equal_and_config_checked(tmp_path):
    make = _renderer()
    straight = make().render()
    half = make().step(2)
    ck = str(tmp_path / 'ck.npz')
    half.save_checkpoint(ck)
    with np.load(ck) as d:
        assert sorted(d.files) == sorted(
            ['image', 'sample_count', 'aux0', 'aux1', 'aux2', 'samples_done',
             'rays_traced', 'ss_overflow', 'cfg'])
    resumed = make().load_checkpoint(ck)
    assert resumed.samples_done == 2
    assert resumed.rays_traced == half.rays_traced
    resumed.render()
    assert torch.equal(resumed.image, straight.image)
    assert torch.equal(resumed.sample_count, straight.sample_count)
    assert all(torch.equal(a, b) for a, b in zip(resumed.aux, straight.aux))
    assert resumed.rays_traced == straight.rays_traced
    other = make(trnd.RenderConfig(width=24, height=16, nrays=8,
                                   has_denoiser=True))
    with pytest.raises(ValueError, match='different RenderConfig'):
        other.load_checkpoint(ck)
    with pytest.raises(ValueError, match='.npz'):
        make().render_resumable(str(tmp_path / 'ck.bin'))


def test_preemption_guard_resumable_render(tmp_path):
    """SIGUSR1 mid-render: the wave finishes, the checkpoint is written,
    the call returns early; a second call completes bit-equal to a
    straight render and removes the checkpoint."""
    make = _renderer()
    straight = make().render()
    ck = str(tmp_path / 'pre.npz')
    r = make()
    with tdist.PreemptionGuard(signals=(signal.SIGUSR1,)) as g:
        os.kill(os.getpid(), signal.SIGUSR1)
        r.render_resumable(ck, guard=g)
    assert g.requested and r.samples_done < 4 and os.path.exists(ck)
    r2 = make().render_resumable(ck)
    assert r2.samples_done == 4 and not os.path.exists(ck)
    assert torch.equal(r2.display(), straight.display())
    r3 = make().render_resumable(ck, save_every=2)
    assert r3.samples_done == 4 and not os.path.exists(ck)


def test_preemption_guard_restores_and_chains_handlers():
    seen = []
    before = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        outer = signal.getsignal(signal.SIGUSR1)
        with tdist.PreemptionGuard(signals=(signal.SIGUSR1,)) as g:
            assert signal.getsignal(signal.SIGUSR1) != outer
            assert not g.requested
            os.kill(os.getpid(), signal.SIGUSR1)
        assert g.requested and seen == [signal.SIGUSR1]
        assert signal.getsignal(signal.SIGUSR1) == outer
    finally:
        signal.signal(signal.SIGUSR1, before)


def test_checkpoint_path_per_process(monkeypatch):
    import torch.distributed as dist
    assert tdist.checkpoint_path('/x/ck.npz') == '/x/ck.npz'
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_world_size', lambda: 4)
    monkeypatch.setattr(dist, 'get_rank', lambda: 3)
    assert tdist.checkpoint_path('/x/ck.npz') == '/x/ck.p3.npz'
