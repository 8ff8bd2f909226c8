"""Carry a scene built by the JAX package across to the port.

`numpy_fields` flattens any dataclass tree (the JAX package's SceneArrays
and MeshArrays are dataclasses) into plain dicts, lists and numpy arrays;
it never imports JAX.  `scene_from_numpy` builds the port's SceneArrays
from such a dict, including each mesh's tier arrays (the clustered arrays
re-laid out by ops.cluster.from_tpu_arrays, or the soup, BVH and packed
packet-tier nodes of a mesh uploaded with use_cluster=False),
shade_pack, flags and static metadata, the materials (group textures
and channel atlases, analytic-row textures, the env map and the measured
BRDF tables with their per-row selector), the media: fog parameters
and flags, ghost rows, subsurface flags and the background photo, and
the point sets (with their particle-cluster boxes and flags) and yarn
sets.  So both packages can trace exactly the same scene.  `fluid_state`
carries the fluid simulator's state across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as device_mod
from .models import merl as merl_mod
from .models import texture as tex_mod
from .ops import cluster
from .ops import packet_bvh
from .ops import traverse
from .parallel import scene_shard
from .scene import mesh as mesh_mod
from .scene import pointset as ps_mod
from .scene import scene as scn
from .scene import yarns as yarn_mod
from .sim import fluid


def numpy_fields(obj):
    """Dataclass trees -> dicts; tuples / lists -> lists; arrays -> numpy;
    None and Python scalars unchanged."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: numpy_fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [numpy_fields(x) for x in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def _textures(d: dict, dev):
    """GroupTextures from a numpy_fields dict (None entries stay None)."""
    return tex_mod.GroupTextures(**{
        ch: None if d.get(ch) is None else torch.as_tensor(
            np.array(d[ch], np.float32, order='C'), device=dev)
        for ch in tex_mod.CHANNELS})


def _atlas(d, dev):
    if d is None:
        return None
    return tex_mod.ChannelAtlas(
        img=torch.as_tensor(np.array(d['img'], np.float32, order='C'),
                            device=dev),
        **{k: torch.as_tensor(np.array(d[k], np.int32), device=dev)
           for k in ('y0', 'h', 'w')},
        has=torch.as_tensor(np.array(d['has'], bool), device=dev))


def _mesh_from_numpy(m: dict, dev, scene_rank=None) -> mesh_mod.MeshArrays:
    sharded = m.get('scene_axis') is not None
    if sharded:
        # a JAX scene-axis mesh holds every partition under a leading
        # (D,) axis; a rank of the port holds its own only
        if scene_rank is None:
            raise NotImplementedError(
                'a port mesh holds one rank\'s partition of a scene-axis '
                'mesh, never all of them (ROADMAP Queue 1 item 12): pass '
                'scene_rank')
        if m.get('use_routed'):
            raise NotImplementedError(
                'a scene-axis partition of a routed mesh (use_routed=True) '
                'is not ported (ROADMAP Queue 1 item 13)')
        m = dict(m, shade_pack=np.asarray(m['shade_pack'])[scene_rank],
                 soup=None, use_packet=False, use_brute=False)

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32, order="C"), device=dev)

    def tensors(xs):
        return [torch.as_tensor(np.array(x), device=dev)
                for x in xs]

    soup = bvh = packed = None
    if m.get('soup') is not None:
        soup = traverse.TriSoup(*tensors(m['soup']))
        bvh = traverse.BVHArrays(*tensors(m['bvh']))
    if m['use_packet'] and m['packed']:
        lox, loy, loz, hix, hiy, hiz, na, nb, nleaf = m['packed']
        box = np.stack([lox, loy, loz, hix, hiy, hiz], axis=1)
        packed = packet_bvh.packed_from_arrays(
            *(np.asarray(x) for x in (box, na, nb, nleaf)),
            int(m['max_leaf']), dev)
    g = np.asarray(m['g_kd']).shape[0]
    n_tris = int(m['n_tris'])
    if n_tris < 0:
        n_tris = int(np.asarray(m['shade_pack']).shape[0])
    if sharded:
        clustered = scene_shard.shard_from_numpy_arrays(m['clustered'],
                                                        scene_rank, dev)
    else:
        clustered = (cluster.from_tpu_arrays(m['clustered'], dev)
                     if m['use_cluster'] else None)
    return mesh_mod.MeshArrays(
        clustered=clustered,
        shade_pack=f32(m['shade_pack']),
        shade_cols=tuple((str(nm), int(s), int(w))
                         for nm, s, w in m['shade_cols']),
        g_kd=f32(m['g_kd']), g_ks=f32(m['g_ks']), g_ne=f32(m['g_ne']),
        g_ksub=f32(np.broadcast_to(m['g_ksub'], (g, 3))),
        g_transp=torch.as_tensor(np.array(m['g_transp'], bool), device=dev),
        g_refr=f32(m['g_refr']),
        obj_row=int(m['obj_row']), n_tris=n_tris,
        interp_normals=bool(m['interp_normals']),
        backface_cull=bool(m['backface_cull']),
        soup=soup, bvh=bvh, packed=packed, max_leaf=int(m['max_leaf']),
        use_brute=bool(m['use_brute']), use_packet=packed is not None,
        use_cluster=bool(m['use_cluster']),
        use_routed=bool(m.get('use_routed', False)),
        textures=tuple(_textures(gt, dev) for gt in m['textures']),
        atlases=tuple(_atlas(a, dev) for a in m.get('atlases') or ()),
        bilinear=bool(m.get('bilinear', False)),
        cutout_rounds=int(m.get('cutout_rounds', 4)),
        display_edges=bool(m.get('display_edges', False)),
        group_rows=(None if m.get('group_rows') is None else torch.as_tensor(
            np.array(m['group_rows'], np.int64), device=dev)),
        world_space=bool(m.get('world_space', False)),
        shard_row0=(int(np.asarray(m['shard_row0'])[scene_rank])
                    if sharded else None),
        shard_rows=(int(np.asarray(m['shard_rows'])[scene_rank])
                    if sharded else None))


def scene_from_numpy(fields: dict, device=None,
                     scene_rank=None) -> scn.SceneArrays:
    """The port's SceneArrays from `numpy_fields(jax_scene)`, on `device`
    (None: the card).  A scene-axis mesh converts to rank `scene_rank`'s
    partition (parallel/scene_shard.py), not yet bound to a process
    group."""
    f = fields
    device = device_mod.resolve(device)

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32, order="C"), device=device)

    def bools(x):
        return torch.as_tensor(np.array(x, bool), device=device)

    def opt(name, to):
        return None if f.get(name) is None else to(f[name])

    return scn.SceneArrays(
        obj_type=torch.as_tensor(np.array(f['obj_type'], np.int32),
                                 device=device),
        center=f32(f['center']), radius=f32(f['radius']),
        normal=f32(f['normal']), flip_normals=bools(f['flip_normals']),
        kd=f32(f['kd']), ks=f32(f['ks']), ne=f32(f['ne']),
        ksub=f32(f['ksub']), transp=bools(f['transp']),
        refr_index=f32(f['refr_index']), miroir=bools(f['miroir']),
        ghost=bools(f['ghost']),
        trans=f32(f['trans']), inv_trans=f32(f['inv_trans']),
        rot=f32(f['rot']),
        identity_transform=bool(f['identity_transform']),
        light_intensity=f32(f['light_intensity']),
        light_scale=f32(f['light_scale']),
        envmap_intensity=f32(f['envmap_intensity']),
        center_light=f32(f['center_light']),
        radius_light=f32(f['radius_light']),
        meshes=tuple(_mesh_from_numpy(m, device, scene_rank)
                     for m in f['meshes']),
        envmap=None if f.get('envmap') is None else f32(f['envmap']),
        obj_textures=tuple(None if t is None else _textures(t, device)
                           for t in f.get('obj_textures') or ()),
        brdf_type=(None if f.get('brdf_type') is None else torch.as_tensor(
            np.array(f['brdf_type'], np.int32), device=device)),
        measured_brdfs=tuple(
            merl_mod.MeasuredBRDF(data=f32(t['data']), kind=int(t['kind']),
                                  dims=tuple(int(x) for x in t['dims']),
                                  path=str(t.get('path') or ''))
            for t in f.get('measured_brdfs') or ()),
        **{k: opt(k, f32) for k in ('fog_density', 'fog_absorption',
                                    'fog_density_decay',
                                    'fog_absorption_decay', 'phase_aniso',
                                    'ground_level', 'background')},
        fog_enabled=bool(f.get('fog_enabled', False)),
        fog_type=int(f.get('fog_type', 0)),
        fog_phase_type=int(f.get('fog_phase_type', 0)),
        ss_enabled=bool(f.get('ss_enabled', False)),
        ss_obj_ok=opt('ss_obj_ok', bools),
        ghost_enabled=bool(f.get('ghost_enabled', False)),
        pointsets=tuple(_pointset_from_numpy(p, device)
                        for p in f.get('pointsets') or ()),
        yarns=tuple(_yarns_from_numpy(y, device)
                    for y in f.get('yarns') or ()))


def _tensor_or_none(x, dev):
    return None if x is None else torch.as_tensor(
        np.array(x, np.float32, order='C'), device=dev)


def _pointset_from_numpy(p: dict, dev) -> ps_mod.PointSetArrays:
    arrays = ('px', 'py', 'pz', 'nx', 'ny', 'nz', 'radius', 'colors',
              'c_lox', 'c_loy', 'c_loz', 'c_hix', 'c_hiy', 'c_hiz')
    return ps_mod.PointSetArrays(
        **{k: _tensor_or_none(p.get(k), dev) for k in arrays},
        obj_row=int(p['obj_row']), n_clusters=int(p['n_clusters']),
        display_edges=bool(p['display_edges']),
        as_spheres=bool(p['as_spheres']),
        transparent=bool(p['transparent']))


def _yarns_from_numpy(y: dict, dev) -> yarn_mod.YarnArrays:
    return yarn_mod.YarnArrays(
        **{k: _tensor_or_none(y[k], dev)
           for k in ('ax', 'ay', 'az', 'ux', 'uy', 'uz', 'length', 'radius')},
        obj_row=int(y['obj_row']))


def fluid_state(fields, device=None) -> fluid.FluidState:
    """The port's FluidState from `numpy_fields(jax_state)` (a JAX
    FluidState is a NamedTuple, so numpy_fields gives its fields as a
    list in FluidState order; a dict by field name is taken too), on
    `device` (None: the card)."""
    dev = device_mod.resolve(device)
    if not isinstance(fields, dict):
        fields = dict(zip(fluid.FluidState._fields, fields))
    return fluid.FluidState(**{
        k: torch.as_tensor(np.array(fields[k], order='C'), device=dev)
        for k in fluid.FluidState._fields})


def kpcn_state_dict(flat: dict) -> dict:
    """The JAX package's KPCN-lite weights, flattened as its
    denoise_net.save_weights writes them (`Conv_<i>/kernel` HWIO,
    `Conv_<i>/bias`, numpy arrays), as a state dict of the port's
    render.denoise_net.KPCNLite: kernels OIHW, biases as they are."""
    out = {}
    i = 0
    while f'Conv_{i}/kernel' in flat:
        k = np.asarray(flat[f'Conv_{i}/kernel'], np.float32)
        out[f'convs.{i}.weight'] = torch.as_tensor(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        out[f'convs.{i}.bias'] = torch.as_tensor(
            np.array(flat[f'Conv_{i}/bias'], np.float32))
        i += 1
    extra = set(flat) - {f'Conv_{n}/{p}' for n in range(i)
                         for p in ('kernel', 'bias')}
    if extra:
        raise ValueError(f'keys other than Conv_<i>/kernel, bias: '
                         f'{sorted(extra)}')
    return out
