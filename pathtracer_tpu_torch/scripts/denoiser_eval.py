"""Denoiser quality gate: PSNR of the shipped KPCN-lite weights against
the noisy input and against the a-trous filter on a held-out scene
(counterpart of scripts/denoiser_eval.py).

The held-out scene is the flagship bench scene (three spheres: Phong,
mirror, glass), which train_denoiser.py's procedural scenes do not
include.  The gate of tests/test_denoise_net.py: the learned output more
than 2 dB over the noisy input and more than 1 dB over a-trous.

    python -m pathtracer_tpu_torch.scripts.denoiser_eval [--device cpu]
        [--size 160x96] [--spp-in 2] [--spp-ref 192] [--out eval.json]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.camera import make_camera
from ..render import denoise as dn
from ..render import denoise_net as dnn
from ..render import film as film_mod
from ..render import renderer as rnd
from ..scene import scene as scn


def flagship(device=None):
    objs = scn.default_objects()
    objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2),
                           ks=(0.1, 0.1, 0.1), ne=(30.0, 30.0, 30.0)))
    objs.append(scn.sphere((-16.0, -20.0, -10.0), 7.0, miroir=True))
    objs.append(scn.sphere((17.0, -19.0, -5.0), 8.0, transp=True,
                           refr_index=1.4))
    return scn.build_scene(objs, scn.default_light_intensity(),
                           device=device)


def evaluate(width=160, height=96, spp_in=2, spp_ref=192, device=None):
    """PSNRs (dB) of the noisy input, a-trous and KPCN-lite against a
    spp_ref reference, with the JAX function's keys; on `device` (None:
    the card)."""
    sc = flagship(device)
    cam = make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))

    def render(spp):
        cfg = rnd.RenderConfig(width=width, height=height, nrays=spp,
                               samples_per_wave=min(spp, 16),
                               has_denoiser=True)
        r = rnd.Renderer(sc, cam, cfg).render()
        n = max(r.samples_done, 1)
        nrm = r.aux[2]
        nrm = nrm / torch.clamp_min(torch.linalg.vector_norm(
            nrm, dim=-1, keepdim=True), 1e-9)
        return r.aux[0] / n, r.aux[1] / n, nrm

    color_n, albedo, nrm = render(spp_in)
    ref = _tonemap(render(spp_ref)[0])

    def psnr(img):
        mse = float(np.mean((_tonemap(img) - ref) ** 2))
        return 10.0 * np.log10(1.0 / max(mse, 1e-12))

    model = dnn.load_model(device=color_n.device)
    assert model is not None, 'shipped denoiser_weights.npz missing'
    res = {
        'scene': 'flagship-3-sphere (held out)',
        'width': width, 'height': height,
        'spp_in': spp_in, 'spp_ref': spp_ref,
        'psnr_noisy_db': psnr(color_n),
        'psnr_atrous_db': psnr(dn.atrous_denoise(color_n, albedo, nrm)),
        'psnr_learned_db': psnr(dnn.denoise_apply(model, color_n, albedo,
                                                  nrm)),
    }
    res['learned_minus_noisy_db'] = (res['psnr_learned_db']
                                     - res['psnr_noisy_db'])
    res['learned_minus_atrous_db'] = (res['psnr_learned_db']
                                      - res['psnr_atrous_db'])
    return res


def _tonemap(c):
    lin = torch.clamp_min(c.flip(0) / film_mod.RADIANCE_SCALE, 0.0)
    return torch.clamp(torch.pow(lin, 1.0 / 2.2), 0.0, 1.0).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    ap.add_argument('--size', default='160x96')
    ap.add_argument('--spp-in', type=int, default=2)
    ap.add_argument('--spp-ref', type=int, default=192)
    ap.add_argument('--out', default=None, help='also write the JSON here')
    args = ap.parse_args(argv)
    if args.device == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA device; pass --device cpu')
    w, h = (int(x) for x in args.size.split('x'))
    res = evaluate(w, h, args.spp_in, args.spp_ref, device=args.device)
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(res, f, indent=1)


if __name__ == '__main__':
    main()
