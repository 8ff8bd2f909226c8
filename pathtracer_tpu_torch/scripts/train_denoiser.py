"""Train KPCN-lite (render/denoise_net.py) on the renderer's own output
(counterpart of scripts/train_denoiser.py).

Self-supervised by spp: procedurally sampled analytic scenes rendered at
SPP_IN (noisy colour and the albedo / normal feed) and SPP_TGT (target)
by the same integrator, and the kernel-predicting CNN learns to map one
to the other on random CROP x CROP crops, BATCH a step, with the L1 loss
in log space, Adam and a cosine decay from LR over the steps (optax's
adam(cosine_decay_schedule(LR, steps)): the schedule's count is 0 at the
first update).  The last scene is held out.

    python -m pathtracer_tpu_torch.scripts.train_denoiser \\
        [--scenes 10] [--steps 1500] [--out kpcn_weights.npz] [--device cpu]

Runs on the card unless --device cpu.  Writes the weights in the JAX
package's flax layout (`Conv_<i>/kernel` HWIO, `Conv_<i>/bias`), which
both packages load, to --out, only when the model beats the noisy input
by 2x in log-MSE on the held-out scene, as the JAX script does; the
shipped render/denoiser_weights.npz is written only when --out names it.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..core.camera import make_camera
from ..render import denoise as dn
from ..render import denoise_net as dnn
from ..render.denoise_net import save_weights
from ..render import renderer as rnd
from ..scene import scene as scn

W, H = 256, 144
SPP_IN, SPP_TGT = 4, 128
N_SCENES = 10
CROP, BATCH, STEPS = 64, 8, 1500
LR = 2e-3
CAM = ((0, 0, 50), (0, 0, -1), (0, 1, 0))


def sample_scene(seed, device=None):
    """The JAX script's procedural scene: the default slate and 3-6
    spheres (mirror, glass or Phong) and a scaled light, from `seed`."""
    rng = np.random.default_rng(seed)
    objs = scn.default_objects()
    for _ in range(int(rng.integers(3, 7))):
        c = (float(rng.uniform(-25, 25)), float(rng.uniform(-24, 0)),
             float(rng.uniform(-20, 10)))
        r = float(rng.uniform(2.5, 8.0))
        kind = rng.random()
        if kind < 0.15:
            objs.append(scn.sphere(c, r, miroir=True))
        elif kind < 0.3:
            objs.append(scn.sphere(c, r, transp=True,
                                   refr_index=float(rng.uniform(1.2, 1.6))))
        else:
            kd = tuple(float(x) for x in rng.uniform(0.1, 0.9, 3))
            ks = tuple(float(x) for x in rng.uniform(0.0, 0.4, 3))
            ne = (float(rng.uniform(5, 200)),) * 3
            objs.append(scn.sphere(c, r, kd=kd, ks=ks, ne=ne))
    return scn.build_scene(objs, scn.default_light_intensity()
                           * float(rng.uniform(0.5, 2.0)), device=device)


def render_buffers(sc, cam, spp, width=W, height=H):
    """Per-pixel mean (colour, albedo, normal) over `spp` samples."""
    cfg = rnd.RenderConfig(width=width, height=height, nrays=spp,
                           samples_per_wave=spp, has_denoiser=True)
    r = rnd.Renderer(sc, cam, cfg)
    r.step(spp)
    return tuple(a / spp for a in r.aux)


def make_dataset(n_scenes, width=W, height=H, spp_in=SPP_IN,
                 spp_tgt=SPP_TGT, device=None, log=print):
    """(cin, albedo, normal, target) per scene of seeds 1000.. 1000 +
    n_scenes (the last is the held-out scene)."""
    cam = make_camera(*CAM)
    data = []
    t0 = time.perf_counter()
    for s in range(n_scenes + 1):
        sc = sample_scene(1000 + s, device)
        cin, alb, nrm = render_buffers(sc, cam, spp_in, width, height)
        data.append((cin, alb, nrm,
                     render_buffers(sc, cam, spp_tgt, width, height)[0]))
        log(f'scene {s}: rendered ({time.perf_counter() - t0:.0f}s)')
    return data


def denoise(model, color, albedo, normal):
    """KPCN-lite's output, differentiable (denoise_net.denoise_apply runs
    under no_grad)."""
    return dnn.apply_kernels(color, model(dnn.features_from_buffers(
        color, albedo, normal)))


def log_radiance(x):
    """log1p of radiance clamped at 0.  The renderer emits negative
    radiance on a few pixels (in both packages, ROADMAP Queue 3), and the
    JAX script's unclamped log1p makes the loss NaN wherever a value is
    below -1; on non-negative radiance the two agree bit for bit."""
    return torch.log1p(torch.clamp_min(x, 0.0))


def batch_loss(model, cin, alb, nrm, ctgt):
    """Mean L1 in log space over a batch of (B, h, w, 3) crops."""
    out = torch.stack([denoise(model, c, a, n)
                       for c, a, n in zip(cin, alb, nrm)])
    return torch.mean(torch.abs(log_radiance(out) - log_radiance(ctgt)))


def cosine_lr(count, steps, init=LR):
    """optax.cosine_decay_schedule(init, steps) at `count`, in float32."""
    c = np.float32(min(count, steps))
    decay = np.float32(0.5) * (np.float32(1.0) + np.cos(
        np.float32(math.pi) * c / np.float32(steps)))
    return float(np.float32(init) * decay)


def make_step(model, steps):
    """step(batch) -> loss: Adam with optax's constants (b1
    0.9, b2 0.999, eps 1e-8 outside the square root), the learning rate
    cosine_lr(count) with count 0 at the first update."""
    opt = torch.optim.Adam(model.parameters(), lr=cosine_lr(0, steps),
                           betas=(0.9, 0.999), eps=1e-8)
    count = [0]

    def step(batch):
        for g in opt.param_groups:
            g['lr'] = cosine_lr(count[0], steps)
        opt.zero_grad()
        loss = batch_loss(model, *batch)
        loss.backward()
        opt.step()
        count[0] += 1
        return float(loss.detach())

    return step


def make_batch(train, rng, crop=CROP, batch=BATCH):
    """BATCH random crops, drawn from `rng` as the JAX script draws them."""
    out = [[], [], [], []]
    h, w = train[0][0].shape[0], train[0][0].shape[1]
    for _ in range(batch):
        bufs = train[rng.integers(len(train))]
        i = rng.integers(0, h - crop)
        j = rng.integers(0, w - crop)
        for k, buf in enumerate(bufs):
            out[k].append(buf[i:i + crop, j:j + crop])
    return tuple(torch.stack(x) for x in out)


def train(data, steps=STEPS, crop=CROP, batch=BATCH, seed=0, log=print):
    """Train a fresh KPCNLite (torch's initialisation from `seed`) on
    data[:-1]; returns (model, losses)."""
    torch.manual_seed(seed)
    model = dnn.KPCNLite().to(data[0][0].device)
    step = make_step(model, steps)
    rng = np.random.default_rng(7)
    losses = []
    t0 = time.perf_counter()
    for it in range(steps):
        losses.append(step(make_batch(data[:-1], rng, crop, batch)))
        if it % 150 == 0:
            log(f'step {it}: loss {losses[-1]:.4f} '
                f'({time.perf_counter() - t0:.0f}s)')
    return model, losses


def held_out_mse(model, held):
    """Held-out log-MSE of the noisy input, the a-trous filter and the
    model."""
    cin, alb, nrm, ctgt = held

    def mse(a):
        return float(torch.mean((log_radiance(a) - log_radiance(ctgt)) ** 2))

    return dict(noisy=mse(cin), atrous=mse(dn.atrous_denoise(cin, alb, nrm)),
                learned=mse(dnn.denoise_apply(model, cin, alb, nrm)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--scenes', type=int, default=N_SCENES,
                    help='training scenes (one more is held out)')
    ap.add_argument('--steps', type=int, default=STEPS)
    ap.add_argument('--out', default='kpcn_weights.npz',
                    help='weights file (render/denoiser_weights.npz only '
                    'when named here)')
    ap.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA device; pass --device cpu')
    data = make_dataset(args.scenes, device=dev)
    model, _ = train(data, args.steps)
    m = held_out_mse(model, data[-1])
    print(f"held-out log-MSE: noisy {m['noisy']:.5f}  atrous "
          f"{m['atrous']:.5f}  learned {m['learned']:.5f}", flush=True)
    if m['learned'] * 2.0 <= m['noisy']:
        save_weights(model, args.out)
        print('saved', args.out, flush=True)
    else:
        print('NOT saved: model does not beat noisy by 2x', flush=True)


if __name__ == '__main__':
    main()
