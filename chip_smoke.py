"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--profile-all]

--profile-all also profiles one wave of the main path, of scene M and of
scene O (items 5, 9 and 10); without it those phases keep every check and
timed wave but skip their profiled split (scene O's costs about 110 s,
scene M's about 40 s, the main path's 14-19 s on an H100), so the whole
run stays well inside its time limit.

1. Refuses to run without a CUDA device (no CPU fallback); prints the
   torch version, the card's name and power limit, and its fp32 issue
   rate.
2. Builds the hand-written CUDA kernels (csrc/*.cu, one nvcc process per
   source, all started together) and prints the build time and the ptxas
   reports.
   Then the PCG phase (pcg_phase): the PCG32 kernel (csrc/pcg_draw.cu)
   on one 1080p sample pass of lanes, seed, gated draw and gated pair
   bit-equal to core/rng.py's plain versions (also at an odd count),
   each timed over PCG_REPS bare launches beside its bytes bound
   (PCG_DRAW_BYTES, PCG_PAIR_BYTES, PCG_SEED_BYTES a lane), the
   wrapper's time a call and the plain chain's; then one 1080p flagship
   sample pass with the draw calls and launches counted (counted_draws:
   one launch a call, no plain call) and its film bit-equal to the plain
   draws' (plain_draws).  The kernel's one counter
   (the recorder's pcg_draw.launches, seed and draws) is read with the
   other kernels' on the main path and on every later phase, and each
   phase that renders asserts that it launched.
3. Kernel phase: the bench's 2.4M-triangle displaced sphere, 1080p primary
   rays and one batch of shadow rays from their hits to the light, culled
   as the first round of the main path (4,050 packets).  Prints each sweep
   kernel's registers, resident blocks per SM and shared bytes at every
   lane group size G in cluster.GROUPS.  At each G both sweeps run in one
   launch over every packet and must equal their plain versions bit for
   bit (t, tri, occlusion) and in every group's counters (slots visited,
   clusters entered, subtile slab tests, subtiles swept); each is timed
   with CUDA events heaviest first, in packet order and as CHUNK_PACKETS
   launches, and its counters are summarized (cycles per group mean, p99,
   max; the heaviest 1% of groups' share; slots and subtiles per group).
   The kernel records are at cluster.SWEEP_GROUP, their bound from the
   lane x subtile rows that G tests (and, beside it, from G = 512's).
   Then the hierarchical cull kernel (`hier_phase`, `hier_set`) on the
   primaries' first round and on one bounce of their hits, each with the
   backface bound off and on: one launch over every packet, equal to
   _hier_cull on the card bit for bit (ids, counts, keys, swept ids),
   timed with CUDA events beside _hier_cull's time and its operations
   bound (from its per-packet counters), with its cycles per packet.
4. Reference phase: a 64x48 render of the 2k-triangle mesh scene through
   the kernels on the card against the plain versions on the CPU, per
   sample with the boundary-flip allowance of the CPU tests.
5. Main path: Renderer on the 2.4M-triangle scene at 1920x1080, 3
   bounces, one sample per wave, compaction on; one warm-up wave, two
   timed waves (launch counts read here), two more timed waves, and with
   --profile-all one wave under torch.profiler for the sweeps' device
   time (profile_split).  Both sweep kernels' launch counters must rise; the
   image must be finite and lit.
6. Tree-cull phase: a 3.4M-triangle displaced sphere cut into 256-triangle
   clusters (more than DENSE_CULL_MAX), on its 1080p primaries and on one
   bounce of the primaries that hit (cosine-weighted, from a seeded
   torch.Generator).  On each set the tree cull kernel equals
   cull_tree_plain exactly (ids, counts, keys, and inner nodes, leaves and
   clusters per packet) on >= 256 packets and every packet that
   overflowed; it is timed on all packets in image order and heaviest
   first, its per-packet counters are summarized, and its bound counts
   the slab tests of the 32-ray chunks it tests.  Between the two sets
   the tree tier end to end (two_level_hit with its residual lanes, the
   bvh_hit_sparse net) against the same mesh on the dense tier: tri equal
   on >= 99.9% of lanes, at most 0.05% of lanes hit in one build only, t
   within 1e-5 relative on equal lanes.  The cull kernel must launch.
7. Packet phase: the 2k-triangle mesh scene with the mesh uploaded with
   use_cluster=False (the packet tier).  On its 1080p primaries and on one
   bounce of them the packet kernel equals packet_walk_plain bit for bit
   on every lane (t, tri, alpha, beta, inner nodes and triangle tests per
   ray) and agrees with the brute-force plain version (tri equal on >=
   99.9% of lanes, the rest ties within 2^-16 relative t or hit/miss flips
   on at most 0.01% of lanes, t within 1e-5 relative on equal lanes); it
   is timed in ray order and with its 32-ray batches heaviest first, and
   its counters (cycles per warp, SIMT efficiency) are summarized.  Then
   Renderer at 1920x1080, 3 bounces, compaction on, one warm-up and two
   timed waves, whose image must agree with the same scene on the cluster
   tier (< 1% of pixels beyond 1e-3 relative, means within 1%).  The
   packet kernel must launch.
8. Probe phase: the sweep's cost probes at their full shapes.  The three
   entry points (pathtracer_tpu_torch.scripts.prof_sweep, proto_mxu,
   ablate_sweep; the last on its 1,002,528-triangle terrain, built once)
   are each driven with their launches counted from just before to just
   after, and each must launch its kernels.  Then every probe kernel
   against its plain version: the fp32 product, the epilogue, the
   edge-matrix test and every ablation variant bit-equal (bits of t,
   tri, beta, gamma), the TF32 product within sweep_micro.TF32_TOL of the
   absolute-value bound at both scripts' shapes; the epilogue also on
   prof_sweep.signed_zero_inputs (tn < 0, t = -0.0 and +0.0 accepted in
   one rep and across reps), where the kernel, the plain version on the
   card and the plain version on the CPU must give the same bits; the
   ablation's `full` bit-equal and timed at
   every lane group size, and against the production cluster_sweep on
   the same clamped inputs by check_hits (and timed there, in ps per
   pair, beside the main path's first round); and the fp32 product must
   take at least twice as long at 1536 columns as at 384, so the whole
   product is computed.  sweep_micro.fma_rn must give the same bits on
   the card and on the CPU on prof_sweep.fma_cases (the double-rounding
   cases that float64 rounding alone gets wrong among them), and the fp32
   product's FMA must equal it (check_fma).  Counters: each probe
   kernel's registers and resident warps per SM; for the epilogue, the
   edge-matrix test and the ablation's `full`, the SASS instructions per
   ray x triangle pair of the pair loop (sass_loop, cuobjdump); for the
   fp32 product its tile, the SASS instructions of its rep loop per
   output (one I2F a rep) and its launch of 0 reps; for the TF32 product
   its tile width and count, its launch at every tile width that divides N
   (three alternated timings each, `tile_us`), the instructions of its
   rep loop per HGMMA (one wgmma a rep; the run fails if the loop has
   none), the tensor rate it reaches, and its launch of 0 reps beside a
   one-element add (what the rep loop does not account for); the
   ablation's cycles and subtiles per lane group.  Times
   are the entry points' CUDA-event times.  A product's `library_ms` is
   the one torch.matmul that computes the launch's whole sum
   (scripts.matmul_same_us, K-concatenated operands), the library
   yardstick; `one_product_ms` beside it times one (1024, 8) x (8, N)
   product.

9. Materials phase (after the gradient phase): scene M
   (material_objects, from MAT_SEED): the main path's 2.4M-triangle sphere
   in 8 latitude bands, each with a 1024x1024 kd map and normal map
   (tangents from setup_tangents, the atlas path), opaque; in front of it
   sphere_mesh(400, 400, radius=6), 320k triangles, with a striped
   1024x1024 alpha map cutting half its texels, 4 cut-out rounds; a
   1024x2048 env map on the dome.  First every closest-hit sweep launch
   of one cut-out query on the 1080p primaries against
   cluster_sweep_plain bit for bit under the rising strict floor, the
   lanes whose floor is a cut hit's t then lowered by one ulp (the kernel
   and the plain version find that triangle again at t == floor); then a
   64x48x1 spp render on the card against the CPU plain path (the
   reference's allowance); then Renderer at 1920x1080, 3 bounces, 1
   sample per wave, compaction: one warm-up and MAT_WAVES (1) waves timed
   one by one (median, min, max; live rays/s; sweep launches per wave,
   counted over them; the cut-out queries and the lanes entering
   each round), and, with --profile-all, one wave under torch.profiler
   split into the sweeps, the culls and the texture and env-map lookups
   (record_function ranges put around them by `annotated`) and the rest;
   both sweeps must launch
   and the image be finite and lit; then autograd of a 480x270x2 spp
   float64 mean image with respect to the kd atlas and the env map, each
   at its largest-|grad| texel against a central difference (5e-2).
   Scene C4: configs/config4_merl_dof.json through the port's scene_json
   with the synthetic full-size MERL table written beside it in a
   temporary directory, 512x512 x 64 spp, aperture 1.5: one warm-up and
   C4_FRAMES (1) timed frames (median, min, max); the MERL table's
   gradient on a 128x128x4 spp render at its largest-|grad| entry against
   a central difference.  No image is read from a PNG: every map is made
   with numpy.
10. Media phase (after the materials phase): scene O (media_objects):
   config 5's fog block and mesh material, read from
   configs/config5_office.json, on the main path's 2.4M-triangle sphere
   (its ksub clears the backface cull), config 5's slate, a 1024x2048 env
   map.  First every closest-hit sweep launch of one reservoir march (the
   MARCH_SIZE (960x540) primaries' bounce-1 subsurface probes, drawn as
   the integrator draws them) against cluster_sweep_plain bit for bit
   under the rising strict floor with the backface cull off
   (march_sweep_check); then
   64x48x1 spp renders on the card against the CPU plain path (the
   reference's allowance) of scene O's geometry at a 79,600-triangle
   sphere (whose probes march) and of the flagship with a ghost sphere
   and a 1080x1920 background photo; the ghost flagship's 1080p waves
   (one warm-up, MEDIA_WAVES timed); then scene O's Renderer at 1920x1080,
   3 bounces, 1 sample per wave, compaction: one warm-up wave (with
   --profile-all under torch.profiler, split into the sweeps, the culls,
   the march, the fog and the rest, with the device-busy share);
   MEDIA_WAVES waves timed one by one (median, min, max; live rays/s;
   every kernel's launches counted over them; closest-hit launches inside
   the march and inside the fog probe; fog probe queries and lanes;
   marches, rounds and the lanes entering each round), the overflow stat
   (must be 0); then autograd of a 320x180x2 spp float64 mean image with
   respect to the fog density and the mesh's g_ksub against central
   differences with the gradcheck ladder's steps and tolerances, on the
   render path as it ships and again with the integrator's weight cull
   patched to 0 for the check (the cull's threshold makes the image jump
   where a lane crosses it, which no derivative has).

11. CLI phase (after the media phase; cli_phase): the main path's scene
   written as files, the 2.4M-triangle sphere as an OBJ (io.obj.save_obj)
   and the scene as a .scn (io.scn_export.save_scn, the non-lenticular
   block, has_denoiser 1, the sphere on two keyframes).  load_scn reads it
   back (triangles, keyframes, size) and save_scn of that parses the same.
   Then the headless entry point in process, `cli.main([scene.scn,
   out.hdr, --spp CLI_SPP, --size 1920x1080, --frame 1, --denoise])` (the .scn
   carries no compaction flag, so it renders without), with every
   kernel's launches counted over it (`launches_cli`), each
   sample timed by CUDA events (sample_timer) with its sweep launches, and
   both sweeps recorded: their first and last launches held against the
   plain versions bit for bit.  On its result: the a-trous denoised
   display (4 levels, timed); a lenticular camera (10 images, pixel width
   1, the reference's angle) for one sample, timed, its first launches
   held the same way; checkpoint/resume (RESUME_SPP (2) samples, one a
   wave, compaction): two straight renders bit-equal, render_resumable
   stopped after one wave and resumed bit-equal, its .npz removed; the preview
   (120x67) and display_fill_in before and after the first wave;
   KPCN-lite with the shipped weights on the whole frame (timed, peak
   memory) and on a 256x256 crop against the CPU (KPCN_TOL).  Last,
   `python -m pathtracer_tpu_torch.cli` as a subprocess at 480x270 x 2
   spp, on the same slate written with a CLI_SUB_LAT (200) sphere, must
   exit 0 and write its .hdr.  Its numbers are the `{"cli": ...}`
   line.  No image is written as PNG or JPEG (PIL may be missing).

12. Fluid phase (after the CLI phase; fluid_phase): scene F.  Solid cells
   by fluid.rasterize_solids through the main path's 2.4M-triangle sphere
   (12 casts of the 128^3 cell centres, backface cull off) and about
   320,000 particles by fluid.seed_from_object from a checker-textured
   sphere_mesh(400, 400, radius=8) at (0, 8, 0) (numpy kd map), both
   casts' closest-hit sweeps recorded and their first and last launches
   held bit for bit; fluid.run for 10 frames x 2 substeps of 0.03 on a
   128^3 grid over (-24, -30, -24)-(24, 18, 24), every substep timed by
   CUDA events, each solve's CG iterations and residual printed (the cap
   named if it bit); the particles kept, inside the extent, the mean
   height falling.  Then the last frame as fluid_pointset(radius=0.2) on
   the clustered tier beside the sphere at 1920x1080, 3 bounces,
   compaction: one warm-up and FLUID_WAVES timed waves (every kernel's
   launches counted over them, `launches_fluid`; the particle sweeps'
   packets, overflows, rerouted lanes and slot steps), the warm-up's
   sweeps recorded and held, one wave under torch.profiler split into the
   particle cull, slot sweeps, reroute, brute sweeps and mesh culls; the
   particle tier on the 1080p primaries against brute force on the card
   (every 16th lane; the union walk on 2,048 rays started inside the
   fluid against the brute walk after 12 and 40 passes): index equal on
   >= 99.9%, the rest ties within 2^-16; the same frame transparent, a
   warm-up and FLUID_T_WAVES waves.  Last, the gallery fluid (24^3) for
   one frame on the card and on the CPU (particles within FLUID_CPU_TOL of
   the extent), a disk cloud (XYZ made with numpy, normals estimated),
   yarns (a .yarn made with numpy) and the gallery fluid opaque and
   transparent at 64x48 against the CPU plain path, and the disk cloud's
   and the yarns' 480x270 waves timed.  Its numbers are the `{"fluid":
   ...}` line.

13. Training phase (after the gradient phase, on the main path's scene;
   train_phase): A parallel.sharding.make_train_step at 1920x1080 x 2
   spp, 3 bounces, compaction, remat, world 1 on NCCL: three SGD steps
   (TRAIN_LR) on kd, ks and light_intensity toward the image with the
   ground plane's kd at TRAIN_TARGET_KD; the loss must fall, both sweeps
   launch in the forward and in the recompute (`launches_train`,
   `launches_train_forward`, `launches_train_recompute`), ms per step by
   CUDA events, peak memory.  B the loss and gradients at 480x270 with
   dp = 2 processes sharing the card over gloo against
   one process: loss within 1e-5, gradients within 5e-4 of each leaf's
   largest |grad|; the step's time in each.  C the 2.4M-tri sphere
   partitioned by shard_clustered_mesh into two scene ranks (gloo, each
   loading its partition from a file; the same two processes as B,
   `--worker`), one 1080p x 1
   spp wave with the backface cull off against the unsharded render:
   counts equal, the image within rtol = atol = 1e-5, both sweeps launch
   on each rank and their first launches equal the plain versions bit for
   bit (`launches_scene_ranks`); each rank's collectives timed on the
   host clock (distributed.COLLECTIVE_LOG).  C2 the same sphere uploaded
   routed (routed_scene, its host builds from utils/hostcache), backface
   cull off, in two partitions that keep the whole soup and BVH for the
   residual net (the same two processes, a third step of `--worker`):
   one 1080p x 1 spp wave with compaction, the ranks' images and counts
   bit-equal to each other, the counts equal to the unsharded routed
   render's and the image within PERF.md §2's per-sample rule
   (samples_agree) and within C2_FLIPPED / C2_MEAN_REL of it, each
   side's net run on exactly its residual lanes (some on both sides),
   both sweeps
   launch on each rank and their first launches equal the plain versions
   bit for bit (`launches_scene_ranks_routed`); per rank the wave's ms,
   its collectives, its run packets and residual lanes per bounce
   (routed_cluster.ROUTE_LOG) and the net's host-clock ms.  D the
   KPCN-lite trainer on
   KPCN_SCENES + 1 scenes, KPCN_STEPS steps of 8 x 64^2 crops: the mean
   of the last 10 losses below the first 10's, the saved flax-layout file
   reads back to the same outputs; the denoiser gate on the shipped
   weights at 96x64 (2 vs 64 spp).  Its numbers are the `{"training":
   ...}` line.  The rank processes share the card: no time here says
   anything of scaling across cards.

14. Routed phase (routed_phase after the main path, routed_tree after the
   tree phase): the routed cluster tier, upload_mesh(use_routed=True), on
   the main path's paths.  R1: the main path's sphere uploaded routed
   (soup and BVH kept); on its 1080p primaries and one bounce of them
   (every ROUTED_BOUNCE_STRIDE-th 512-ray packet) routed_hit through the
   kernels equals the same call with
   cluster_sweep's plain version on the card bit for bit (t, tri,
   residual lanes), and after the bvh_hit_sparse net agrees with
   two_level_hit (backface cull off) by the tree phase's standard (agree:
   tri on >= 99.9% of lanes, at most 0.05% hit in one only, t within 1e-5
   relative, the net's lanes within the plane and edge-matrix formulas'
   tolerance).  R2: Renderer on the routed scene at 1920x1080, 3 bounces,
   1 sample a wave, compaction: a warm-up (its routed queries' run
   packets, padding share and residual lanes from
   routed_cluster.ROUTE_LOG, the net's host-clock time), ROUTED_WAVES
   timed waves (median; live rays/s; every kernel's launches counted over
   them, `launches_routed`) beside the main path's two-level
   waves, and one 1 spp render_unsplatted of each scene, per sample
   within PERF.md §2's rule.  R3: the tree phase's 3.4M-triangle sphere
   (its host builds from utils/hostcache) through routed_hit and the net
   on the 1080p primaries against the tree tier's two_level_hit and net
   by the same standard; cull_tree must launch (`launches_routed_tree`).
   Its numbers are the `{"routed": ...}` line.

Bounds: bytes over 3.35 TB/s, and operations over the card's fp32 issue
rate read at the start (issue_rate: SMs x 128 lanes x the maximum SM
clock; the kernels are built with -fmad=false, so each counted operation
is one instruction, and the fp32 product's explicit FMAs, __fmaf_rn, are
one FFMA each: DOT_OUT_OPS, DOT_ROW_OPS), or over the card's dense TF32
rate for the tensor-core product (tf32_rate: SMs x 1024 multiply-adds x 2
x the same clock), both printed after the card line.

Every failure raises.  The routed phase's, the training phase's, the
fluid phase's, the CLI phase's, the media
phase's, the materials phase's and the gradient phase's numbers are JSON
lines before the card line.  The last
three lines are the card line, the kernel JSON (per kernel: time, plain
version's time, launches on its main path and on each later phase's
waves, agreement, and the roofline bound from this run's work) and the
contract line.
"""

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

W, H, BOUNCES = 1920, 1080, 3
TIE = 2.0 ** -16
BIG_T = float(np.float32(1e30))
# roofline of one H100 SXM: HBM3 bandwidth (NVIDIA data sheet).  The
# operations bounds are read on the card: the fp32 issue rate of the
# CUDA-core kernels (issue_rate; they are built with -fmad=false, so each
# counted single-rounded operation is one instruction, an FMA that a plain
# version states too, as the fp32 product's, one FFMA) and the dense TF32
# rate of the tensor cores (tf32_rate).
PEAK_BYTES = 3.35e12
TF32_MACS_PER_SM = 1024   # dense TF32 multiply-adds per SM and cycle
# fp32 operations (products, sums, FMAs, divides, min / max) per unit of
# work, counted in the kernel sources
SWEEP_PAIR_OPS = 41     # one ray x triangle plane test (cluster_sweep.cu)
SLAB_OPS = 23           # one ray x box slab test
HIER_A_OPS = 84         # hierarchical cull stage A, one cluster x octant
                        # group: three interval axes of 4 subtractions, 8
                        # products, 14 min / max, and 4 merges and 2 more
                        # (cluster_hier_cull.cu)
HIER_A_NRM_OPS = 24     # ... with normal bounds: 12 products, 9 min, 2
                        # sums, a compare
HIER_KEY_OPS = 6        # ... per cluster: its key, liveness and packing
HIER_B_OPS = 29         # stage B, one ray x live candidate: the slab's 22,
                        # the entry, liveness, the masked minimum
HIER_B_NRM_OPS = 13     # ... with normal bounds: 6 products, 3 min, 2
                        # sums, a compare, an and
TRI_TEST_OPS = 43       # one edge-matrix ray x triangle test (packet_bvh.cu)
EPI_PAIR_OPS = 20       # one lane x triangle of the probe epilogue
DOT_OUT_OPS = 9         # one output of the fp32 probe product a rep: an
                        # FMUL, seven FFMAs (one instruction each) and an FADD
DOT_ROW_OPS = 8         # one row's shifts x + i*eps a rep (sweep_micro.cu)
EDGE_PAIR_OPS = 41      # one probe edge-matrix test (sweep_micro.cu)
PCG_DRAW_BYTES = 53     # a gated draw a lane: four int64 halves and the
                        # gate read, two halves and a float32 written
PCG_PAIR_BYTES = 57     # a gated pair: one float32 more (csrc/pcg_draw.cu)
PCG_SEED_BYTES = 48     # make_stream: two key halves read, four written
PCG_REPS = 200          # timed back-to-back launches of the PCG kernel
RADIANCE = 196964.7     # the gradient loss's scale (tests/test_gradients.py)
DESCENT_TARGET = [0.8, 0.3, 0.2]   # g_kd of the descent's target image
DESCENT_LR = 1.0
FLAGSHIP_RUNS = 1       # timed flagship runs a mode, after a warm-up (3
                        # before the time limit's cuts)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def issue_rate():
    """(fp32 instructions per second, SMs, max SM clock in MHz) of card 0:
    SMs (torch) x 128 fp32 lanes x the maximum SM clock (nvidia-smi
    clocks.max.sm): one counted operation, an FFMA included, per lane and
    cycle."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                          '--format=csv,noheader,nounits'], check=True,
                         capture_output=True, text=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    return sms * 128 * mhz * 1e6, sms, mhz


def tf32_rate():
    """Dense TF32 flops per second of card 0, counted as issue_rate counts:
    SMs x TF32_MACS_PER_SM x 2 flops x the maximum SM clock (the data
    sheet's 494.7 TFLOP/s is the same count at 1830 MHz)."""
    _, sms, mhz = issue_rate()
    return sms * TF32_MACS_PER_SM * 2 * mhz * 1e6


def bound(ops, nbytes, peak=None):
    """Least time (ms) for `ops` operations at `peak` per second (None:
    the card's fp32 issue rate) and `nbytes` bytes on the card, and which
    of the two bounds it."""
    peak = issue_rate()[0] if peak is None else peak
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def entry(name, source, replaces, err, agree, ms, plain_ms, ops, nbytes,
          peak=None, **extra):
    """One kernel's record of the kernel JSON line; `share` is the bound
    over the time."""
    bound_ms, bound_by = bound(ops, nbytes, peak)
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                launches=0, max_abs_err=err, agree=agree, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                share=bound_ms / ms, library_ms=None, **extra)


def cycle_summary(cyc, work):
    """Per-unit clock64 cycles and work (1-D tensors): cycles mean, p99,
    max, the heaviest 1% of units' share of cycles and of work (units
    ranked by each), work mean and max."""
    import torch
    cyc, work = cyc.double().cpu(), work.double().cpu()
    n1 = max(1, cyc.numel() // 100)

    def top_share(x):
        return float(torch.sort(x, descending=True).values[:n1].sum()
                     / max(float(x.sum()), 1.0))

    return dict(units=cyc.numel(), cycles_mean=float(cyc.mean()),
                cycles_p99=float(torch.quantile(cyc, 0.99)),
                cycles_max=float(cyc.max()), top1_share=top_share(cyc),
                top1_work_share=top_share(work), work_mean=float(work.mean()),
                work_max=float(work.max()))


_SASS_LINE = re.compile(r'/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?'
                        r'([A-Z][A-Z0-9_.]*)([^;]*);')
_SASS_FP32 = ('FADD', 'FMUL', 'FFMA', 'FSETP', 'FMNMX', 'FSEL', 'FCHK',
              'MUFU')


def sass_loop(lib, key, marker='MUFU.RCP'):
    """The innermost loop of the kernel whose mangled name contains `key`,
    from `cuobjdump -sass` of the built library `lib`: the shortest
    backward branch whose body holds an instruction whose opcode starts
    with `marker` (the default, MUFU.RCP, is the IEEE divide's reciprocal,
    one per ray x triangle pair; HGMMA is one wgmma).  Returns its
    instruction count, the markers in it and instructions per marker
    (`divides` and `per_pair` for MUFU.RCP, `markers` and `per_marker`
    otherwise), the fp32-pipe share and the opcodes, and the body's
    text."""
    from pathtracer_tpu_torch.ops import binding
    tool = os.path.join(os.path.dirname(binding.nvcc_path()), 'cuobjdump')
    out = subprocess.run([tool, '-sass', lib], check=True,
                         capture_output=True, text=True, timeout=300).stdout
    funcs = re.split(r'\n\s*Function : ', out)
    body = [f for f in funcs[1:] if key in f.split('\n', 1)[0]]
    if len(body) != 1:
        raise AssertionError(f'{len(body)} kernels of {lib} match {key}')
    ins = [(int(m.group(1), 16), m.group(3), m.group(4), m.group(2) or '')
           for m in _SASS_LINE.finditer(body[0])]
    best = None
    for addr, op, rest, _ in ins:
        hit = re.search(r'0x([0-9a-f]+)', rest) if op.startswith('BRA') \
            else None
        if hit is None or int(hit.group(1), 16) > addr:
            continue
        loop = [x for x in ins if int(hit.group(1), 16) <= x[0] <= addr]
        if any(x[1].startswith(marker) for x in loop) and (
                best is None or len(loop) < len(best)):
            best = loop
    if best is None:
        raise AssertionError(f'no loop with a {marker} in {key}')
    ops = collections.Counter(x[1].split('.')[0] for x in best)
    n = sum(1 for x in best if x[1].startswith(marker))
    fp32 = sum(v for k, v in ops.items() if k in _SASS_FP32)
    count = (dict(divides=n, per_pair=len(best) / n)
             if marker == 'MUFU.RCP' else
             dict(marker=marker, markers=n, per_marker=len(best) / n))
    return dict(instructions=len(best), **count,
                fp32_share=fp32 / len(best), opcodes=dict(ops.most_common()),
                text='\n'.join(f'{a:05x} {p}{o}{r}' for a, o, r, p in best))


def cuda_ms(fn, reps=1, warm=True):
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def same_bits(out_k, out_p):
    """Kernel and plain outputs (tensors of 32-bit types or bool, or
    tuples of them) equal bit for bit: -0.0 differs from +0.0."""
    import torch
    pairs = zip(out_k, out_p) if isinstance(out_k, tuple) else [(out_k,
                                                                 out_p)]
    return all(torch.equal(a, b) if a.dtype == torch.bool else
               torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in pairs)


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


def unit_report(st, group):
    """One line on a sweep's per-unit counters (kernel stats, (units,
    STATS) int64): cycles mean / p99 / max, the heaviest 1% of units'
    share of cycles and of swept subtiles, and the means per unit."""
    st = st.double()
    c = cycle_summary(st[:, 4], st[:, 3])
    mean = st.mean(dim=0).tolist()
    return (f'G={group}: {c["units"]} units; cycles per unit mean '
            f'{c["cycles_mean"]:.0f}, p99 {c["cycles_p99"]:.0f}, max '
            f'{c["cycles_max"]:.0f}; heaviest 1% of units '
            f'{c["top1_share"]:.3f} of cycles, {c["top1_work_share"]:.3f} of '
            f'swept subtiles; per unit means: slots visited {mean[0]:.2f} '
            f'(max {float(st[:, 0].max()):.0f}), clusters entered '
            f'{mean[1]:.2f}, subtile slab tests {mean[2]:.2f}, subtiles swept '
            f'{c["work_mean"]:.2f} (max {c["work_max"]:.0f}); units that '
            f'sweep nothing {float((st[:, 3] == 0).double().mean()):.3f}')


def kernel_phase(sc, cam, dev):
    """Both sweeps on the main path's first round at 1080p: one launch over
    every packet, kernel against plain version at every lane group size
    (outputs and counters equal), timed with CUDA events at every group
    size and as the 16 CHUNK_PACKETS launches of the earlier host loop.
    Returns the two kernel records, at cluster.SWEEP_GROUP."""
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
    info = cl.kernel_info()
    log('sweep kernels (registers per thread, resident blocks per SM, '
        'static shared bytes): ' + '; '.join(
            f'{name} G={g}: {r} regs, {b} blocks, {sm} B'
            for (name, g), (r, b, sm) in info.items()))

    def first_round(o, d, tmax):
        o, d, tmax, tmin = cl._prepare(cm, o, d, tmax, None)
        tx = cl.root_exit_clamp(cm.bounds, o, d, tmax)
        ids, counts, keys, _ = cl._cull_all(
            cm, o, d, tx, cm.nrm if mesh.backface_cull else None)
        return (ids, counts, keys, o, d, tx, tmin)

    def chunked(fn, args, group):
        """The earlier host loop: one launch per CHUNK_PACKETS packets."""
        ids, counts, keys, o, d, tx, tn = args
        for sl in cl._chunks(o.shape[0]):
            ps = slice(sl.start // cl.BLOCK, sl.stop // cl.BLOCK)
            fn(cm, ids[ps], counts[ps], keys[ps], o[sl], d[sl], tx[sl],
               tn[sl], group=group)

    def sweep_bytes(n_packets, distinct, out_bytes):
        """Rays in (org, dir, tmax, tmin), the cull tables, the planes of
        every distinct subtile swept, and the outputs."""
        return (n_packets * cl.BLOCK * (32 + out_bytes)
                + n_packets * (8 * cl.MAXC + 4)
                + distinct * cl.PLANE_ROWS * cl.SUBT * 4)

    def one_sweep(name, kern, plain, args, line, out_bytes):
        n_packets = args[0].shape[0]
        per_g = {}
        for g in cl.GROUPS:
            nu = n_packets * (cl.BLOCK // g)
            in_order = torch.arange(nu, dtype=torch.int32, device=dev)
            st_k = torch.zeros((nu, cl.STATS), dtype=torch.int64, device=dev)
            st_p = torch.zeros_like(st_k)
            seen = torch.zeros((cm.n_clusters, cm.n_sub), dtype=torch.bool,
                               device=dev)
            out_k = kern(cm, *args, group=g, stats=st_k)
            out_p = plain(cm, *args, group=g, stats=st_p, seen=seen)
            torch.cuda.synchronize()
            out_k = out_k if isinstance(out_k, tuple) else (out_k,)
            out_p = out_p if isinstance(out_p, tuple) else (out_p,)
            if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
                raise AssertionError(f'{name} G={g} differs from its plain '
                                     f'version')
            if not torch.equal(st_k[:, :4], st_p[:, :4]):
                raise AssertionError(f'{name} G={g}: counters differ from '
                                     f'the plain version')
            ms = cuda_ms(lambda: kern(cm, *args, group=g), reps=3)
            ms_order = cuda_ms(lambda: kern(cm, *args, group=g,
                                            order=in_order), reps=3)
            ms_chunk = cuda_ms(lambda: chunked(kern, args, g), reps=3)
            swept = int(st_k[:, 3].sum())
            per_g[g] = dict(ms=ms, ms_packet_order=ms_order,
                            ms_chunked=ms_chunk, swept=swept,
                            distinct=int(seen.sum()), out=out_k)
            log(f'{name} G={g}: equal to its plain version (outputs and '
                f'counters); one launch heaviest first {ms:.3f} ms, in '
                f'packet order {ms_order:.3f} ms, {cl.CHUNK_PACKETS}-packet '
                f'chunks {ms_chunk:.3f} ms; {swept} unit subtiles swept = '
                f'{swept * g} lane x subtile rows')
            log('  ' + unit_report(st_k, g))
        g = cl.SWEEP_GROUP
        r = per_g[g]
        ms_p = cuda_ms(lambda: plain(cm, *args, group=g), reps=1)
        rows, rows_512 = r['swept'] * g, per_g[512]['swept'] * 512
        rec = entry(
            name, 'pathtracer_tpu_torch/csrc/cluster_sweep.cu', line, 0.0,
            1.0, r['ms'], ms_p, rows * cl.SUBT * SWEEP_PAIR_OPS,
            sweep_bytes(n_packets, r['distinct'], out_bytes),
            packets=n_packets, group=g, rows=rows, rows_512=rows_512,
            bound_ms_512=bound(rows_512 * cl.SUBT * SWEEP_PAIR_OPS, 0)[0],
            ms_chunked=r['ms_chunked'], ms_packet_order=r['ms_packet_order'],
            ms_by_group={k: v['ms'] for k, v in per_g.items()})
        log(f'{name}: G={g} kernel {r["ms"]:.3f} ms, bound '
            f'{rec["bound_ms"]:.4f} ms ({rows} lane x subtile rows; '
            f'{rec["bound_ms_512"]:.4f} ms for the {rows_512} rows of '
            f'G=512), plain {ms_p:.3f} ms')
        return rec, r['out']

    # ---- closest hit ----
    args = first_round(org_l, dir_l, tmax0)
    rec_c, (t_k, tri_k) = one_sweep(
        'cluster_sweep_closest', cl.cluster_sweep, cl.cluster_sweep_plain,
        args, 'pathtracer_tpu/ops/pallas_cluster.py:668', 8)
    log(f'closest sweep: {args[0].shape[0]} packets, hit share '
        f'{float((tri_k >= 0).float().mean()):.4f}')

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
    args = first_round(s_org, wi, limit)
    rec_a, (occ_k,) = one_sweep(
        'cluster_sweep_any', cl.cluster_sweep_any, cl.cluster_sweep_any_plain,
        args, 'pathtracer_tpu/ops/pallas_cluster.py:885', 1)
    log(f'shadow sweep: occluded share of hit lanes '
        f'{float(occ_k[:n0][hit].float().mean()):.3f}')
    rec_h = hier_phase(sc, org_l, dir_l, tmax0, t_k, tri_k, dev)
    return [rec_c, rec_a, rec_h]


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


def main_path(sc, cam, card, profile=False):
    import torch
    import pathtracer_tpu_torch as pt
    cfg = pt.RenderConfig(width=W, height=H, nrays=8, nb_bounces=BOUNCES,
                          samples_per_wave=1, compact_rays=True)
    r = pt.Renderer(sc, cam, cfg)
    counted = launch_counts()
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
    launches = launches_since(counted, RENDER_KERNELS)
    ms_wave = [start.elapsed_time(stop) / 2]
    live = r.rays_traced - rays0
    for _ in range(2):                          # two more calls, one wave each
        start.record()
        r.step()
        stop.record()
        torch.cuda.synchronize()
        ms_wave.append(start.elapsed_time(stop))
    if profile:
        split, busy_ms, n_kern, _ = profile_split(r, ())
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
        f'{ms_wave[0]:.1f} ms/wave over two waves, then '
        f'{", ".join(f"{x:.1f}" for x in ms_wave[1:])} ms; '
        f'{live / (2 * ms_wave[0] / 1e3):.4g} live rays/s ({card}); launches '
        f'in the warm-up and two timed waves {launches}; mesh region mean '
        f'{region.mean():.3f} std {region.std():.3f}')
    if profile:
        log(f'profiled wave (torch.profiler): sweep kernels device time '
            f'cluster_sweep_closest {split["sweep_closest"]:.1f} ms, '
            f'cluster_sweep_any {split["sweep_any"]:.1f} ms; all {n_kern} '
            f'kernels {busy_ms:.1f} ms (sum of kernel times)')
    rep = dict(ms_wave=ms_wave, ms_median=float(np.median(ms_wave[1:])),
               live_rays_per_s=live / (2 * ms_wave[0] / 1e3),
               launches_per_wave={k: v / 3 for k, v in launches.items()})
    return launches, rep


def flagship_scene(dev, ghost=False, background=None):
    """bench.py's analytic flagship (:75-82): Phong, mirror and glass
    spheres on the default slate; with `ghost`, a ghost sphere (a shadow
    catcher) in front of them, and a background photo."""
    from pathtracer_tpu_torch.scene import scene as scn
    objs = scn.default_objects()
    objs.append(scn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2),
                           ks=(0.1, 0.1, 0.1), ne=(30.0, 30.0, 30.0)))
    objs.append(scn.sphere((-16.0, -20.0, -10.0), 7.0, miroir=True))
    objs.append(scn.sphere((17.0, -19.0, -5.0), 8.0, transp=True,
                           refr_index=1.4))
    if ghost:
        objs.append(scn.sphere((-3.0, -22.0, 12.0), 5.0, ghost=True))
    return scn.build_scene(objs, scn.default_light_intensity(),
                           background=background, device=dev)


def timed(fn):
    """(fn(), milliseconds) of one call, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def spread(ms):
    """Median, min and max of timed runs (ms), and the runs."""
    return dict(median=float(np.median(ms)), min=float(min(ms)),
                max=float(max(ms)), runs=[float(x) for x in ms])


def mean_image(sc, cam, cp, cfg, leaves):
    """render_unsplatted's mean image of sc with `leaves` replaced (names
    to tensors; g_* names are mesh 0's per-group materials)."""
    from pathtracer_tpu_torch.render import renderer as rnd
    kw = {k: v for k, v in leaves.items() if not k.startswith('g_')}
    mesh_kw = {k: v for k, v in leaves.items() if k.startswith('g_')}
    if mesh_kw:
        kw['meshes'] = (sc.meshes[0].replace(**mesh_kw),) + sc.meshes[1:]
    return rnd.render_unsplatted(sc.replace(**kw), cam, cp, cfg)[0]


def check_grads(grads, what):
    """Every gradient finite and not all zero."""
    import torch
    for name, g in grads.items():
        if not bool(torch.isfinite(g).all()) or not float(g.abs().sum()) > 0:
            raise AssertionError(f'{what}: gradient of {name} not finite or '
                                 f'zero: {g.tolist()}')


def flagship_grad(dev, cam, card):
    """bench.py's fwd_ms_per_frame_1080p64 and fwd_bwd_ms_per_frame_1080p64
    on the analytic flagship (no kernel runs): the mean 1920x1080 x 64 spp
    image, 3 bounces, remat_samples, forward under torch.no_grad() and
    forward + backward with respect to kd and light_intensity;
    FLAGSHIP_RUNS timed runs each, the forward's after a warm-up (the
    forward + backward's warm-up, dropped for time, took what its timed
    run took: 10637.5 against 10468.9 ms on an H100)."""
    import torch
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.core import rng_host
    sc = flagship_scene(dev)
    cfg = pt.RenderConfig(width=W, height=H, nrays=64, nb_bounces=BOUNCES,
                          remat_samples=True)
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(W, H), device=dev)
    leaves = {'kd': sc.kd.clone().requires_grad_(),
              'light_intensity': sc.light_intensity.clone().requires_grad_()}

    def fwd():
        with torch.no_grad():
            return float(mean_image(sc, cam, cp, cfg, leaves).mean())

    def fwd_bwd():
        loss = mean_image(sc, cam, cp, cfg, leaves).mean()
        return dict(zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))))

    fwd_ms = [timed(fwd)[1] for _ in range(1 + FLAGSHIP_RUNS)][1:]
    torch.cuda.reset_peak_memory_stats()
    runs = [timed(fwd_bwd) for _ in range(FLAGSHIP_RUNS)]
    peak = torch.cuda.max_memory_allocated()
    grads = runs[-1][0]
    check_grads(grads, 'flagship')
    rep = dict(fwd_ms_per_frame_1080p64=spread(fwd_ms),
               fwd_bwd_ms_per_frame_1080p64=spread([ms for _, ms in runs]),
               fwd_bwd_peak_bytes=int(peak),
               grad_light_intensity=float(grads['light_intensity']))
    log(f'flagship 1080p x 64 spp, 3 bounces, remat ({card}): forward '
        f'(no_grad) median {rep["fwd_ms_per_frame_1080p64"]["median"]:.1f} '
        f'ms (min {min(fwd_ms):.1f}, max {max(fwd_ms):.1f}; runs '
        f'{", ".join(f"{x:.1f}" for x in fwd_ms)}); forward + backward wrt '
        f'kd and light_intensity median '
        f'{rep["fwd_bwd_ms_per_frame_1080p64"]["median"]:.1f} ms (runs '
        f'{", ".join(f"{ms:.1f}" for _, ms in runs)}); backward peak '
        f'memory {peak / 2**30:.2f} GiB; '
        f'd loss / d light_intensity {rep["grad_light_intensity"]:.4g}, '
        f'|d loss / d kd| sum {float(grads["kd"].abs().sum()):.4g}')
    return rep


def mesh_grad(sc, cam, card):
    """The main path's 2.4M-triangle scene differentiated at 1920x1080, 2
    spp, 3 bounces, compaction and remat_samples, with respect to the
    mesh's g_kd and light_intensity: both sweeps must launch in forward
    and again in backward (the recompute); autograd against a central
    difference on the card with the same seed (tests/test_gradients.py's
    steps and tolerances); then two plain gradient steps on g_kd toward
    a target image rendered with another g_kd, with the MSE loss of the
    JAX package's make_train_step: the loss must fall.  Returns the
    sweeps' launch counts in forward and backward, and the numbers."""
    import torch
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.core import rng_host
    dev = sc.device
    cfg = pt.RenderConfig(width=W, height=H, nrays=2, nb_bounces=BOUNCES,
                          compact_rays=True, remat_samples=True)
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(W, H), device=dev)
    base = {'g_kd': sc.meshes[0].g_kd.clone(),
            'light_intensity': sc.light_intensity.clone()}
    fwd_ms, fwd_bwd_ms = [], []

    def loss_of(leaves):
        return mean_image(sc, cam, cp, cfg, leaves).mean() / RADIANCE

    def fwd(leaves):
        with torch.no_grad():
            out, ms = timed(lambda: float(loss_of(leaves)))
        fwd_ms.append(ms)
        return out

    fwd(base)                                   # warm-up
    leaves = {k: v.clone().requires_grad_() for k, v in base.items()}
    counted = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    loss = loss_of(leaves)
    torch.cuda.synchronize()
    n_fwd = launches_since(counted, RENDER_KERNELS)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    stop.record()
    torch.cuda.synchronize()
    n_bwd = {k: v - n_fwd[k] for k, v in
             launches_since(counted, RENDER_KERNELS).items()}
    fwd_bwd_ms.append(start.elapsed_time(stop))
    peak = torch.cuda.max_memory_allocated()
    check_grads(grads, 'mesh')
    for name in n_fwd:
        if n_fwd[name] <= 0 or n_bwd[name] <= 0:
            raise AssertionError(f'{name} launched {n_fwd[name]} times in '
                                 f'forward, {n_bwd[name]} in backward')
    log(f'mesh gradient 1080p x 2 spp, 2.4M tris, 3 bounces, compaction, '
        f'remat ({card}): sweep launches in forward {n_fwd}, in backward '
        f'(the recompute) {n_bwd}; backward peak memory '
        f'{peak / 2**30:.2f} GiB; grads g_kd {grads["g_kd"].tolist()}, '
        f'light_intensity {float(grads["light_intensity"]):.6g}')

    # central differences, the same seed
    fd = {}
    for name, idx, eps, rtol in (('g_kd', (0, 0), 1e-3, 5e-2),
                                 ('light_intensity', (), 1e-3, 1e-2)):
        step = eps * max(abs(float(base[name][idx])), 1.0)
        delta = torch.zeros_like(base[name])
        delta[idx] = step
        lp = fwd({**base, name: base[name] + delta})
        lm = fwd({**base, name: base[name] - delta})
        want, got = (lp - lm) / (2 * step), float(grads[name][idx])
        fd[name] = dict(fd=want, autograd=got, rel=abs(got - want)
                        / max(abs(want), 1e-30), rtol=rtol)
        log(f'  central difference {name}{list(idx)}: {want:.6g}, autograd '
            f'{got:.6g} (relative difference {fd[name]["rel"]:.3g}, '
            f'tolerance {rtol})')
        if not np.isclose(want, got, rtol=rtol, atol=1e-12):
            raise AssertionError(f'{name}: autograd {got:.6g} against a '
                                 f'central difference {want:.6g}')

    # two plain gradient steps on g_kd toward another g_kd's image (three
    # before the training phase, whose train step descends on this scene)
    with torch.no_grad():
        target = mean_image(sc, cam, cp, cfg, {
            **base, 'g_kd': torch.tensor([DESCENT_TARGET], device=dev)}) \
            / RADIANCE
    p, losses = base['g_kd'].clone(), []

    def step_of(q):
        mse = ((mean_image(sc, cam, cp, cfg, {**base, 'g_kd': q}) / RADIANCE
                - target) ** 2).mean()
        return mse.item(), torch.autograd.grad(mse, [q])[0]

    for _ in range(2):
        (mse, g), ms = timed(lambda: step_of(p.clone().requires_grad_()))
        fwd_bwd_ms.append(ms)
        losses.append(mse)
        p = p - DESCENT_LR * g
    with torch.no_grad():
        mse, ms = timed(lambda: float(((mean_image(
            sc, cam, cp, cfg, {**base, 'g_kd': p}) / RADIANCE - target)
            ** 2).mean()))
    fwd_ms.append(ms)
    losses.append(mse)
    log(f'  descent toward g_kd {DESCENT_TARGET} (lr {DESCENT_LR}): MSE '
        f'{", ".join(f"{x:.6g}" for x in losses)}; g_kd {p.tolist()}')
    if not losses[2] < losses[0]:
        raise AssertionError(f'the descent loss did not fall: {losses}')
    log(f'  mesh forward (no_grad) ms: {", ".join(f"{x:.1f}" for x in fwd_ms)}'
        f' (first: warm-up); forward + backward ms: '
        f'{", ".join(f"{x:.1f}" for x in fwd_bwd_ms)} ({card})')
    rep = dict(fwd_ms=spread(fwd_ms[1:]), fwd_bwd_ms=spread(fwd_bwd_ms),
               fwd_bwd_peak_bytes=int(peak), launches_forward=n_fwd,
               launches_backward=n_bwd, central_difference=fd,
               descent_mse=losses)
    return rep


def grad_phase(sc, cam, card):
    """Gradients: the flagship's bench keys, then the mesh gradient.
    Returns (flagship numbers, mesh numbers)."""
    t0 = time.perf_counter()
    flag = flagship_grad(sc.device, cam, card)
    mesh = mesh_grad(sc, cam, card)
    log(f'gradient phase {time.perf_counter() - t0:.1f} s')
    return flag, mesh


def check_cull(out_k, out_p, work_k, work_p):
    """Tree cull kernel (k) against its plain version (p), exactly: ids,
    counts, keys and the inner-node, leaf and emission counters."""
    import torch
    for a, b, what in zip(tuple(out_k) + (work_k[:, :3],),
                          tuple(out_p) + (work_p[:, :3],),
                          ('ids', 'counts', 'keys', 'counters')):
        if not torch.equal(a, b):
            bad = int((a != b).view(a.shape[0], -1).any(dim=1).sum())
            raise AssertionError(f'cull {what} differ from the plain '
                                 f'version on {bad} packets')


def share_report(x):
    """mean / p99 / max of a per-unit cost and the heaviest 1%'s share."""
    import torch
    x = x.double().cpu()
    n1 = max(1, x.numel() // 100)
    top = float(torch.sort(x, descending=True).values[:n1].sum()
                / max(float(x.sum()), 1.0))
    return dict(mean=float(x.mean()), p99=float(torch.quantile(x, 0.99)),
                max=float(x.max()), top1_share=top)


def bounce_rays(org, dirn, t, tri, soup, seed, eps=1e-3):
    """One bounce of the hit lanes, in hit order: origins at the hits
    offset by eps along the face normal (turned to the incoming ray's
    side), directions cosine-weighted about that normal from a seeded
    torch.Generator on the card."""
    import torch
    hit = tri >= 0
    d = dirn[hit] / dirn[hit].norm(dim=1, keepdim=True)
    p = org[hit] + t[hit, None] * dirn[hit]
    j = tri[hit].long()
    nrm = torch.stack([soup.nx[j], soup.ny[j], soup.nz[j]], 1)
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    nrm = torch.where(((nrm * d).sum(1) > 0)[:, None], -nrm, nrm)
    g = torch.Generator(device=org.device)
    g.manual_seed(seed)
    u = torch.rand((nrm.shape[0], 2), generator=g, device=org.device)
    r, phi = u[:, 0].sqrt(), 2.0 * np.pi * u[:, 1]
    ax = torch.zeros_like(nrm)
    ax[:, 0] = 1.0
    ax[nrm[:, 0].abs() > 0.9] = torch.tensor([0.0, 1.0, 0.0],
                                             device=org.device)
    t1 = torch.linalg.cross(ax, nrm)
    t1 = t1 / t1.norm(dim=1, keepdim=True)
    t2 = torch.linalg.cross(nrm, t1)
    wi = (r * phi.cos())[:, None] * t1 + (r * phi.sin())[:, None] * t2 \
        + (1.0 - u[:, 0]).clamp_min(0.0).sqrt()[:, None] * nrm
    wi = wi / wi.norm(dim=1, keepdim=True)
    return (p + eps * nrm).contiguous(), wi.contiguous()


def cull_set(cm, org, dirn, tmax, name):
    """The tree cull on one ray set's first round (every packet): kernel
    against plain version (>= 256 packets and every overflowed one), the
    kernel's counters, its time and the plain version's.  Returns a dict
    of the numbers."""
    import torch
    from pathtracer_tpu_torch.ops import cluster as cl
    dev = org.device
    o, d, tm, _ = cl._prepare(cm, org, dirn, tmax, None)
    tx = cl.root_exit_clamp(cm.bounds, o, d, tm)
    nb = o.shape[0] // cl.BLOCK
    work = torch.zeros((nb, cl.CULL_WORK), dtype=torch.int64, device=dev)
    out_k = cl.cull_tree(cm, o, d, tx, work=work)
    torch.cuda.synchronize()
    counts = out_k[1][:, 0]
    over = (counts > cl.MAXC).nonzero()[:, 0]
    pick = torch.unique(torch.cat([torch.arange(min(256, nb), device=dev),
                                   over]))
    rows = (pick[:, None] * cl.BLOCK
            + torch.arange(cl.BLOCK, device=dev)[None]).reshape(-1)
    work_p = torch.zeros((pick.numel(), cl.CULL_WORK), dtype=torch.int64,
                         device=dev)
    out_p = cl.cull_tree_plain(cm, o[rows], d[rows], tx[rows], work=work_p)
    check_cull([x[pick] for x in out_k], out_p, work[pick], work_p)
    ms_k = cuda_ms(lambda: cl.cull_tree(cm, o, d, tx), reps=5)
    # the same packets heaviest first (by the counted cycles): how much of
    # the launch the late heavy packets hold
    perm = torch.argsort(work[:, 3], descending=True)
    rows_h = (perm[:, None] * cl.BLOCK
              + torch.arange(cl.BLOCK, device=dev)[None]).reshape(-1)
    o_h, d_h, x_h = o[rows_h], d[rows_h], tx[rows_h]
    out_h = cl.cull_tree(cm, o_h, d_h, x_h)
    if not all(torch.equal(a, b[perm]) for a, b in zip(out_h, out_k)):
        raise AssertionError('tree cull differs on reordered packets')
    ms_h = cuda_ms(lambda: cl.cull_tree(cm, o_h, d_h, x_h), reps=5)
    ms_p = cuda_ms(lambda: cl.cull_tree_plain(cm, o, d, tx), reps=1,
                   warm=False)
    # the slab tests the kernel makes: 32 rays x 2 children per 32-ray
    # chunk it tests (the TPU kernel tests all 512 lanes at every node)
    chunks = int(work[:, 6].sum())
    ops = chunks * 32 * 2 * SLAB_OPS
    ops_all_lanes = int(work[:, 0].sum()) * cl.BLOCK * 2 * SLAB_OPS
    nbytes = (cm.top_pairs.shape[0] * 64 + cm.n_clusters * 4
              + nb * cl.BLOCK * 28 + nb * (8 * cl.MAXC + 4))
    b_ms, b_by = bound(ops, nbytes)
    rep = dict(packets=nb, overflowed=int(over.numel()), checked=pick.numel(),
               ms=ms_k, ms_heavy_first=ms_h, plain_ms=ms_p, bound_ms=b_ms,
               bound_by=b_by, ops=ops, bytes=nbytes,
               bound_ms_all_lanes=bound(ops_all_lanes, nbytes)[0],
               cycles=share_report(work[:, 3]),
               stage_share=float(work[:, 4].sum() / work[:, 3].sum()),
               walk_share=float(work[:, 5].sum() / work[:, 3].sum()),
               chunks=float(work[:, 6].double().mean()),
               inner=share_report(work[:, 0]),
               leaves_mean=float(work[:, 1].double().mean()),
               count=share_report(work[:, 2]))
    log(f'tree cull, {name}: {nb} packets, {over.numel()} overflowed, '
        f'{pick.numel()} equal to the plain version (ids, counts, keys, '
        f'counters); kernel {ms_k:.4f} ms (packets heaviest first '
        f'{ms_h:.4f} ms), plain {ms_p:.3f} ms, bound {b_ms:.4f} ms '
        f'({b_by}; {rep["bound_ms_all_lanes"]:.4f} ms testing all 512 lanes '
        f'at every node)')
    log(f'  per packet: cycles mean {rep["cycles"]["mean"]:.0f} p99 '
        f'{rep["cycles"]["p99"]:.0f} max {rep["cycles"]["max"]:.0f}, '
        f'heaviest 1% {rep["cycles"]["top1_share"]:.3f} of cycles; inner '
        f'nodes mean {rep["inner"]["mean"]:.2f} p99 {rep["inner"]["p99"]:.0f}'
        f' max {rep["inner"]["max"]:.0f}; leaves reached mean '
        f'{rep["leaves_mean"]:.2f}; clusters emitted mean '
        f'{rep["count"]["mean"]:.2f} max {rep["count"]["max"]:.0f}; cycles '
        f'of the heaviest 1% of packets by emitted count: '
        f'{heavy_cycles(work[:, 2], work[:, 3]):.3f} of all')
    log(f'  cycles staging rays {rep["stage_share"]:.3f}, walking '
        f'{rep["walk_share"]:.3f}, merging the rest; per packet '
        f'{rep["chunks"]:.1f} 32-ray chunks tested (against '
        f'{16 * rep["inner"]["mean"]:.1f} for all 512 lanes at every node)')
    return rep


def hier_set(cm, org, dirn, tmax, nrm, name):
    """The hierarchical cull on one ray set's first round (every packet of
    the 2.4M-triangle mesh): kernel against _hier_cull on the card bit for
    bit in ids, counts, keys and swept ids (the plain version in
    CHUNK_PACKETS chunks, as the rounds ran it before the kernel), the
    kernel's counters, its time by CUDA events and the plain version's, and
    its operations bound (stage A's cluster x group intervals, stage B's ray
    x live candidate slabs, from the counters).  Returns a dict of the
    numbers."""
    import torch
    from pathtracer_tpu_torch.ops import cluster as cl
    dev = org.device
    o, d, tm, _ = cl._prepare(cm, org, dirn, tmax, None)
    tx = cl.root_exit_clamp(cm.bounds, o, d, tm)
    nb = o.shape[0] // cl.BLOCK
    c = cm.n_clusters
    work = torch.zeros((nb, cl.HIER_WORK), dtype=torch.int64, device=dev)
    before = launch_counts()
    out_k = cl.hier_cull(cm.bounds, o, d, tx, nrm=nrm, work=work)
    if launches_since(before)['hier_cull'] != 1:
        raise AssertionError('hier_cull did not launch its kernel once')

    def plain():
        outs = [cl._hier_cull(cm.bounds, o[sl], d[sl], tx[sl], nrm=nrm)
                for sl in cl._chunks(o.shape[0])]
        return tuple(torch.cat(x) for x in zip(*outs))

    out_p = plain()
    torch.cuda.synchronize()
    for a, b, what in zip(out_k, out_p, ('ids', 'counts', 'keys', 'swept')):
        if not same_bits(a, b):
            bad = int((a.view(torch.int32) != b.view(torch.int32))
                      .view(nb, -1).any(dim=1).sum())
            raise AssertionError(f'hier_cull {what} differ from _hier_cull '
                                 f'on {bad} packets ({name})')
    ms_k = cuda_ms(lambda: cl.hier_cull(cm.bounds, o, d, tx, nrm=nrm),
                   reps=5)
    ms_p = cuda_ms(plain, reps=1, warm=False)
    w = work.double()
    a_ops = HIER_A_OPS + (HIER_A_NRM_OPS if nrm is not None else 0)
    b_ops = HIER_B_OPS + (HIER_B_NRM_OPS if nrm is not None else 0)
    ops = int(w[:, 0].sum() * c * a_ops + (w[:, 0] > 0).sum() * c
              * HIER_KEY_OPS + w[:, 2].sum() * cl.BLOCK * b_ops)
    kk = min(c, cl.CAND_FACTOR * cl.MAXC)
    nbytes = (nb * cl.BLOCK * 28 + c * (24 if nrm is None else 48)
              + nb * (8 * cl.MAXC + 4 + 4 * (kk + cl.MAXC)))
    b_ms, b_by = bound(ops, nbytes)
    counts = out_k[1][:, 0]
    cyc = w[:, 3].sum()
    rep = dict(packets=nb, clusters=c, nrm=nrm is not None, ms=ms_k,
               plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by, ops=ops,
               bytes=nbytes, overflowed=int((counts > cl.MAXC).sum()),
               groups_mean=float(w[:, 0].mean()),
               live_clusters_mean=float(w[:, 1].mean()),
               live_candidates_mean=float(w[:, 2].mean()),
               cycles=share_report(w[:, 3]),
               stage_a_share=float(w[:, 4].sum() / cyc),
               stage_b_share=float(w[:, 5].sum() / cyc),
               count=share_report(counts))
    log(f'hier cull, {name}: {nb} packets x {c} clusters, backface bound '
        f'{"on" if nrm is not None else "off"}, {rep["overflowed"]} '
        f'overflowed; equal to _hier_cull on the card (ids, counts, keys, '
        f'swept ids); kernel {ms_k:.4f} ms, plain {ms_p:.3f} ms, bound '
        f'{b_ms:.4f} ms ({b_by}, {ops:.4g} operations)')
    log(f'  per packet: octant groups {rep["groups_mean"]:.2f}, stage-A-live '
        f'clusters {rep["live_clusters_mean"]:.1f}, live candidates '
        f'{rep["live_candidates_mean"]:.1f}; cycles mean '
        f'{rep["cycles"]["mean"]:.0f} p99 {rep["cycles"]["p99"]:.0f} max '
        f'{rep["cycles"]["max"]:.0f}, heaviest 1% '
        f'{rep["cycles"]["top1_share"]:.3f}; cycles to stage A\'s sort end '
        f'{rep["stage_a_share"]:.3f}, stage B {rep["stage_b_share"]:.3f}, '
        f'the emission the rest')
    return rep


def face_normals(cm):
    """The BVH-ordered triangles' cross(u, v) as a (nx, ny, nz) namespace
    on the card, which bounce_rays reads as a soup's."""
    import types
    import torch
    tri = cm.host_tris.astype(np.float64)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    dev = cm.ctab.device
    return types.SimpleNamespace(**{
        k: torch.as_tensor(n[:, i].astype(np.float32), device=dev)
        for i, k in enumerate(('nx', 'ny', 'nz'))})


def hier_phase(sc, org_l, dir_l, tmax0, t, tri, dev):
    """hier_set on the main path's 1080p primaries and on one bounce of
    their hits (mesh space), each with the backface bound off (the
    benchmark's cell) and on.  Returns the kernel record."""
    import torch
    from pathtracer_tpu_torch.ops import cluster as cl
    cm = sc.meshes[0].clustered
    info = {k: cl.hier_cull_kernel_info(cm.n_clusters, nrm=k)
            for k in (False, True)}
    log(f'hier cull kernel on {cm.n_clusters} clusters (registers, resident '
        f'blocks per SM, shared bytes, threads): without normal bounds '
        f'{info[False]}, with {info[True]}')
    n0 = org_l.shape[0]
    prim = {k: hier_set(cm, org_l, dir_l, tmax0, cm.nrm if k else None,
                        f'1080p primaries{" (backface)" if k else ""}')
            for k in (False, True)}
    b_org, b_dir = bounce_rays(org_l, dir_l, t[:n0], tri[:n0],
                               face_normals(cm), seed=5)
    b_max = torch.full((b_org.shape[0],), BIG_T, device=dev)
    bnc = {k: hier_set(cm, b_org, b_dir, b_max, cm.nrm if k else None,
                       f'one bounce ({b_org.shape[0]} rays)'
                       f'{" (backface)" if k else ""}')
           for k in (False, True)}
    p, b = prim[False], bnc[False]
    return entry(
        'hier_cull', 'pathtracer_tpu_torch/csrc/cluster_hier_cull.cu',
        'pathtracer_tpu/ops/pallas_cluster.py:1258 (XLA code; no '
        'pallas_call)', 0.0, 1.0, p['ms'], p['plain_ms'], p['ops'],
        p['bytes'], primaries=p, bounce=b, primaries_backface=prim[True],
        bounce_backface=bnc[True], ms_bounce=b['ms'],
        plain_ms_bounce=b['plain_ms'], bound_ms_bounce=b['bound_ms'],
        registers=info[False][0], blocks_per_sm=info[False][1],
        threads=info[False][3])


def heavy_cycles(key, cyc):
    """Share of all cycles spent by the 1% of units with the largest
    `key`."""
    import torch
    n1 = max(1, key.numel() // 100)
    top = torch.argsort(key, descending=True)[:n1]
    return float(cyc[top].double().sum() / max(float(cyc.double().sum()), 1))


def tree_phase(dev, cam):
    """The tree-cull tier on a mesh of more than DENSE_CULL_MAX clusters:
    kernel against plain version on the 1080p primaries and on one bounce
    of them, then the tier end to end against the dense tier.  Returns
    the cull kernel's record."""
    import torch
    from pathtracer_tpu_torch.ops import bvh as bvh_mod
    from pathtracer_tpu_torch.ops import cluster as cl
    from pathtracer_tpu_torch.ops import traverse as tt
    from pathtracer_tpu_torch.utils import procgen
    t0 = time.perf_counter()
    md = procgen.sphere_mesh(1300, 1300, radius=14.0, displace_amp=0.25)
    tri = md.vertices[md.vtx_idx]
    fb = bvh_mod.build_bvh(tri)
    cm = cl.build_clustered(tri, fb=fb, tris_c=256, dev=dev)
    cm_dense = cl.build_clustered(tri, fb=fb, dev=dev)
    soup = tt.make_soup(tri[fb.order], device=dev)
    bvh = tt.upload_bvh(fb, device=dev)
    info = cl.cull_kernel_info(cm)
    log(f'tree phase build {time.perf_counter() - t0:.1f} s: '
        f'{tri.shape[0]} tris, {cm.n_clusters} clusters of <= 256 tris '
        f'(top depth < {cl.STACK_DEPTH}, max leaf {cm.top_max_leaf}, '
        f'{cm.top_pairs.shape[0]} inner nodes, depth {cm.top_depth}); dense '
        f'build {cm_dense.n_clusters} clusters; cull kernel {info[0]} '
        f'registers, {info[1]} resident blocks of {info[3]} threads per SM, '
        f'{info[2]} B shared per block')
    if not cm.n_clusters > cl.DENSE_CULL_MAX >= cm_dense.n_clusters:
        raise AssertionError('the tree phase needs a tree-tier and a '
                             'dense-tier build of one mesh')
    org, dirn = primary_rays(cam, dev)
    org = org - torch.tensor([0.0, -15.0, 0.0], device=dev)   # mesh space
    n = org.shape[0]
    tmax = torch.full((n,), BIG_T, device=dev)

    # ---- kernel against plain version: the first round's cull ----
    prim = cull_set(cm, org, dirn, tmax, '1080p primaries')

    # ---- the tier end to end, against the dense tier ----
    counted = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t, tri_id, res = cl.two_level_hit(cm, org, dirn, tmax,
                                      return_residual=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = launches_since(counted)['cull_tree']
    n_res = int(res.sum())
    t, tri_id, _, _ = tt.bvh_hit_sparse(bvh, soup, org, dirn, res,
                                        fb.max_leaf, t, tri_id,
                                        torch.ones_like(t),
                                        torch.zeros_like(t))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    t_d, tri_d = cl.two_level_hit(cm_dense, org, dirn, tmax)
    same = tri_id == tri_d
    frac = float(same.float().mean())
    one = int(((tri_id >= 0) != (tri_d >= 0)).sum())
    hit = same & (tri_d >= 0)
    terr = (t[hit] - t_d[hit]).abs()
    log(f'tree tier end to end: {n_res} residual lanes after refine, '
        f'two_level_hit {1e3 * (t1 - t0):.1f} ms, bvh_hit_sparse net '
        f'{1e3 * (t2 - t1):.1f} ms (host clock); vs dense tier tri '
        f'agreement {frac:.6f}, {one} lanes hit in one build only, hit '
        f'share {float((tri_d >= 0).float().mean()):.3f}; cull launches '
        f'{launches}')
    if frac < 0.999:
        raise AssertionError(f'tree tier tri agrees on only {frac:.5f}')
    if one > 0.0005 * n:
        raise AssertionError(f'{one} lanes hit in one build only')
    if bool((terr > 1e-5 * t_d[hit].abs()).any()):
        raise AssertionError('tree tier t differs beyond 1e-5 relative')
    if launches <= 0:
        raise AssertionError('cull_tree never launched on the tree tier')

    # ---- one bounce of the primaries that hit ----
    b_org, b_dir = bounce_rays(org, dirn, t, tri_id, soup, seed=5)
    bnc = cull_set(cm, b_org, b_dir,
                   torch.full((b_org.shape[0],), BIG_T, device=dev),
                   f'one bounce ({b_org.shape[0]} rays)')
    rec = entry(
        'cull_tree', 'pathtracer_tpu_torch/csrc/cluster_cull.cu',
        'pathtracer_tpu/ops/pallas_cluster.py:538', 0.0, 1.0, prim['ms'],
        prim['plain_ms'], prim['ops'],
        prim['bytes'], primaries=prim, bounce=bnc, ms_bounce=bnc['ms'],
        plain_ms_bounce=bnc['plain_ms'], bound_ms_bounce=bnc['bound_ms'],
        registers=info[0], blocks_per_sm=info[1], threads=info[3])
    rec['launches'] = launches
    return rec


# ---------------------------------------------------------------------------
# Routed phase: the routed cluster tier (upload_mesh(use_routed=True))
# ---------------------------------------------------------------------------

ROUTED_WAVES = 2        # timed 1080p routed waves, after a warm-up (median)
ROUTED_BOUNCE_STRIDE = 4   # R1 holds every 4th 512-ray packet of the bounce:
                           # nearly all its lanes are residual, and the
                           # lockstep net took 19.3 s on all 1,118 packets
                           # (an H100 at 700 W)


@contextlib.contextmanager
def plain_sweeps():
    """cluster.cluster_sweep replaced by its plain version on the same
    tensors (on the card too): no launch, no count."""
    from unittest import mock
    from pathtracer_tpu_torch.ops import cluster as cl

    def plain(cm, ids, counts, keys, org, dirn, tmax, tmin, group=None,
              order=None, stats=None):
        return cl.cluster_sweep_plain(cm, ids, counts, keys, org, dirn, tmax,
                                      tmin, group, stats)

    with mock.patch.object(cl, 'cluster_sweep', plain):
        yield


@contextlib.contextmanager
def net_timer():
    """Time each traverse.bvh_hit_sparse call (the residual lanes' net) on
    the host clock, the card synchronized before and after.  Yields
    [seconds, calls, lanes]."""
    import torch
    from unittest import mock
    from pathtracer_tpu_torch.ops import traverse as tt
    f = tt.bvh_hit_sparse
    acc = [0.0, 0, 0]

    def timed_net(bvh, soup, org, dirn, res, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = f(bvh, soup, org, dirn, res, *a, **k)
        torch.cuda.synchronize()
        acc[0] += time.perf_counter() - t0
        acc[1] += 1
        acc[2] += int(res.sum())
        return out

    with mock.patch.object(tt, 'bvh_hit_sparse', timed_net):
        yield acc


def routed_net(cm, soup, bvh, max_leaf, org, dirn, tmax):
    """routed_hit with its residual lanes, then scene.py's net: ((t, tri)
    after the net, the residual mask, the route log of the call)."""
    import torch
    from pathtracer_tpu_torch.ops import routed_cluster as rc
    from pathtracer_tpu_torch.ops import traverse as tt
    rc.ROUTE_LOG = []
    try:
        t, tri, res = rc.routed_hit(cm, org, dirn, tmax, return_residual=True,
                                    with_bary=False)
        route = rc.ROUTE_LOG[0]
    finally:
        rc.ROUTE_LOG = None
    t, tri, _, _ = tt.bvh_hit_sparse(bvh, soup, org, dirn, res, max_leaf, t,
                                     tri, torch.ones_like(t),
                                     torch.zeros_like(t))
    return (t, tri), res, route


def agree(t, tri, t_d, tri_d, what, net=None):
    """The tree phase's standard for one tier against another: tri equal on
    >= 99.9% of lanes, at most 0.05% of lanes hit in one only, t within
    1e-5 relative where tri agrees.  `net` ((N,) bool, optional): lanes a
    bvh_hit_sparse net resolved in either tier, whose t comes from the
    edge-matrix formula, not the sweep's plane formula: there t is held
    within 1e-5 relative + 1e-5, the tolerance between the two formulas of
    tests/test_torch_tiers.py (a bounce ray hits at t ~ 1e-2, where the
    formulas' rounding at the scene's scale exceeds 1e-5 of t).  Returns
    the numbers."""
    import torch
    same = tri == tri_d
    frac = float(same.float().mean())
    one = int(((tri >= 0) != (tri_d >= 0)).sum())
    hit = same & (tri_d >= 0)
    net = torch.zeros_like(tri, dtype=torch.bool) if net is None else net
    err = (t - t_d).abs()
    sweep = hit & ~net
    rel = float((err[sweep] / t_d[sweep].abs()).max()) \
        if bool(sweep.any()) else 0.0
    formula = hit & net
    net_bad = int((err[formula] > 1e-5 * t_d[formula].abs() + 1e-5).sum())
    if frac < 0.999 or one > 0.0005 * tri.shape[0] or rel > 1e-5 \
            or net_bad:
        raise AssertionError(f'{what}: tri agrees on {frac:.6f}, {one} '
                             f'lanes hit in one only, t rel {rel:.3g}, '
                             f'{net_bad} net lanes beyond the formulas\' '
                             f'tolerance')
    return dict(tri_agree=frac, hit_in_one=one, t_rel_max=rel,
                net_lanes_compared=int(formula.sum()),
                hit_share=float((tri_d >= 0).float().mean()))


def route_numbers(logs):
    """Per routed_hit call of `logs` (routed_cluster.ROUTE_LOG entries):
    run packets and routed lanes a round, the share of the run packets'
    lanes that are padding, packets refined, residual lanes."""
    runs = [r for e in logs for r in e['runs']]
    lanes = [x for e in logs for x in e['lanes']]
    return dict(calls=len(logs), run_packets=runs, routed_lanes=lanes,
                padding_share=1.0 - sum(lanes) / max(1, sum(runs) * 512),
                refined_packets=[x for e in logs for x in e['refined']],
                residual_lanes=[e['residual'] for e in logs])


def routed_hits(mesh, org, dirn, name):
    """R1 on one ray set: routed_hit through the kernels, bit-equal in t,
    tri and residual lanes to the same call with the sweeps' plain
    versions on the card; after the net, against two_level_hit (backface
    cull off, exhaustive).  Returns (numbers, (t, tri) after the net)."""
    import torch
    from pathtracer_tpu_torch.ops import cluster as cl
    from pathtracer_tpu_torch.ops import routed_cluster as rc
    cm = mesh.clustered
    tmax = torch.full((org.shape[0],), BIG_T, device=org.device)
    counted = launch_counts()
    (hits, res, route), ms = timed(lambda: routed_net(
        cm, mesh.soup, mesh.bvh, mesh.max_leaf, org, dirn, tmax))
    launches = launches_since(counted)['cluster_sweep_closest']
    with plain_sweeps():
        (t_p, tri_p, res_p), plain_ms = timed(lambda: rc.routed_hit(
            cm, org, dirn, tmax, return_residual=True, with_bary=False))
    if launches_since(counted)['cluster_sweep_closest'] != launches:
        raise AssertionError('the plain sweeps launched a kernel')
    (t_k, tri_k, res_k), ms_k = timed(lambda: rc.routed_hit(
        cm, org, dirn, tmax, return_residual=True, with_bary=False))
    if not (same_bits((t_k, tri_k), (t_p, tri_p))
            and torch.equal(res_k, res_p)):
        raise AssertionError(f'routed_hit, {name}: the kernels differ from '
                             f'the plain sweeps')
    (t_d, tri_d), two_ms = timed(lambda: cl.two_level_hit(cm, org, dirn,
                                                          tmax))
    rep = dict(rays=org.shape[0], ms_with_net=ms, ms=ms_k,
               plain_sweeps_ms=plain_ms, two_level_ms=two_ms,
               sweep_launches=launches, residual=int(res.sum()),
               **route_numbers([route]),
               **agree(hits[0], hits[1], t_d, tri_d, f'routed, {name}',
                       net=res))
    log(f'routed_hit, {name}: {rep["rays"]} rays, {ms_k:.1f} ms ({ms:.1f} '
         f'with the net; two_level_hit {two_ms:.1f} ms); bit-equal to the '
         f'plain sweeps ({plain_ms:.1f} ms); {launches} sweep launches; run '
         f'packets {rep["run_packets"]}, padding '
         f'{rep["padding_share"]:.3f}; refined {rep["refined_packets"]}; '
         f'{rep["residual"]} residual lanes; vs two_level_hit tri '
         f'{rep["tri_agree"]:.6f}, {rep["hit_in_one"]} hit in one only')
    return rep, hits


def routed_scene(sc, dev, lat=1100):
    """The main path's scene (big_scene: its sphere at `lat`) with the
    sphere uploaded routed, the mesh's own backface flag kept for its
    shadows, as build_scene gated it."""
    import dataclasses as dc
    from pathtracer_tpu_torch.scene import mesh as mesh_mod
    from pathtracer_tpu_torch.utils import procgen
    md = procgen.sphere_mesh(lat, lat, radius=14.0, displace_amp=0.25)
    m0 = sc.meshes[0]
    m = mesh_mod.upload_mesh(md, obj_row=m0.obj_row, use_routed=True,
                             dev=dev)
    if m.soup is None or m.bvh is None or m.n_clusters != m0.n_clusters:
        raise AssertionError('the routed upload must keep soup and BVH')
    m = dc.replace(m, backface_cull=m0.backface_cull)
    return sc.replace(meshes=(m,))


def samples_agree(a, b, what):
    """PERF.md §2's per-sample rule: < 5% of samples beyond 1e-3 of the
    image scale, means within 2%.  Returns the numbers."""
    scale = max(float(np.abs(b).max()), 1e-6)
    rel = np.abs(a - b).max(-1) / scale
    flipped = float((rel > 1e-3).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / scale
    if flipped >= 0.05 or mean_rel >= 0.02 or not np.isfinite(a).all():
        raise AssertionError(f'{what}: {flipped:.5f} of samples flipped, '
                             f'mean rel {mean_rel:.4g}')
    return dict(flipped=flipped, mean_rel=mean_rel)


def routed_phase(sc, cam, card, main_rep, lat=1100):
    """R1 and R2 on the main path's scene (`lat` as routed_scene): the
    routed tier's hits against the kernels' plain versions and
    two_level_hit, its 1080p wave beside the main path's.  Returns (launch
    counts of the timed waves, the numbers)."""
    import torch
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.ops import routed_cluster as rc
    from pathtracer_tpu_torch.render import renderer as rnd
    from pathtracer_tpu_torch.core import rng_host
    dev = cam.position.device
    t0 = time.perf_counter()
    rsc = routed_scene(sc, dev, lat)
    mesh = rsc.meshes[0]
    rep = dict(upload_s=time.perf_counter() - t0)
    log(f'routed upload {rep["upload_s"]:.1f} s: {mesh.n_tris} tris, '
        f'{mesh.n_clusters} clusters, soup and BVH kept')

    # ---- R1: hits on the 1080p primaries and one bounce of them ----
    org, dirn = primary_rays(cam, dev)
    org = org - torch.tensor([0.0, -15.0, 0.0], device=dev)   # mesh space
    rep['primaries'], (t, tri) = routed_hits(mesh, org, dirn,
                                             '1080p primaries')
    b_org, b_dir = bounce_rays(org, dirn, t, tri, mesh.soup, seed=5)
    keep = torch.arange(b_org.shape[0], device=dev) // 512 \
        % ROUTED_BOUNCE_STRIDE == 0
    b_org, b_dir = b_org[keep], b_dir[keep]
    rep['bounce'], _ = routed_hits(
        mesh, b_org, b_dir, f'one bounce, every {ROUTED_BOUNCE_STRIDE}th '
        f'packet ({b_org.shape[0]} rays)')

    # ---- R2: the 1080p wave ----
    cfg = pt.RenderConfig(width=W, height=H, nrays=8, nb_bounces=BOUNCES,
                          samples_per_wave=1, compact_rays=True)
    r = pt.Renderer(rsc, cam, cfg)
    rc.ROUTE_LOG = []
    try:
        with net_timer() as net:
            counted = launch_counts()
            r.step()                            # warm-up, instrumented
            torch.cuda.synchronize()
            warm = launches_since(counted)
        logs = rc.ROUTE_LOG
    finally:
        rc.ROUTE_LOG = None
    ms, live = [], []
    counted = launch_counts()
    for _ in range(ROUTED_WAVES):
        rays0 = r.rays_traced
        _, t_ms = timed(r.step)
        ms.append(t_ms)
        live.append(r.rays_traced - rays0)
    launches = launches_since(counted)
    img = r.display().cpu().numpy()
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError('routed image not finite / wrong shape')
    if launches['cluster_sweep_closest'] <= 0:
        raise AssertionError('cluster_sweep never launched on the routed '
                             'path')
    med = float(np.median(ms))
    rays_s = float(np.median([n / (m / 1e3) for n, m in zip(live, ms)]))
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(W, H), device=dev)
    one = rnd.RenderConfig(width=W, height=H, nrays=1, nb_bounces=BOUNCES,
                           compact_rays=True)
    smp = [rnd.render_unsplatted(s, cam, cp, one)[1].cpu().numpy()
           for s in (rsc, sc)]
    rep['wave'] = dict(
        ms=spread(ms), live_rays_per_s=rays_s,
        launches_per_wave={k: v / ROUTED_WAVES for k, v in launches.items()
                           if v},
        warm_up_launches={k: v for k, v in warm.items() if v},
        net_ms=net[0] * 1e3, net_calls=net[1], net_lanes=net[2],
        **route_numbers(logs),
        two_level=main_rep,
        image=samples_agree(smp[0], smp[1], 'routed vs two-level 1080p'))
    w = rep['wave']
    log(f'routed wave 1080p x 2.4M tris, 3 bounces, compaction: {med:.1f} ms '
        f'median of {ROUTED_WAVES} ({", ".join(f"{x:.1f}" for x in ms)}), '
        f'{rays_s:.4g} live rays/s; two-level main path '
        f'{main_rep["ms_median"]:.1f} ms, {main_rep["live_rays_per_s"]:.4g} '
        f'live rays/s ({card}); launches per wave '
        f'{w["launches_per_wave"]} (two-level '
        f'{main_rep["launches_per_wave"]}); warm-up: {w["calls"]} routed '
        f'queries, run packets a round {w["run_packets"]}, padding share '
        f'{w["padding_share"]:.3f}, residual lanes {w["residual_lanes"]}, '
        f'net {w["net_ms"]:.1f} ms on {w["net_lanes"]} lanes in '
        f'{w["net_calls"]} calls (host clock); image vs two-level per '
        f'sample: flipped {w["image"]["flipped"]:.5f}, mean rel '
        f'{w["image"]["mean_rel"]:.3g}')
    return launches, rep


def routed_tree(dev, cam, lat=1300):
    """R3: the tree phase's 3.4M-tri sphere (`lat` 1300: 19,006 clusters
    of 256; its host builds come from utils/hostcache) through routed_hit
    and the net on the 1080p primaries, against the tree phase's
    two_level_hit and net.  The tree cull kernel must launch."""
    import torch
    from pathtracer_tpu_torch.ops import bvh as bvh_mod
    from pathtracer_tpu_torch.ops import cluster as cl
    from pathtracer_tpu_torch.ops import traverse as tt
    from pathtracer_tpu_torch.utils import procgen
    t0 = time.perf_counter()
    md = procgen.sphere_mesh(lat, lat, radius=14.0, displace_amp=0.25)
    tri = md.vertices[md.vtx_idx]
    fb = bvh_mod.build_bvh(tri)
    cm = cl.build_clustered(tri, fb=fb, tris_c=256, dev=dev)
    soup = tt.make_soup(tri[fb.order], device=dev)
    bvh = tt.upload_bvh(fb, device=dev)
    build_s = time.perf_counter() - t0
    if not cm.n_clusters > cl.DENSE_CULL_MAX:
        raise AssertionError('R3 needs a tree-tier build')
    org, dirn = primary_rays(cam, dev)
    org = org - torch.tensor([0.0, -15.0, 0.0], device=dev)
    tmax = torch.full((org.shape[0],), BIG_T, device=dev)
    counted = launch_counts()
    ((t, tri_id), res, route), ms = timed(lambda: routed_net(
        cm, soup, bvh, fb.max_leaf, org, dirn, tmax))
    counts = launches_since(counted)

    def two_level():
        t_, tri_, res_ = cl.two_level_hit(cm, org, dirn, tmax,
                                          return_residual=True)
        return tt.bvh_hit_sparse(bvh, soup, org, dirn, res_, fb.max_leaf,
                                 t_, tri_, torch.ones_like(t_),
                                 torch.zeros_like(t_))[:2] + (res_,)

    (t_d, tri_d, res_d), two_ms = timed(two_level)
    rep = dict(build_s=build_s, clusters=cm.n_clusters, ms_with_net=ms,
               two_level_ms_with_net=two_ms,
               launches={k: v for k, v in counts.items() if v},
               residual=int(res.sum()), **route_numbers([route]),
               **agree(t, tri_id, t_d, tri_d, 'routed tree tier',
                       net=res | res_d))
    if counts['cull_tree'] <= 0:
        raise AssertionError('cull_tree never launched on the routed tree '
                             'tier')
    log(f'routed tree tier: build {build_s:.1f} s (host cache), '
        f'{cm.n_clusters} clusters; 1080p primaries {ms:.1f} ms with the '
        f'net (two_level_hit + net {two_ms:.1f} ms); launches '
        f'{rep["launches"]}; run packets {rep["run_packets"]}, padding '
        f'{rep["padding_share"]:.3f}; {rep["residual"]} residual lanes; vs '
        f'the tree phase\'s tier tri {rep["tri_agree"]:.6f}, '
        f'{rep["hit_in_one"]} hit in one only')
    return rep


def walk_set(mesh, org, dirn, tmax, name):
    """The packet kernel on one ray set: bit-equal to packet_walk_plain
    (t, tri, alpha, beta, per-ray counters) on every lane, against the
    brute-force plain version within its tolerance, counters, times."""
    import torch
    from pathtracer_tpu_torch.ops import packet_bvh as pb
    n = org.shape[0]
    work = torch.zeros((n, pb.WORK), dtype=torch.int32, device=org.device)
    out_k = pb.packet_hit(mesh.packed, mesh.soup, org, dirn, tmax, work=work)
    out_w = pb.packet_walk_plain(mesh.packed, mesh.soup, org, dirn, tmax)
    torch.cuda.synchronize()
    for a, b, what in zip(out_k + (work[:, :2],), out_w,
                          ('t', 'tri', 'alpha', 'beta', 'counters')):
        if not torch.equal(a, b):
            bad = int((a != b).view(n, -1).any(dim=1).sum())
            raise AssertionError(f'packet kernel, {name}: {what} differs '
                                 f'from packet_walk_plain on {bad} lanes')
    t_k, tri_k = out_k[0], out_k[1]
    t_p, tri_p, _, _ = pb.packet_hit_plain(mesh.soup, org, dirn, tmax)
    same = tri_k == tri_p
    frac = float(same.float().mean())
    flips = ~same & ((tri_k < 0) != (tri_p < 0))
    n_flip = int(flips.sum())
    tie = ~same & ~flips
    hit = same & (tri_p >= 0)
    err = (t_k[hit] - t_p[hit]).abs()
    if frac < 0.999:
        raise AssertionError(f'packet tri agrees on only {frac:.5f}')
    if n_flip > 1e-4 * n:
        raise AssertionError(f'{n_flip} lanes hit in one version only')
    if bool(((t_k[tie] - t_p[tie]).abs() > TIE * t_p[tie].abs()).any()):
        raise AssertionError('packet ties beyond 2^-16 relative t')
    if bool((err > 1e-5 * t_p[hit].abs()).any()):
        raise AssertionError('packet t differs beyond 1e-5 relative')
    ms_k = cuda_ms(lambda: pb.packet_hit(mesh.packed, mesh.soup, org, dirn,
                                         tmax), reps=10)
    # the same rays with their 32-ray batches heaviest first (by the
    # counted cycles): how much of the launch the late heavy batches hold
    cyc = work[:n // 32 * 32, 2].view(-1, 32).amax(dim=1)
    rows = torch.cat([(torch.argsort(cyc, descending=True)[:, None] * 32
                       + torch.arange(32, device=org.device)).reshape(-1),
                      torch.arange(n // 32 * 32, n, device=org.device)])
    o_h, d_h, m_h = org[rows].contiguous(), dirn[rows].contiguous(), \
        tmax[rows].contiguous()
    out_h = pb.packet_hit(mesh.packed, mesh.soup, o_h, d_h, m_h)
    if not all(torch.equal(a, b[rows]) for a, b in zip(out_h, out_k)):
        raise AssertionError('packet kernel differs on reordered rays')
    ms_h = cuda_ms(lambda: pb.packet_hit(mesh.packed, mesh.soup, o_h, d_h,
                                         m_h), reps=10)
    ms_p = cuda_ms(lambda: pb.packet_hit_plain(mesh.soup, org, dirn, tmax),
                   reps=1, warm=False)
    ms_w = cuda_ms(lambda: pb.packet_walk_plain(mesh.packed, mesh.soup, org,
                                                dirn, tmax), reps=1,
                   warm=False)
    inner, tests = (int(x) for x in work[:, :2].long().sum(dim=0))
    ops = inner * 2 * SLAB_OPS + tests * TRI_TEST_OPS
    nbytes = n * 48 + mesh.packed.box.shape[0] * 36 + mesh.n_tris * 64
    b_ms, b_by = bound(ops, nbytes)
    w32 = work[:n // 32 * 32].view(-1, 32, pb.WORK).double()
    warp_cyc = w32[:, :, 2].amax(dim=1)
    load_share = float(w32[:, :, 3].amax(dim=1).sum() / warp_cyc.sum())
    steps = w32[:, :, 0] + w32[:, :, 1]
    simd = float((steps.mean(dim=1) / steps.amax(dim=1).clamp_min(1)).mean())
    # SIMT efficiency: lane steps over 32 x the warp's runs of each path
    wsum = work.long().sum(dim=0).double()
    simt_inner = float(wsum[0] / (32 * wsum[4]).clamp_min(1))
    simt_tri = float(wsum[1] / (32 * wsum[5]).clamp_min(1))
    rep = dict(rays=n, ms=ms_k, ms_heavy_first=ms_h,
               plain_ms=ms_p,
               walk_plain_ms=ms_w, load_share=load_share,
               bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
               tri_agree_brute=frac,
               flips_brute=n_flip,
               max_abs_err=float(err.max()) if err.numel() else 0.0,
               hit_share=float((tri_k >= 0).float().mean()),
               inner_per_ray=inner / n, tests_per_ray=tests / n,
               inner_max=int(work[:, 0].max()), tests_max=int(work[:, 1].max()),
               warp_cycles=share_report(warp_cyc), lane_utilization=simd,
               simt_inner=simt_inner, simt_tri=simt_tri)
    log(f'packet kernel, {name}: {n} rays, equal to packet_walk_plain bit '
        f'for bit (t, tri, alpha, beta, counters); vs brute force tri '
        f'{frac:.6f}, {n_flip} hit/miss flips, {int(tie.sum())} ties; hit '
        f'share {rep["hit_share"]:.3f}; kernel {ms_k:.4f} ms (batches heaviest '
        f'first {ms_h:.4f} ms), brute force {ms_p:.3f} ms, walk '
        f'plain {ms_w:.3f} ms, bound {b_ms:.4f} ms ({b_by})')
    log(f'  per ray {inner / n:.2f} inner nodes (max {rep["inner_max"]}), '
        f'{tests / n:.2f} triangle tests (max {rep["tests_max"]}); per warp '
        f'of 32 rays: cycles mean {rep["warp_cycles"]["mean"]:.0f} p99 '
        f'{rep["warp_cycles"]["p99"]:.0f} max '
        f'{rep["warp_cycles"]["max"]:.0f}, heaviest 1% '
        f'{rep["warp_cycles"]["top1_share"]:.3f} of cycles, {load_share:.3f} '
        f'of cycles loading the rays; lane utilization (mean steps / max '
        f'steps per warp) {simd:.3f}; SIMT efficiency of inner-node steps '
        f'{simt_inner:.3f}, of triangle tests {simt_tri:.3f}')
    return rep


def packet_phase(dev, cam, card):
    """The packet tier: kernel against packet_walk_plain and the brute
    force at 1080p primaries and on one bounce of them, then Renderer
    waves through it, against the cluster tier's image.  Returns the
    packet kernel's record."""
    import torch
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.ops import packet_bvh as pb
    from pathtracer_tpu_torch.scene import mesh as mesh_mod
    from pathtracer_tpu_torch.scene import scene as scn
    from pathtracer_tpu_torch.utils import procgen
    md = procgen.sphere_mesh(32, 32, radius=12.0, displace_amp=0.25)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    sc_c = scn.build_scene(objs, scn.default_light_intensity(), device=dev)
    row = sc_c.meshes[0].obj_row
    mesh = mesh_mod.upload_mesh(md, obj_row=row, use_cluster=False, dev=dev)
    if not (mesh.use_packet and not mesh.use_cluster):
        raise AssertionError('the mesh did not take the packet tier')
    sc_p = dataclasses.replace(sc_c, meshes=(mesh,))
    info = pb.kernel_info(mesh.packed)
    log(f'packet tier: {mesh.n_tris} tris, {mesh.packed.pairs.shape[0]} '
        f'inner nodes, depth {mesh.packed.depth}, max leaf '
        f'{mesh.packed.max_leaf}; packet kernel {info[0]} registers, '
        f'{info[1]} resident blocks of {info[3]} threads per SM, {info[2]} B '
        f'shared per block')

    # ---- kernel against plain versions: the main path's mesh query ----
    org, dirn = primary_rays(cam, dev)
    tmax = scn._candidate_ts(sc_p, org, dirn)[0].amin(dim=-1)
    org_l, dir_l = scn._local_ray_row(sc_p, row, org, dirn)
    org_l, dir_l = org_l.contiguous(), dir_l.contiguous()
    prim = walk_set(mesh, org_l, dir_l, tmax, '1080p primaries')
    t_k, tri_k, _, _ = pb.packet_hit(mesh.packed, mesh.soup, org_l, dir_l,
                                     tmax)
    b_org, b_dir = bounce_rays(org_l, dir_l, t_k, tri_k, mesh.soup, seed=7)
    bnc = walk_set(mesh, b_org, b_dir,
                   torch.full((b_org.shape[0],), BIG_T, device=dev),
                   f'one bounce ({b_org.shape[0]} rays)')
    rec = entry(
        'packet_hit', 'pathtracer_tpu_torch/csrc/packet_bvh.cu',
        'pathtracer_tpu/ops/pallas_bvh.py:41', prim['max_abs_err'], 1.0,
        prim['ms'], prim['plain_ms'], prim['ops'], prim['bytes'],
        primaries=prim, bounce=bnc,
        ms_bounce=bnc['ms'], plain_ms_bounce=bnc['plain_ms'],
        bound_ms_bounce=bnc['bound_ms'], registers=info[0],
        blocks_per_sm=info[1], threads=info[3])

    # ---- Renderer through the packet tier, against the cluster tier ----
    cfg = pt.RenderConfig(width=W, height=H, nrays=8, nb_bounces=BOUNCES,
                          samples_per_wave=1, compact_rays=True)
    waves = 2
    imgs = {}
    for name, sc in (('packet', sc_p), ('cluster', sc_c)):
        r = pt.Renderer(sc, cam, cfg)
        counted = launch_counts()
        r.step()                                   # warm-up wave
        torch.cuda.synchronize()
        rays0 = r.rays_traced
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(waves):
            r.step()
        stop.record()
        torch.cuda.synchronize()
        if name == 'packet':
            rec['launches'] = launches_since(counted)['packet_hit']
        ms_wave = start.elapsed_time(stop) / waves
        live = r.rays_traced - rays0
        imgs[name] = r.display().cpu().numpy()
        log(f'{name} tier render {W}x{H}, 2k tris, 3 bounces, compaction: '
            f'{ms_wave:.1f} ms/wave, {live / (waves * ms_wave / 1e3):.4g} '
            f'live rays/s ({card})')
    a, b = imgs['packet'], imgs['cluster']
    if not np.isfinite(a).all() or a.std() <= 0.01:
        raise AssertionError('packet-tier image not finite / not lit')
    scale = max(np.abs(b).max(), 1e-6)
    rel = np.abs(a - b).max(-1) / scale
    beyond = float((rel > 1e-3).mean())
    mean_rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-6)
    log(f'packet vs cluster tier image: {beyond:.5f} of pixels beyond 1e-3 '
        f'relative, means within {mean_rel:.3g}; packet launches '
        f'{rec["launches"]}')
    if beyond >= 0.01 or mean_rel >= 0.01:
        raise AssertionError('packet-tier image disagrees with the cluster '
                             'tier')
    if rec['launches'] <= 0:
        raise AssertionError('packet_hit never launched on the packet tier')
    return rec


def drive(fn, needs):
    """Run one probe entry point; returns (its result, each probe kernel's
    launches in it) and raises if a kernel in `needs` never launched."""
    counted = launch_counts()
    out = fn()
    counts = launches_since(counted, PROBE_KERNELS)
    for k in needs:
        if counts[k] <= 0:
            raise AssertionError(f'{k} never launched on its probe path')
    return out, counts


def check_dot(kern, tf32, x, w, reps, eps, out_cols):
    """A product kernel against its plain version: fp32 bit-equal, TF32
    within TF32_TOL of the absolute-value bound.  Returns (max |diff|,
    largest diff over its bound)."""
    import torch
    from pathtracer_tpu_torch.ops import sweep_micro as sm
    out_k = kern(x, w, reps, eps, out_cols)
    out_p = sm.dot_plain(x, w, reps, eps, out_cols, tf32)
    if not tf32:
        if not same_bits(out_k, out_p):
            raise AssertionError('fp32 product differs from its plain '
                                 'version')
        return 0.0, 0.0
    b = sm.dot_plain(x.abs(), w.abs(), reps, eps, w.shape[1])[0]
    pairs = []
    for k, p, bb in zip(out_k, out_p, (b[:, :out_cols], b[:, 0::2]
                                       + b[:, 1::2])):
        d = (k - p).abs()
        pairs.append((float(d.max()), float((d / bb).max())))
    err, ratio = max(e for e, _ in pairs), max(r for _, r in pairs)
    if not ratio <= sm.TF32_TOL:
        raise AssertionError(f'TF32 product off its plain version by '
                             f'{ratio:.3g} of the bound (> {sm.TF32_TOL})')
    return err, ratio


def check_fma(dev):
    """sweep_micro.fma_rn on the card and on the CPU give the same bits on
    prof_sweep.fma_cases, and the fp32 product's kernel computes the same
    FMAs (prof_sweep.fma_dot_inputs, 64 cases a launch, each launch also
    bit-equal to dot_plain on the card).  Returns a summary."""
    import torch
    from pathtracer_tpu_torch.ops import sweep_micro as sm
    from pathtracer_tpu_torch.scripts import prof_sweep
    a, b, c = prof_sweep.fma_cases()
    want = sm.fma_rn(a, b, c)
    if not same_bits(sm.fma_rn(a.to(dev), b.to(dev), c.to(dev)).cpu(), want):
        raise AssertionError('fma_rn differs between the card and the CPU')
    once = (a.double() * b.double() + c.double()).float()
    n = -(-a.numel() // 64) * 64
    pad = [torch.cat([v, v.new_zeros(n - v.numel())]).to(dev)
           for v in (a, b, c)]
    diag = []
    for j in range(0, n, 64):
        x, w = prof_sweep.fma_dot_inputs(*(v[j:j + 64] for v in pad))
        out_k = sm.dot_fp32(x, w, 1, -1.0, 64)
        if not same_bits(out_k, sm.dot_plain(x, w, 1, -1.0, 64)):
            raise AssertionError('fp32 product on fma_dot_inputs differs '
                                 'from dot_plain')
        diag.append(out_k[0].diagonal())
    got = torch.cat(diag)[:a.numel()].cpu()
    if not same_bits(got, want + 0.0):
        raise AssertionError('the fp32 product\'s FMA differs from fma_rn')
    return dict(cases=a.numel(), launches=n // 64,
                float64_once_wrong=int((once.view(torch.int32)
                                        != want.view(torch.int32)).sum()),
                subnormal=int(((want != 0) & (want.abs() < 2.0 ** -126))
                              .sum()),
                inf=int(want.isinf().sum()))


def occupancy(info):
    """(registers, resident blocks per SM, threads per block) as a dict
    with the resident warps per SM."""
    regs, blocks, threads = info
    return dict(registers=regs, blocks_per_sm=blocks,
                warps_per_sm=blocks * threads // 32)


def sass(lib, key, marker='MUFU.RCP'):
    """sass_loop without the loop's text."""
    out = sass_loop(lib, key, marker)
    del out['text']
    return out


def probe_phase(dev):
    """The sweep's cost probes: the entry points at their full shapes,
    then every probe kernel against its plain version.  Returns the
    kernels' records."""
    import torch
    from pathtracer_tpu_torch.ops import cluster as cl
    from pathtracer_tpu_torch.ops import sweep_ablate as sa
    from pathtracer_tpu_torch.ops import binding
    from pathtracer_tpu_torch.ops import sweep_micro as sm
    from pathtracer_tpu_torch.scripts import ablate_sweep, prof_sweep, \
        proto_mxu, time_us
    prof, n_prof = drive(lambda: prof_sweep.run(dev, log=log),
                         ('dot_fp32', 'dot_tf32', 'epilogue', 'edgemat'))
    mxu, n_mxu = drive(lambda: proto_mxu.run(dev, log=log),
                       ('dot_fp32', 'dot_tf32'))
    w = ablate_sweep.workload(dev, log=log)
    log(f'{w.ids.shape[0]} packets, {w.slots} slots swept')
    abl, n_abl = drive(lambda: ablate_sweep.run(w, log=log),
                       ('sweep_ablate',))
    log(f'probe launches: prof_sweep {n_prof}, proto_mxu {n_mxu}, '
        f'ablate_sweep {n_abl}')
    recs = []
    src = 'pathtracer_tpu_torch/csrc/sweep_micro.cu'

    # ---- the products, at both scripts' shapes ----
    x = prof_sweep.inputs(dev)
    shapes = (
        ('prof_sweep', prof, n_prof, (x['r'], x['a']), prof_sweep.REPS,
         prof_sweep.EPS, prof_sweep.OUT_COLS,
         {'tf32': 'scripts/tpu_prof_sweep.py:45',
          'fp32': 'scripts/tpu_prof_sweep.py:45'}),
        ('proto_mxu', mxu, n_mxu, proto_mxu.inputs(dev), proto_mxu.REPS,
         proto_mxu.EPS, proto_mxu.NS,
         {'tf32': 'scripts/tpu_proto_mxu.py:24',
          'fp32': 'scripts/tpu_proto_mxu.py:34'}))
    lib = binding.build('sweep_micro')
    one = torch.zeros(1, device=dev)
    floor_us = time_us(lambda: one.add_(1.0), 200, dev)
    log(f'launch floor (one-element add, launches queued): {floor_us:.4f} us')
    for script, res, counts, (xx, ww), reps, eps, cols, replaces in shapes:
        m, n = xx.shape[0], ww.shape[1]
        for route in ('fp32', 'tf32'):
            kern = sm.dot_tf32 if route == 'tf32' else sm.dot_fp32
            err, ratio = check_dot(kern, route == 'tf32', xx, ww, reps, eps,
                                   cols)
            ms_p = cuda_ms(lambda: sm.dot_plain(xx, ww, reps, eps, cols,
                                                route == 'tf32'), reps=1)
            ms = res[route] * reps / 1e3
            ops = (reps * 2 * m * 8 * n if route == 'tf32' else
                   reps * (DOT_OUT_OPS * m * n + DOT_ROW_OPS * m))
            rec = entry(
                f'dot_{route}[{script}]', src, replaces[route], err, 1.0,
                ms, ms_p, ops,
                4 * (m * 8 + 8 * n + m * cols + m * n // 2),
                peak=tf32_rate() if route == 'tf32' else None,
                us_per_rep=res[route], reps=reps, shape=f'({m}x8)x(8x{n})',
                err_over_bound=ratio,
                one_product_ms=res[f'torch.matmul {route}'] / 1e3,
                tflops=reps * 2 * m * 8 * n / ms / 1e9)
            rec['launches'] = counts[f'dot_{route}']
            rec['library_ms'] = res[f'library {route}'] / 1e3
            # a launch of 0 reps prices what the rep loop does not
            fixed_us = time_us(lambda: kern(xx, ww, 0, eps, cols), 50, dev)
            if route == 'tf32':
                # one HGMMA (wgmma) a rep: the loop's instructions per rep;
                # the launch at every tile width that divides N, alternated
                tile = sm.dot_tile(n)
                widths = [t for t in sm.DOT_TILES if n % t == 0]
                tile_us = {t: [] for t in widths}
                for _ in range(3):
                    for t in widths:
                        tile_us[t].append(time_us(lambda t=t: kern(
                            xx, ww, reps, eps, cols, t), 50, dev))
                rec['counters'] = dict(
                    occupancy(sm.kernel_info()[f'dot_tf32_{tile}']),
                    tile=tile, tiles=-(-m // sm.WG_ROWS) * (n // tile),
                    tile_us=tile_us,
                    sass=sass(lib, f'dot_tf32_kernelILi{tile}E', 'HGMMA'),
                    launch_floor_us=floor_us, zero_reps_us=fixed_us,
                    loop_us_per_rep=(ms * 1e3 - fixed_us) / reps)
            else:
                # one I2F ((float)i, the rep's shift) a rep and thread: the
                # loop's instructions per rep, over a thread's outputs
                loop = sass(lib, 'dot_fp32_kernel', 'I2F')
                rec['counters'] = dict(
                    occupancy(sm.kernel_info()['dot_fp32']),
                    tile=sm.FP32_TILE, sass=loop,
                    sass_per_output=loop['per_marker'] / (
                        sm.FP32_TILE[0] * sm.FP32_TILE[1]),
                    launch_floor_us=floor_us, zero_reps_us=fixed_us,
                    loop_us_per_rep=(ms * 1e3 - fixed_us) / reps)
            recs.append(rec)
            log(f'dot_{route} at {script} shape: {res[route]:.4f} us/rep '
                f'({ms * 1e3:.2f} us per launch, {rec["tflops"]:.1f} '
                f'TFLOP/s), bound {rec["bound_ms"] * 1e3 / reps:.4f} us/rep '
                f'({rec["share"]:.3f} of it); one torch.matmul of the same '
                f'sum {rec["library_ms"] * 1e3:.2f} us, of one product '
                f'{res["torch.matmul " + route]:.3f} us; plain {ms_p:.3f} ms '
                f'per launch; max |diff| {err:.3g} ({ratio:.3g} of the '
                f'bound); counters {rec["counters"]}')
    fma = check_fma(dev)
    log(f'fma_rn: card and CPU bit-equal on {fma["cases"]} cases ('
        f'{fma["float64_once_wrong"]} of them wrong when the float64 sum is '
        f'rounded straight to fp32, {fma["subnormal"]} subnormal, '
        f'{fma["inf"]} infinite); the fp32 kernel\'s FMA equal to them in '
        f'{fma["launches"]} launches, each bit-equal to dot_plain')
    narrow = x['a'][:, :prof_sweep.NS // 4].contiguous()
    t_narrow = time_us(lambda: sm.dot_fp32(x['r'], narrow, prof_sweep.REPS,
                                           prof_sweep.EPS, 128), 20, dev)
    scale = prof['fp32'] * prof_sweep.REPS / t_narrow
    log(f'fp32 product time, N = {prof_sweep.NS} over N = '
        f'{prof_sweep.NS // 4}: {scale:.3f}')
    if scale < 2.0:
        raise AssertionError('the fp32 product does not grow with N: the '
                             'kernel may skip columns')

    # ---- epilogue and edge-matrix test ----
    reps, eps = prof_sweep.REPS, prof_sweep.EPS
    m, s = prof_sweep.BLOCK, prof_sweep.SUBT
    zp, ztn = prof_sweep.signed_zero_inputs(dev, m, 7)
    z_k = sm.epilogue(zp, ztn, 7, eps)
    z_p = sm.epilogue_plain(zp, ztn, 7, eps)
    z_cpu = sm.epilogue_plain(zp.cpu(), ztn.cpu(), 7, eps)
    if not (same_bits(z_k, z_p) and same_bits(z_p.cpu(), z_cpu)):
        raise AssertionError('epilogue with tn < 0 and t = -0.0 and +0.0 '
                             'accepted: kernel, plain version on the card '
                             'and on the CPU differ')
    log(f'epilogue, signed zeros (tn < 0, {m} rays): kernel, plain version '
        f'on the card and on the CPU bit-equal; first rays\' t sign bits '
        f'{torch.signbit(z_k[0][:4]).tolist()}, tri {z_k[1][:4].tolist()}')
    for name, fn, plain, args, ops, nbytes, line in (
            ('epilogue', sm.epilogue, sm.epilogue_plain, (x['p'], x['tn']),
             reps * m * s * EPI_PAIR_OPS, 4 * (m * 6 * s + m + 2 * m), 57),
            ('edgemat', sm.edgemat, sm.edgemat_plain,
             (x['ov'], x['dv'], x['tr']),
             reps * (m * s * EDGE_PAIR_OPS + 12 * s),
             4 * (6 * m + 12 * s + m), 89)):
        out_k, out_p = fn(*args, reps, eps), plain(*args, reps, eps)
        if not same_bits(out_k, out_p):
            raise AssertionError(f'{name} differs from its plain version')
        ms_p = cuda_ms(lambda: plain(*args, reps, eps), reps=1)
        rec = entry(name, src, f'scripts/tpu_prof_sweep.py:{line}', 0.0, 1.0,
                    prof[name] * reps / 1e3, ms_p, ops, nbytes,
                    us_per_rep=prof[name], reps=reps,
                    hit_share=float((out_k[0] < BIG_T).float().mean()))
        rec['launches'] = n_prof[name]
        rec['counters'] = dict(occupancy(sm.kernel_info()[name]), sass=sass(
            lib, f'{name}_kernel'))
        recs.append(rec)
        log(f'{name}: {prof[name]:.3f} us/rep, bound '
            f'{rec["bound_ms"] * 1e3 / reps:.4f} us/rep '
            f'({rec["share"]:.3f} of it), plain {ms_p:.3f} ms per launch; '
            f'equal to its plain version; counters {rec["counters"]}')

    # ---- the ablation ----
    args = w.args()
    nb = w.ids.shape[0]
    variants = {}
    for v in sa.VARIANTS:
        out_p = sa.sweep_ablate_plain(*args, v)
        if not same_bits(sa.sweep_ablate(*args, v), out_p):
            raise AssertionError(f'ablation {v} differs from its plain '
                                 f'version')
        variants[v] = dict(ms=abl[v], equal=True)
        if v == 'full':
            ref = out_p
    ms_by_group = {}
    for g in cl.GROUPS:
        if not same_bits(sa.sweep_ablate(*args, 'full', group=g), ref):
            raise AssertionError(f'ablation full at G={g} differs from its '
                                 f'plain version')
        ms_by_group[g] = time_us(lambda g=g: sa.sweep_ablate(
            *args, 'full', group=g), 4, dev) / 1e3
    log('ablation full by lane group (ms): ' + ', '.join(
        f'G={g} {ms:.3f} ({sa.kernel_info(g)["full"][1] * g // 32} warps '
        f'per SM)' for g, ms in ms_by_group.items()))
    g = cl.SWEEP_GROUP
    st = torch.zeros((nb * (cl.BLOCK // g), sa.STATS), dtype=torch.int64,
                     device=dev)
    full = sa.sweep_ablate(*args, 'full', stats=st)
    counters = dict(occupancy(sa.kernel_info()['full']), sass=sass(
        binding.build('sweep_ablate'), f'ablate_kernelILi0ELi{g}E'),
        **cycle_summary(st[:, 1], st[:, 0]))
    log(f'ablation full counters (per G={g} group; work = subtiles swept): '
        f'{counters}')
    t_s, tri_s = cl.cluster_sweep(
        w.cm, w.ids, w.counts, torch.zeros(w.ids.shape, device=dev), w.org,
        w.dirn, w.tmax, w.tmin)
    frac, err = check_hits(t_s, tri_s, full[0], full[1])
    keys0 = torch.zeros(w.ids.shape, device=dev)
    ms_sweep = time_us(lambda: cl.cluster_sweep(
        w.cm, w.ids, w.counts, keys0, w.org, w.dirn, w.tmax, w.tmin), 4,
        dev) / 1e3
    st = torch.zeros((nb * (cl.BLOCK // cl.SWEEP_GROUP), cl.STATS),
                     dtype=torch.int64, device=dev)
    cl.cluster_sweep(w.cm, w.ids, w.counts, keys0, w.org, w.dirn, w.tmax,
                     w.tmin, stats=st)
    swept = int(st[:, 3].sum())
    ms_p = cuda_ms(lambda: sa.sweep_ablate_plain(*args, 'full'), reps=1,
                   warm=False)
    live = torch.arange(cl.MAXC, device=dev)[None] < w.counts
    distinct = int(torch.unique(w.ids[live].clamp_min(0)).numel())
    pairs = w.slots * w.cm.n_sub * cl.BLOCK * cl.SUBT
    rec = entry(
        'sweep_ablate', 'pathtracer_tpu_torch/csrc/sweep_ablate.cu',
        'scripts/tpu_ablate_sweep.py:67', 0.0,
        sum(v['equal'] for v in variants.values()) / len(variants),
        abl['full'], ms_p, pairs * SWEEP_PAIR_OPS,
        nb * cl.BLOCK * (32 + 16) + nb * (4 * cl.MAXC + 4)
        + distinct * w.cm.n_sub * cl.PLANE_ROWS * cl.SUBT * 4,
        variants=variants, packets=nb, slots=w.slots,
        full_vs_cluster_sweep=frac, cluster_sweep_ms=ms_sweep,
        cluster_sweep_rows=swept * cl.SWEEP_GROUP, counters=counters,
        ms_by_group=ms_by_group,
        ps_per_pair=abl['full'] * 1e9 / pairs,
        cluster_sweep_ps_per_pair=ms_sweep * 1e9 / max(
            swept * cl.SWEEP_GROUP * cl.SUBT, 1))
    rec['launches'] = n_abl['sweep_ablate']
    recs.append(rec)
    log(f'ablation: {nb} packets, {w.slots} slots, {distinct} distinct '
        f'clusters; every variant equal to its plain version: '
        f'{all(v["equal"] for v in variants.values())}; full vs '
        f'cluster_sweep tri agreement {frac:.6f} (max |dt| {err:.3g}); '
        f'full {abl["full"]:.3f} ms (bound {rec["bound_ms"]:.4f} ms, '
        f'{rec["share"]:.3f} of it; {rec["ps_per_pair"]:.3f} ps per pair '
        f'against cluster_sweep\'s {rec["cluster_sweep_ps_per_pair"]:.3f} '
        f'on the same inputs), plain '
        f'{ms_p:.3f} ms, {abl["full"] * 1e3 / (w.slots * w.cm.n_sub):.3f} us '
        f'per swept subtile; the production cluster_sweep on the same inputs '
        f'{ms_sweep:.3f} ms for the {swept} G={cl.SWEEP_GROUP} lane-group '
        f'subtiles its slab tests keep, '
        f'{ms_sweep * 1e3 * cl.BLOCK / max(swept * cl.SWEEP_GROUP, 1):.3f} '
        f'us per 512 lane x subtile rows')
    split = {v: abl['full'] - abl[v] for v in sa.VARIANTS if v != 'full'}
    log('ablation, full minus variant (ms): '
        + ', '.join(f'{k} {d:.3f}' for k, d in split.items()))
    return recs


# ---------------------------------------------------------------------------
# Materials phase: scene M (textured 1080p, atlas, alpha cut-outs, env map)
# and scene C4 (configs/config4_merl_dof.json, MERL + DoF)
# ---------------------------------------------------------------------------

MAT_SEED = 0
MAT_GROUPS = 8          # latitude bands of the main mesh, each textured
MAT_WAVES = 1           # timed 1080p waves of scene M, after a warm-up (5
                        # before the fluid phase, 3 before the time
                        # limit's cuts, 2 before the training phase)
GRAD_W, GRAD_H = 480, 270   # scene M's gradient check
C4_GRAD = 128           # C4's gradient check, square, 4 spp
C4_FRAMES = 1           # timed C4 frames, after a warm-up (3 before the
                        # time limit's cuts)
ANNOTATED = ('cull', 'texture')


def stripes(tex):
    """A tex x tex alpha map whose red channel cuts away every other band
    of tex // 32 columns (half of its texels)."""
    a = np.zeros((tex, tex, 3), np.float32)
    band = max(tex // 32, 1)
    a[:, (np.arange(tex) // band) % 2 == 0] = 1.0
    return a


def normal_map(rng, tex):
    """A tangent-space normal map: unit vectors tilted about +z."""
    n = np.concatenate([rng.normal(0.0, 0.3, (tex, tex, 2)),
                        np.ones((tex, tex, 1))], -1)
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


def material_objects(lat=1100, cut_lat=400, tex=1024, env=(1024, 2048),
                     seed=MAT_SEED):
    """Scene M's objects and env map, from `seed`: the bench's displaced
    sphere (sphere_mesh(lat, lat, radius=14, displace_amp=0.25)) in
    MAT_GROUPS latitude bands, each with a tex x tex kd map and normal map
    (tangents from setup_tangents; opaque, so its shadows take the any-hit
    sweep), and in front of it sphere_mesh(cut_lat, cut_lat, radius=6)
    with a striped tex x tex alpha map, 4 cut-out rounds; the env map is
    env[0] x env[1]."""
    from pathtracer_tpu_torch.io import obj as obj_io
    from pathtracer_tpu_torch.scene import scene as scn
    from pathtracer_tpu_torch.utils import procgen
    rng = np.random.default_rng(seed)
    md = procgen.sphere_mesh(lat, lat, radius=14.0, displace_amp=0.25)
    cy = md.vertices[md.vtx_idx][:, :, 1].mean(1)
    md.group = np.clip(((1.0 - cy / 14.0) * 0.5 * MAT_GROUPS)
                       .astype(np.int32), 0, MAT_GROUPS - 1)
    md.materials = [obj_io.GroupMaterial(kd=np.asarray(
        [0.5 + 0.05 * g, 0.6, 0.9 - 0.05 * g], np.float32))
        for g in range(MAT_GROUPS)]
    md.group_names = {f'band{g}': g for g in range(MAT_GROUPS)}
    obj_io.setup_tangents(md)
    textures = [{'kd': (0.15 + 0.75 * rng.random((tex, tex, 3),
                                                 dtype=np.float32)),
                 'normal': normal_map(rng, tex)} for _ in range(MAT_GROUPS)]
    cut = procgen.sphere_mesh(cut_lat, cut_lat, radius=6.0, seed=1)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(md, translation=(0.0, -15.0, 0.0),
                                textures=textures))
    objs.append(scn.mesh_object(cut, translation=(-14.0, -5.0, 10.0),
                                textures={'alpha': stripes(tex)},
                                cutout_rounds=4))
    envmap = rng.uniform(0.05, 3.0, tuple(env) + (3,)).astype(np.float32)
    return objs, envmap


def material_scene(dev, **sizes):
    from pathtracer_tpu_torch.scene import scene as scn
    objs, env = material_objects(**sizes)
    return scn.build_scene(objs, scn.default_light_intensity(), envmap=env,
                           merge_meshes=False, device=dev)


@contextlib.contextmanager
def annotated():
    """Label the cluster culls, the texture and env-map lookups, the
    subsurface reservoir march, the fog event and the point-set sweeps
    with torch.profiler.record_function ranges ('cull', 'texture',
    'march', 'fog'; 'pcull' the particle cull, 'pslots' the particle slot
    sweeps, 'preroute' their overflow reroute, 'pbrute' the brute point
    and yarn sweeps), by wrapping the module functions the scene and the
    integrator call; restored on exit."""
    import torch
    from pathtracer_tpu_torch.models import texture as tex
    from pathtracer_tpu_torch.ops import cluster as cl
    from pathtracer_tpu_torch.render import integrator as integ
    from pathtracer_tpu_torch.scene import pointset as tps
    from pathtracer_tpu_torch.scene import scene as scn
    from pathtracer_tpu_torch.scene import yarns as tya
    saved = []

    def wrap(mod, name, label):
        f = getattr(mod, name)
        saved.append((mod, name, f))

        @functools.wraps(f)
        def g(*a, **k):
            with torch.profiler.record_function(label):
                return f(*a, **k)

        setattr(mod, name, g)

    wrap(cl, '_cull', 'cull')
    for name in ('sample_point', 'sample_bilinear', 'sample_atlas'):
        wrap(tex, name, 'texture')
    wrap(scn, '_envmap_ke', 'texture')
    wrap(scn, '_mesh_reservoir_march', 'march')
    wrap(integ, '_fog_event', 'fog')
    wrap(tps, '_cull_spheres', 'pcull')
    for name in ('_entry_slots', '_union_slots'):
        wrap(tps, name, 'pslots')
    for name in ('_reroute_entry', '_reroute_union'):
        wrap(tps, name, 'preroute')
    for name in ('sphere_sweep', 'sphere_union_exit', 'disk_sweep'):
        wrap(tps, name, 'pbrute')
    wrap(tya, 'cylinder_sweep', 'pbrute')
    try:
        yield
    finally:
        for mod, name, f in reversed(saved):
            setattr(mod, name, f)


def profile_split(r, labels=ANNOTATED):
    """One Renderer wave under torch.profiler, its device time split into
    the two sweeps (kernel names), the annotated ranges in `labels` order
    (a kernel whose launching op started inside a range counts for the
    first such label) and the rest of the kernels; and, per label, the
    device time of every kernel launched from inside its range (the
    sweeps, launched outside torch's ops, not included).  ms.  Reads the
    raw Kineto events: building torch's FunctionEvent tree for the wave's
    million events takes minutes; a kernel's linked correlation id names
    the op that launched it, as in torch's own parsing.  With no labels
    only the device is traced, which spares recording every CPU op.
    Returns (split, busy, kernels, inclusive)."""
    import bisect
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if labels else []
    t0 = time.perf_counter()
    with annotated(), profile(activities=acts + [ProfilerActivity.CUDA]) \
            as prof:
        r.step()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu, dev_t = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = {k: [] for k in labels}
    op_start, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        name, kind = e.name(), e.device_type()
        if kind == cpu and e.linked_correlation_id() == 0:
            if name in ranges:
                ranges[name].append((e.start_ns(), e.end_ns()))
            else:
                op_start[e.correlation_id()] = e.start_ns()
        elif kind == dev_t and name not in ranges:
            kernels.append((e.linked_correlation_id(), name, e.duration_ns()))
    for v in ranges.values():
        v.sort()

    def inside(label, t):
        rs = ranges[label]
        i = bisect.bisect_right(rs, (t, float('inf'))) - 1
        return i >= 0 and rs[i][0] <= t <= rs[i][1]

    split = dict(sweep_closest=0.0, sweep_any=0.0, **{k: 0.0 for k in labels})
    inclusive = {k: 0.0 for k in labels}
    busy = 0.0
    for corr, name, ns in kernels:
        busy += ns
        if corr in op_start:
            for label in labels:
                if inside(label, op_start[corr]):
                    inclusive[label] += ns
        if 'sweep_kernel<false' in name:
            split['sweep_closest'] += ns
        elif 'sweep_kernel<true' in name:
            split['sweep_any'] += ns
        elif corr in op_start:
            for label in labels:
                if inside(label, op_start[corr]):
                    split[label] += ns
                    break
    if busy == 0.0:
        raise AssertionError('torch.profiler recorded no device time')
    log(f'  profiled wave recorded in {t1 - t0:.1f} s, read in '
        f'{time.perf_counter() - t1:.1f} s')
    split = {k: v / 1e6 for k, v in split.items()}
    split['rest'] = busy / 1e6 - sum(split.values())
    return (split, busy / 1e6, len(kernels),
            {k: v / 1e6 for k, v in inclusive.items()})


def record_sweeps(name='cluster_sweep'):
    """Replace cluster.<name> (cluster_sweep or cluster_sweep_any) by a
    recorder: each call's positional inputs and its outputs, cloned (the
    windowed rounds update a round's t and tri in place), land in the
    returned list as (inputs, outputs) with outputs a tuple; `restore`
    undoes it."""
    from pathtracer_tpu_torch.ops import cluster as cl
    orig = getattr(cl, name)
    calls = []

    def rec(cm, *args, **kw):
        out = orig(cm, *args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        calls.append(((cm,) + tuple(x.clone() for x in args),
                      tuple(x.clone() for x in outs)))
        return out

    setattr(cl, name, rec)

    def restore():
        setattr(cl, name, orig)

    return calls, restore


def cutout_sweep_check(sc, cam, dev, rays=None):
    """The closest-hit sweep inside the cut-out rounds of the cut-out
    mesh, on scene M's 1080p primaries (or `rays`, (org, dirn)): every
    launch bit-equal to
    cluster_sweep_plain on the same inputs, the rising per-lane strict
    floor included.  On the floor lanes (floor set at a cut texel's hit)
    the kernel returns t > floor or a miss; with each floor lowered by one
    ulp it finds the excluded triangle again at t == floor, on the card
    and in the plain version alike."""
    import torch
    from pathtracer_tpu_torch.ops import cluster as cl
    from pathtracer_tpu_torch.scene import scene as scn
    mesh = sc.meshes[1]
    org, dirn = primary_rays(cam, dev) if rays is None else rays
    org_l, dir_l = scn._local_ray_row(sc, mesh.obj_row, org, dirn)
    calls, restore = record_sweeps()
    scn.CUTOUT_LOG = []
    try:
        t, tri, _ = scn._mesh_closest_hit(mesh, org_l, dir_l,
                                          torch.full_like(org[:, 0], BIG_T))
    finally:
        restore()
        log_rounds, scn.CUTOUT_LOG = scn.CUTOUT_LOG, None
    floor_lanes = again = 0
    for (cm, ids, counts, keys, o, d, tx, tn), (t_k, tri_k) in calls:
        t_p, tri_p = cl.cluster_sweep_plain(cm, ids, counts, keys, o, d, tx,
                                            tn)
        if not same_bits((t_k, tri_k), (t_p, tri_p)):
            raise AssertionError('cut-out round sweep differs from '
                                 'cluster_sweep_plain')
        fl = tn > 0.0
        if not bool(fl.any()):
            continue
        floor_lanes += int(fl.sum())
        if bool(((tri_k[fl] >= 0) & ~(t_k[fl] > tn[fl])).any()):
            raise AssertionError('a hit at or below the strict floor')
        low = torch.where(fl, torch.nextafter(tn, torch.full_like(tn, -1.0)),
                          tn)
        t_l, tri_l = cl.cluster_sweep(cm, ids, counts, keys, o, d, tx, low)
        if not same_bits((t_l, tri_l), cl.cluster_sweep_plain(
                cm, ids, counts, keys, o, d, tx, low)):
            raise AssertionError('lowered-floor sweep differs from plain')
        again += int((fl & (t_l == tn)).sum())
    rounds = [e['lanes'] for e in log_rounds]
    log(f'cut-out sweep check (1080p primaries, cut-out mesh): '
        f'{len(calls)} closest-hit launches bit-equal to '
        f'cluster_sweep_plain; rounds (lanes entering each) {rounds}; '
        f'{floor_lanes} floor lanes, every hit above its floor; with the '
        f'floors one ulp lower {again} of them hit exactly at the floor '
        f'again; hits {int((tri >= 0).sum())}')
    if floor_lanes == 0 or again == 0:
        raise AssertionError('the cut-out rounds raised no floor')
    return dict(launches=len(calls), rounds=rounds,
                floor_lanes=floor_lanes, hit_at_floor_again=again,
                t=t, tri=tri)


def card_vs_cpu(sc, name):
    """`sc` at 64x48, 1 spp, 3 bounces, compaction: through the kernels on
    the card against the plain versions on the CPU, per sample (the
    reference's allowance: < 5% flipped at 1e-3, mean within 2%).
    Returns the flipped share."""
    import torch
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.core import rng_host
    from pathtracer_tpu_torch.render import renderer as rnd
    w, h = 64, 48
    cfg = rnd.RenderConfig(width=w, height=h, nrays=1, nb_bounces=BOUNCES,
                           compact_rays=True)
    cp = rng_host.random_per_pixel_fast(w, h)
    out = {}
    t0 = time.perf_counter()
    for dev, s in (('cuda', sc), ('cpu', sc.to('cpu'))):
        cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0)).to(dev)
        out[dev] = rnd.render_unsplatted(
            s, cam, torch.as_tensor(cp, device=dev), cfg)[1].cpu().numpy()
    if not np.isfinite(out['cuda']).all():
        raise AssertionError('non-finite samples on the card')
    scale = max(np.abs(out['cpu']).max(), 1e-6)
    rel = np.abs(out['cuda'] - out['cpu']).max(-1) / scale
    flipped = rel > 1e-3
    mean_rel = abs(out['cuda'].mean() - out['cpu'].mean()) / scale
    log(f'{name} 64x48x1spp vs CPU plain path: flipped {flipped.mean():.5f}'
        f', unflipped max rel {rel[~flipped].max():.3g}, mean rel '
        f'{mean_rel:.3g} ({time.perf_counter() - t0:.1f} s)')
    if flipped.mean() >= 0.05 or rel[~flipped].max() >= 1e-3 \
            or mean_rel >= 0.02:
        raise AssertionError(f'{name} on the card disagrees with the CPU')
    return float(flipped.mean())


def material_main(sc, cam, card, profile):
    """Scene M's Renderer at 1920x1080, 1 sample per wave, 3 bounces,
    compaction: one warm-up wave, then MAT_WAVES waves timed one by one (the
    sweep launches counted over them),
    the cut-out rounds logged, then, if `profile`, one wave under
    torch.profiler."""
    import torch
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.scene import scene as scn
    cfg = pt.RenderConfig(width=W, height=H, nrays=16, nb_bounces=BOUNCES,
                          samples_per_wave=1, compact_rays=True)
    r = pt.Renderer(sc, cam, cfg)
    r.step()                                    # warm-up
    torch.cuda.synchronize()
    counted = launch_counts()
    scn.CUTOUT_LOG = []
    rays0, ms = r.rays_traced, []
    try:
        for _ in range(MAT_WAVES):
            ms.append(timed(r.step)[1])
    finally:
        log_rounds, scn.CUTOUT_LOG = scn.CUTOUT_LOG, None
    launches = launches_since(counted, RENDER_KERNELS)
    live = r.rays_traced - rays0
    split = busy = n_kern = profile_s = None
    if profile:
        t0 = time.perf_counter()
        split, busy, n_kern, _ = profile_split(r)
        profile_s = time.perf_counter() - t0
    img = r.display().cpu().numpy()
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError('scene M image not finite / wrong shape')
    region = img[int(H * 0.55):int(H * 0.9), int(W * 0.4):int(W * 0.6)]
    if not region.std() > 0.05 or not region.mean() > 0.02:
        raise AssertionError(f'scene M mesh region not lit: mean '
                             f'{region.mean():.4f} std {region.std():.4f}')
    for name in ('cluster_sweep_closest', 'cluster_sweep_any',
                 'pcg_draw'):
        if launches[name] <= 0:
            raise AssertionError(f'{name} never launched on scene M')
    queries = len(log_rounds) / MAT_WAVES
    per_round = collections.defaultdict(list)
    for e in log_rounds:
        for i, lanes in enumerate(e['lanes']):
            per_round[i].append(lanes)
    rounds = {f'round {i + 1}': dict(queries=len(v), lanes_mean=float(
        np.mean(v)), lanes_max=int(max(v))) for i, v in per_round.items()}
    left = int(sum(e['left'] for e in log_rounds))
    rep = dict(ms_per_wave=spread(ms),
               live_rays_per_s=live / (sum(ms) / 1e3),
               sweep_launches_per_wave={k: v / MAT_WAVES for k, v in
                                        launches.items()},
               cutout_queries_per_wave=queries, cutout_rounds=rounds,
               cutout_lanes_left=left, profiled_split_ms=split,
               profiled_busy_ms=busy, profiled_kernels=n_kern,
               profile_seconds=profile_s, image_mean=float(img.mean()))
    log(f'scene M 1080p, 2.4M + 320k tris, 8 textured groups (atlas), '
        f'env map, 3 bounces, compaction ({card}): ms per wave median '
        f'{rep["ms_per_wave"]["median"]:.1f} (min {min(ms):.1f}, max '
        f'{max(ms):.1f}; {", ".join(f"{x:.1f}" for x in ms)}); '
        f'{rep["live_rays_per_s"]:.4g} live rays/s; sweep launches per wave '
        f'{rep["sweep_launches_per_wave"]}')
    log(f'  cut-out queries per wave {queries:.1f}; per round: '
        + '; '.join(f'{k}: {v["queries"]} queries, lanes mean '
                    f'{v["lanes_mean"]:.0f}, max {v["lanes_max"]}'
                    for k, v in rounds.items())
        + f'; lanes still cut out after the last round {left}')
    if profile:
        log(f'  profiled wave (torch.profiler, device time): '
            + ', '.join(f'{k} {v:.1f} ms' for k, v in split.items())
            + f'; all {n_kern} kernels {busy:.1f} ms (profiled and read in '
            f'{profile_s:.1f} s)')
    return launches, rep


def fd_check(loss_of, base, name, idx, step, rtol, grads):
    """Central difference of loss_of at base[name][idx] +- step against
    the autograd gradient grads[name][idx], within rtol of the autograd
    value."""
    import torch
    delta = torch.zeros_like(base[name])
    delta[idx] = step
    with torch.no_grad():
        lp = float(loss_of({**base, name: base[name] + delta}))
        lm = float(loss_of({**base, name: base[name] - delta}))
    want, got = (lp - lm) / (2 * step), float(grads[name][idx])
    rel = abs(got - want) / max(abs(want), 1e-30)
    log(f'  central difference {name}{list(idx)} (step {step:.3g}): '
        f'{want:.6g}, autograd {got:.6g} (relative difference {rel:.3g}, '
        f'tolerance {rtol})')
    if not (want != 0.0 and np.isclose(want, got, rtol=rtol, atol=0.0)):
        raise AssertionError(f'{name}: autograd {got:.6g} against a '
                             f'central difference {want:.6g}')
    return dict(fd=want, autograd=got, rel=rel, rtol=rtol)


def largest(g):
    """Index (tuple) of the entry of largest |g|."""
    import torch
    return tuple(int(i) for i in torch.unravel_index(g.abs().argmax(),
                                                     g.shape))


def texture_grads(sc, cam, card):
    """Scene M at GRAD_W x GRAD_H, 2 spp: the gradient of the float64 mean
    image with respect to group 0's kd map and the env map, autograd on
    the card, each checked at its largest-|grad| texel against a central
    difference (g_kd's tolerance, 5e-2; the image is linear in a kd
    texel to second order and in an env texel)."""
    import torch
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.core import rng_host
    from pathtracer_tpu_torch.render import renderer as rnd
    cfg = pt.RenderConfig(width=GRAD_W, height=GRAD_H, nrays=2,
                          nb_bounces=BOUNCES, compact_rays=True)
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(GRAD_W, GRAD_H),
                         device=sc.device)
    mesh = sc.meshes[0]
    kd_atlas = mesh.atlases[0]              # models.texture.CHANNELS[0]
    base = {'atlas_kd': kd_atlas.img, 'envmap': sc.envmap}

    def loss_of(leaves):
        atl = list(mesh.atlases)
        atl[0] = atl[0].replace(img=leaves['atlas_kd'])
        m = mesh.replace(atlases=tuple(atl))
        s = sc.replace(envmap=leaves['envmap'], meshes=(m,) + sc.meshes[1:])
        return rnd.render_unsplatted(s, cam, cp, cfg)[0].double().mean() \
            / RADIANCE

    leaves = {k: v.clone().requires_grad_() for k, v in base.items()}
    loss, ms = timed(lambda: loss_of(leaves))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    check_grads(grads, 'scene M')
    out = {}
    for name in base:
        idx = largest(grads[name])
        step = (5e-2 if name == 'atlas_kd' else 1e-2) * max(
            abs(float(base[name][idx])), 1.0)
        out[name] = dict(index=list(idx), nonzero=int(
            (grads[name] != 0).sum()), **fd_check(loss_of, base, name, idx,
                                                  step, 5e-2, grads))
    y0 = kd_atlas.y0.cpu().numpy()
    out['atlas_kd']['group'] = int(np.searchsorted(
        y0, out['atlas_kd']['index'][0], side='right') - 1)
    log(f'scene M gradients {GRAD_W}x{GRAD_H}x2spp ({card}): forward '
        f'{ms:.1f} ms; texels with a gradient: '
        + ', '.join(f'{k} {v["nonzero"]}' for k, v in out.items()))
    return out


def write_merl(path):
    """The synthetic full-size MERL table of tests/test_config_parity.py
    (90 x 90 x 180 x 3 float64)."""
    n = 90 * 90 * 180
    idx = np.arange(n, dtype=np.float64)
    data = np.stack([(np.sin(idx * 1e-3) + 1.2) * 55.0,
                     (np.cos(idx * 7e-4) + 1.3) * 42.0,
                     (np.sin(idx * 1.3e-3 + 1.0) + 1.1) * 61.0])
    with open(path, 'wb') as f:
        np.array([90, 90, 180], np.int32).tofile(f)
        data.tofile(f)


def c4_phase(dev, card):
    """configs/config4_merl_dof.json through the port's scene_json with
    the synthetic MERL table beside it in a temporary directory: 512 x 512
    x 64 spp, aperture 1.5, one warm-up and C4_FRAMES timed frames (CUDA
    events); then the gradient of a C4_GRAD^2 x 4 spp float64 mean image
    with respect to the MERL table, checked at its largest-|grad| entry
    against a central difference."""
    import shutil
    import tempfile
    import torch
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.core import rng_host
    from pathtracer_tpu_torch.io import scene_json
    from pathtracer_tpu_torch.render import renderer as rnd
    from pathtracer_tpu_torch.scene import scene as scn
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        shutil.copy(os.path.join(here, 'configs', 'config4_merl_dof.json'), d)
        write_merl(os.path.join(d, 'material.binary'))
        objs, li, cam, cfg, ex = scene_json.load_scene(
            os.path.join(d, 'config4_merl_dof.json'), device=dev)
    sc = scn.build_scene(objs, li, envmap_intensity=ex['envmap_intensity'],
                         fog=ex['fog'], device=dev)
    if len(sc.measured_brdfs) != 1 or float(cam.aperture) != 1.5:
        raise AssertionError('config 4 lost its MERL table or aperture')
    cfg = cfg._replace(samples_per_wave=8)

    def frame():
        r = pt.Renderer(sc, cam, cfg).render()
        return r

    t_load = time.perf_counter() - t0
    frame()
    runs = [timed(frame) for _ in range(C4_FRAMES)]
    img = runs[-1][0].display().cpu().numpy()
    if not np.isfinite(img).all() or not img.mean() > 0.01:
        raise AssertionError('config 4 image not finite / not lit')
    ms = [x for _, x in runs]
    log(f'C4 config4_merl_dof.json {cfg.width}x{cfg.height} x {cfg.nrays} '
        f'spp, aperture 1.5, MERL ({card}): ms per frame median '
        f'{np.median(ms):.1f} (min {min(ms):.1f}, max {max(ms):.1f}; '
        f'{", ".join(f"{x:.1f}" for x in ms)}); image mean {img.mean():.4f}; '
        f'load and build {t_load:.1f} s')

    gcfg = rnd.RenderConfig(width=C4_GRAD, height=C4_GRAD, nrays=4,
                            nb_bounces=cfg.nb_bounces)
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(C4_GRAD, C4_GRAD),
                         device=dev)
    camd = cam.to(dev)
    table = sc.measured_brdfs[0]
    base = {'merl': table.data}

    def loss_of(leaves):
        s = sc.replace(measured_brdfs=(table.replace(data=leaves['merl']),))
        return rnd.render_unsplatted(s, camd, cp, gcfg)[0].double().mean() \
            / RADIANCE

    leaf = base['merl'].clone().requires_grad_()
    grads = {'merl': torch.autograd.grad(loss_of({'merl': leaf}), [leaf])[0]}
    check_grads(grads, 'C4')
    idx = largest(grads['merl'])
    fd = fd_check(loss_of, base, 'merl', idx,
                  1e-2 * max(abs(float(base['merl'][idx])), 1.0), 5e-2,
                  grads)
    return dict(ms_per_frame=spread(ms), image_mean=float(img.mean()),
                merl_grad=dict(index=list(idx), nonzero=int(
                    (grads['merl'] != 0).sum()), **fd))


def materials_phase(dev, cam, card, profile=False):
    """Scene M: build, the cut-out sweep check, the card against the CPU,
    the 1080p waves (one profiled if `profile`), the texture gradients;
    then C4.  Returns the sweep launches of scene M's waves and the
    phase's numbers."""
    steps = {}
    t0 = time.perf_counter()

    def step(name):
        nonlocal t0
        steps[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    sc = material_scene(dev)
    step('build')
    m0, m1 = sc.meshes
    log(f'scene M build {steps["build"]:.1f} s: {m0.n_tris} + '
        f'{m1.n_tris} tris, {m0.n_clusters} + {m1.n_clusters} clusters, '
        f'atlas {bool(m0.atlases)}, alpha {m1.has_alpha}, backface cull '
        f'{m0.backface_cull} / {m1.backface_cull}, env map '
        f'{tuple(sc.envmap.shape)}')
    if not (m0.atlases and m1.has_alpha and not m0.has_alpha):
        raise AssertionError('scene M lost its atlas or its cut-outs')
    check = cutout_sweep_check(sc, cam, dev)
    del check['t'], check['tri']
    step('cutout_check')
    card_vs_cpu(sc, 'scene M')
    step('reference')
    launches, rep = material_main(sc, cam, card, profile)
    step('waves')
    grads = texture_grads(sc, cam, card)
    step('texture_grads')
    del sc
    c4 = c4_phase(dev, card)
    step('c4')
    log('materials phase steps (s): '
        + ', '.join(f'{k} {v:.1f}' for k, v in steps.items()))
    return launches, dict(scene_m=rep, cutout_check=check,
                          scene_m_grads=grads, c4=c4, seconds=steps)


# ---------------------------------------------------------------------------
# Media phase: scene O (config 5's fog and subsurface material on the main
# path's geometry) and the ghost + background flagship
# ---------------------------------------------------------------------------

MEDIA_WAVES = 1         # timed 1080p waves of scene O and of the ghost
                        # flagship, after a warm-up (3 before the fluid
                        # phase, 2 before the time limit's cuts)
MEDIA_REF_LAT = 200     # the card-vs-CPU check's sphere: 79,600 triangles,
                        # above MESH_RESERVOIR_MAX_TRIS, so its probes march
MEDIA_LABELS = ('cull', 'march', 'fog', 'texture')
MEDIA_GRAD_W, MEDIA_GRAD_H = 320, 180   # scene O's gradient check, 2 spp
MARCH_SIZE = (960, 540)  # the march sweep check's primaries; on an H100
                         # its time follows its launches, each held against
                         # its plain version: 44 s for 32 at 1080p, 25 s
                         # for 20 here, 42.8 s for 32 at 480x270


def config5():
    """configs/config5_office.json's fog block and mesh object."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, 'configs', 'config5_office.json')) as f:
        doc = json.load(f)
    mesh = next(o for o in doc['objects'] if o['type'] == 'mesh')
    return doc['fog'], mesh


def media_objects(lat=1100, env=(1024, 2048), seed=MAT_SEED):
    """Scene O's objects, env map and fog, from `seed`: config 5's slate
    (the default light, dome and ground plane), the bench's displaced
    sphere (sphere_mesh(lat, lat, radius=14, displace_amp=0.25)) at
    (0, -15, 0) with config 5's mesh material (kd 1, ks 0, ksub (0.5, 0.4,
    0.3)), config 5's fog block verbatim, an env[0] x env[1] env map."""
    from pathtracer_tpu_torch.scene import scene as scn
    from pathtracer_tpu_torch.utils import procgen
    fog, m = config5()
    rng = np.random.default_rng(seed)
    md = procgen.sphere_mesh(lat, lat, radius=14.0, displace_amp=0.25)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(
        md, translation=(0.0, -15.0, 0.0), kd=m['kd'], ks=m['ks'],
        ne=m['ne'], ksub=m['ksub'], refr_index=m['refr_index'],
        interp_normals=m['interp_normals']))
    envmap = rng.uniform(0.05, 3.0, tuple(env) + (3,)).astype(np.float32)
    return objs, envmap, fog


def media_scene(dev, **sizes):
    from pathtracer_tpu_torch.scene import scene as scn
    objs, env, fog = media_objects(**sizes)
    return scn.build_scene(objs, scn.default_light_intensity(), envmap=env,
                           fog=fog, device=dev)


def background_photo(h=H, w=W, seed=MAT_SEED):
    """An h x w photo as scene.load_background returns one: (u8 / 255)^2.2
    x 196964.699, the u8 values numpy noise over a vertical gradient."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(40.0, 220.0, h)[:, None, None]
    u8 = np.clip(ramp + rng.normal(0.0, 20.0, (h, w, 3)), 0, 255).round()
    return (np.power(u8 / 255.0, 2.2) * 196964.699).astype(np.float32)


def march_sweep_check(sc, cam, dev, size=MARCH_SIZE):
    """One reservoir march on scene O's bounce-1 subsurface probes (the
    primaries' hits at `size`, sample 0, drawn as the integrator draws
    them):
    every closest-hit sweep launch of its rounds bit-equal to
    cluster_sweep_plain on the same inputs, the rising per-lane strict
    floor and the backface cull off included; every hit above its floor."""
    import torch
    from pathtracer_tpu_torch.core import rng as prng
    from pathtracer_tpu_torch.core import vec
    from pathtracer_tpu_torch.ops import cluster as cl
    from pathtracer_tpu_torch.render import integrator as integ
    from pathtracer_tpu_torch.render import renderer as rnd
    from pathtracer_tpu_torch.scene import scene as scn
    w, h = size
    cfg = rnd.RenderConfig(width=w, height=h, nrays=1)
    pix_i, pix_j, _ = rnd._pixel_order(w, h, 32, dev)
    cp = torch.zeros((w * h, 2), device=dev)
    st, org, dirn, _, _, _ = rnd._camera_paths(cam, cfg, pix_i, pix_j, 0, cp)
    hit = scn.intersect(sc, org, dirn)
    # the subsurface entry of integrator._bounce at depth 0
    is_diffuse = hit.hit & (hit.obj_id >= 2) & ~hit.miroir & ~hit.transp
    can_ss = (is_diffuse & (vec.norm2(hit.ksub) > 1e-8)
              & sc.ss_obj_ok[hit.obj_id])
    u_ss, rng_st = prng.next_uniform(st, gate=can_ss)
    take_ss = can_ss & (u_ss < integ.SS_PROBA)
    calls, restore = record_sweeps()
    scn.MARCH_LOG = []
    try:
        out = integ._subsurface_event(sc, hit, hit.p, hit.n, take_ss, rng_st)
    finally:
        restore()
        log_m, scn.MARCH_LOG = scn.MARCH_LOG, None
    floor_lanes = 0
    for i, ((cm, ids, counts, keys, o, d, tx, tn), (t_k, tri_k)) in \
            enumerate(calls):
        t_p, tri_p = cl.cluster_sweep_plain(cm, ids, counts, keys, o, d, tx,
                                            tn)
        if not same_bits((t_k, tri_k), (t_p, tri_p)):
            bad = ((t_k.view(torch.int32) != t_p.view(torch.int32))
                   | (tri_k != tri_p)).nonzero()[:, 0]
            j = bad[:8]
            raise AssertionError(
                f'march launch {i}: {bad.numel()} of {t_k.numel()} lanes '
                f'differ from cluster_sweep_plain; first lanes '
                f'{j.tolist()}: t {t_k[j].tolist()} vs {t_p[j].tolist()}, '
                f'tri {tri_k[j].tolist()} vs {tri_p[j].tolist()}, tmin '
                f'{tn[j].tolist()}, tmax {tx[j].tolist()}, org '
                f'{o[j].tolist()}, dir {d[j].tolist()}')
        fl = tn > 0.0
        floor_lanes += int(fl.sum())
        if bool(((tri_k[fl] >= 0) & ~(t_k[fl] > tn[fl])).any()):
            raise AssertionError('a march hit at or below its floor')
    (m,) = log_m
    rep = dict(launches=len(calls), lanes_per_round=m['lanes'],
               exit_ok=out[0], exit_p=out[1],
               overflow_round_lanes=m['overflow_round'],
               overflow=m['overflow'], take_ss=int(take_ss.sum()),
               exits_found=int(out[0].sum()), floor_lanes=floor_lanes,
               backface_cull=sc.meshes[0].backface_cull)
    log(f'march sweep check ({w}x{h} primaries, bounce 1): {len(calls)} '
        f'closest-hit launches bit-equal to cluster_sweep_plain (backface '
        f'cull off, {floor_lanes} floor lanes, every hit above its floor); '
        f'lanes active entering each round {m["lanes"]}; {rep["take_ss"]} '
        f'probes taken, {rep["exits_found"]} exits found, overflow '
        f'{m["overflow"]}')
    if floor_lanes == 0 or len(m['lanes']) < 2 or rep['exits_found'] == 0:
        raise AssertionError('the march raised no floor or found no exit')
    if sc.meshes[0].backface_cull:
        raise AssertionError('scene O\'s ksub mesh kept its backface cull')
    return rep


@contextlib.contextmanager
def media_counters():
    """Count, per call of the reservoir march and of the fog event, the
    closest-hit sweep launches made inside it (and the lanes each fog
    event probed); restored on exit.  Yields the two lists."""
    from pathtracer_tpu_torch.render import integrator as integ
    from pathtracer_tpu_torch.scene import scene as scn
    march, fog = [], []
    orig_m, orig_f = scn._mesh_reservoir_march, integ._fog_event

    def counted(f, out, lanes):
        @functools.wraps(f)
        def g(*a, **k):
            n0 = launch_counts()
            res = f(*a, **k)
            n = launches_since(n0, ('cluster_sweep_closest',))
            out.append(dict(launches=n['cluster_sweep_closest'],
                            lanes=int(lanes(a))))
            return res
        return g

    scn._mesh_reservoir_march = counted(orig_m, march,
                                        lambda a: a[1].shape[0])
    integ._fog_event = counted(orig_f, fog, lambda a: a[1].shape[0])
    try:
        yield march, fog
    finally:
        scn._mesh_reservoir_march, integ._fog_event = orig_m, orig_f


RENDER_KERNELS = ('cluster_sweep_closest', 'cluster_sweep_any', 'hier_cull',
                  'pcg_draw')
PROBE_KERNELS = ('dot_fp32', 'dot_tf32', 'epilogue', 'edgemat',
                 'sweep_ablate')


def launch_counts():
    """Every hand-written kernel's launches so far by its kernel record's
    name: the recorder's counters `<counter>.launches` of the operators of
    ops/binding.py, which count each launch (the closest-hit sweep's
    record is cluster_sweep_closest, its counter cluster_sweep)."""
    from pathtracer_tpu_torch.ops import binding
    from pathtracer_tpu_torch.utils import profiling
    counters = profiling.counters()
    return {'cluster_sweep_closest' if c == 'cluster_sweep' else c:
            counters.get(f'{c}.launches', 0)
            for _, c, _ in binding.OPS.values()}


def launches_since(before, names=None):
    """The launches of the kernels `names` (None: every one) since `before`
    (launch_counts taken then)."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in (names or now)}


def media_main(sc, cam, card, profile):
    """Scene O's Renderer at 1920x1080, 1 sample per wave, 3 bounces,
    compaction: one warm-up wave (under torch.profiler if `profile`),
    then MEDIA_WAVES waves timed one by one (every kernel's launches
    counted over them, the marches' rounds and lanes
    logged).  The overflow stat must stay 0."""
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.scene import scene as scn
    cfg = pt.RenderConfig(width=W, height=H, nrays=16, nb_bounces=BOUNCES,
                          samples_per_wave=1, compact_rays=True)
    r = pt.Renderer(sc, cam, cfg)
    split = busy = n_kern = inclusive = profile_s = None
    if profile:
        t0 = time.perf_counter()
        split, busy, n_kern, inclusive = profile_split(r, MEDIA_LABELS)
        profile_s = time.perf_counter() - t0
    else:
        timed(r.step)
    counted = launch_counts()
    scn.MARCH_LOG = []
    rays0, ms = r.rays_traced, []
    try:
        with media_counters() as (march_c, fog_c):
            for _ in range(MEDIA_WAVES):
                ms.append(timed(r.step)[1])
    finally:
        log_m, scn.MARCH_LOG = scn.MARCH_LOG, None
    launches = launches_since(counted)
    live = r.rays_traced - rays0
    overflow = r.stats(1.0)['ss_reservoir_overflow']
    img = r.display().cpu().numpy()
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError('scene O image not finite / wrong shape')
    region = img[int(H * 0.55):int(H * 0.9), int(W * 0.4):int(W * 0.6)]
    if not region.std() > 0.01 or not region.mean() > 0.02:
        raise AssertionError(f'scene O mesh region not lit: mean '
                             f'{region.mean():.4f} std {region.std():.4f}')
    for name in ('cluster_sweep_closest', 'cluster_sweep_any',
                 'pcg_draw'):
        if launches[name] <= 0:
            raise AssertionError(f'{name} never launched on scene O')
    if not log_m or not fog_c:
        raise AssertionError('scene O ran no march or no fog event')
    if overflow != 0:
        raise AssertionError(f'scene O: {overflow} reservoir overflows')
    per_round = collections.defaultdict(list)
    for e in log_m:
        for i, lanes in enumerate(e['lanes']):
            per_round[i].append(lanes)
    rounds = {f'round {i + 1}': dict(marches=len(v), lanes_mean=float(
        np.mean(v)), lanes_max=int(max(v))) for i, v in per_round.items()}
    waves = MEDIA_WAVES
    rep = dict(
        ms_per_wave=spread(ms), live_rays_per_s=live / (sum(ms) / 1e3),
        launches_per_wave={k: v / waves for k, v in launches.items()},
        march_closest_launches_per_wave=sum(
            e['launches'] for e in march_c) / waves,
        fog_closest_launches_per_wave=sum(
            e['launches'] for e in fog_c) / waves,
        fog_probe_queries_per_wave=len(fog_c) / waves,
        fog_probe_lanes_per_wave=sum(e['lanes'] for e in fog_c) / waves,
        marches_per_wave=len(log_m) / waves,
        march_rounds_per_wave=sum(len(e['lanes']) for e in log_m) / waves,
        march_rounds=rounds,
        march_overflow_round_lanes=sum(e['overflow_round'] for e in log_m),
        ss_reservoir_overflow=overflow, profiled_split_ms=split,
        profiled_inclusive_ms=inclusive, profiled_busy_ms=busy,
        profiled_kernels=n_kern, profile_seconds=profile_s,
        image_mean=float(img.mean()))
    log(f'scene O 1080p, 2.4M tris, fog + subsurface (config 5), env map, '
        f'3 bounces, compaction ({card}): ms per wave median '
        f'{rep["ms_per_wave"]["median"]:.1f} (min {min(ms):.1f}, max '
        f'{max(ms):.1f}; {", ".join(f"{x:.1f}" for x in ms)}); '
        f'{rep["live_rays_per_s"]:.4g} live rays/s; launches per wave '
        f'{rep["launches_per_wave"]}; closest-hit launches per wave in the '
        f'march {rep["march_closest_launches_per_wave"]:.1f}, in the fog '
        f'probe {rep["fog_closest_launches_per_wave"]:.1f}')
    log(f'  fog probe queries per wave {rep["fog_probe_queries_per_wave"]:.1f}'
        f' ({rep["fog_probe_lanes_per_wave"]:.0f} lanes); marches per wave '
        f'{rep["marches_per_wave"]:.1f}, rounds per wave '
        f'{rep["march_rounds_per_wave"]:.1f}; per round: '
        + '; '.join(f'{k}: {v["marches"]} marches, lanes mean '
                    f'{v["lanes_mean"]:.0f}, max {v["lanes_max"]}'
                    for k, v in rounds.items())
        + f'; overflow stat {overflow}')
    if profile:
        log(f'  profiled wave (torch.profiler, device time): '
            + ', '.join(f'{k} {v:.1f} ms' for k, v in split.items())
            + f'; launched inside each range: '
            + ', '.join(f'{k} {v:.1f} ms' for k, v in inclusive.items())
            + f'; all {n_kern} kernels {busy:.1f} ms, busy '
            f'{busy / rep["ms_per_wave"]["median"]:.3f} of the median wave '
            f'(profiled and read in {profile_s:.1f} s)')
    return launches, rep


def media_grads(sc, cam, card):
    """Scene O at MEDIA_GRAD_W x MEDIA_GRAD_H, 2 spp: the gradient of the
    float64 mean image with respect to the fog density and the mesh's
    g_ksub, autograd on the card, against central differences with the
    gradcheck ladder's steps and tolerances
    (tests/test_gradcheck_ladder.py:213-222: 5e-3 of max(|value|, 1);
    0.08 for the fog density, 0.1 for ksub, here relative to the autograd
    value).  Held twice: on the render path as it ships, and with the
    integrator's weight cull patched to 0 for the check, the estimator's
    own gradient: the cull ends a path whose throughput falls below a
    threshold, so the image jumps where a lane crosses it and the central
    difference holds those jumps, which no derivative has."""
    import torch
    from unittest import mock
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.core import rng_host
    from pathtracer_tpu_torch.render import integrator as integ
    from pathtracer_tpu_torch.render import renderer as rnd
    w, h = MEDIA_GRAD_W, MEDIA_GRAD_H
    cfg = pt.RenderConfig(width=w, height=h, nrays=2, nb_bounces=BOUNCES,
                          compact_rays=True)
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(w, h),
                         device=sc.device)
    mesh = sc.meshes[0]
    base = {'fog_density': sc.fog_density, 'g_ksub': mesh.g_ksub}

    def loss_of(leaves):
        s = sc.replace(fog_density=leaves['fog_density'],
                       meshes=(mesh.replace(g_ksub=leaves['g_ksub']),))
        return rnd.render_unsplatted(s, cam, cp, cfg)[0].double().mean() \
            / RADIANCE

    out = {}
    for label, cull in (('cull_on', integ.WEIGHT_CULL), ('cull_off', 0.0)):
        with mock.patch.object(integ, 'WEIGHT_CULL', cull):
            leaves = {k: v.clone().requires_grad_() for k, v in base.items()}
            loss, ms = timed(lambda: loss_of(leaves))
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            check_grads(grads, f'scene O ({label})')
            log(f'scene O gradients {w}x{h}x2spp, weight cull {cull:g} '
                f'({card}): forward {ms:.1f} ms')
            out[label] = {}
            for name, idx, rtol in (('fog_density', (), 0.08),
                                    ('g_ksub', (0, 0), 0.1)):
                step = 5e-3 * max(abs(float(base[name][idx])), 1.0)
                out[label][name] = dict(index=list(idx), **fd_check(
                    loss_of, base, name, idx, step, rtol, grads))
    return out


def ghost_flagship(dev, cam, card):
    """The flagship with a ghost sphere and a 1080 x 1920 background
    photo at 1920x1080, 1 sample per wave, 3 bounces, compaction: one
    warm-up and MEDIA_WAVES timed waves; the image finite and lit."""
    import pathtracer_tpu_torch as pt
    sc = flagship_scene(dev, ghost=True, background=background_photo())
    if not sc.ghost_enabled or sc.background is None:
        raise AssertionError('the ghost flagship lost its ghost or photo')
    cfg = pt.RenderConfig(width=W, height=H, nrays=16, nb_bounces=BOUNCES,
                          samples_per_wave=1, compact_rays=True)
    r = pt.Renderer(sc, cam, cfg)
    r.step()
    rays0 = r.rays_traced
    ms = [timed(r.step)[1] for _ in range(MEDIA_WAVES)]
    img = r.display().cpu().numpy()
    if not np.isfinite(img).all() or not img.mean() > 0.02:
        raise AssertionError('ghost flagship image not finite / not lit')
    rep = dict(ms_per_wave=spread(ms), live_rays_per_s=(
        r.rays_traced - rays0) / (sum(ms) / 1e3),
        image_mean=float(img.mean()))
    log(f'ghost flagship 1080p + 1080x1920 background, 3 bounces, '
        f'compaction ({card}): ms per wave median '
        f'{rep["ms_per_wave"]["median"]:.1f} (min {min(ms):.1f}, max '
        f'{max(ms):.1f}); {rep["live_rays_per_s"]:.4g} live rays/s')
    return sc, rep


def media_phase(dev, cam, card, profile=False):
    """Scene O: build, the march sweep check, the card against the CPU
    (scene O's geometry at MEDIA_REF_LAT, and the ghost + background
    flagship), the 1080p waves (the warm-up profiled if `profile`), the
    fog and ksub gradients; the ghost flagship's waves.  Returns the
    launches of scene O's waves and the phase's numbers."""
    steps = {}
    t0 = time.perf_counter()

    def step(name):
        nonlocal t0
        steps[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    sc = media_scene(dev)
    step('build')
    m0 = sc.meshes[0]
    log(f'scene O build {steps["build"]:.1f} s: {m0.n_tris} tris, '
        f'{m0.n_clusters} clusters, backface cull {m0.backface_cull}, fog '
        f'{sc.fog_enabled} (type {sc.fog_type}, phase {sc.fog_phase_type}), '
        f'subsurface {sc.ss_enabled}, env map {tuple(sc.envmap.shape)}')
    if not (sc.fog_enabled and sc.ss_enabled) or m0.backface_cull:
        raise AssertionError('scene O lost its fog or its subsurface mesh')
    check = march_sweep_check(sc, cam, dev)
    del check['exit_ok'], check['exit_p']
    step('march_check')
    small = media_scene(dev, lat=MEDIA_REF_LAT, env=(256, 512))
    if small.meshes[0].n_tris <= 65536:
        raise AssertionError('the reference sphere would not march')
    flips = {'scene_o_small': card_vs_cpu(small, 'scene O (small mesh)')}
    del small
    step('reference_scene_o')
    ghost_sc, ghost = ghost_flagship(dev, cam, card)
    step('ghost_waves')
    flips['ghost_background'] = card_vs_cpu(ghost_sc,
                                            'ghost + background flagship')
    del ghost_sc
    step('reference_ghost')
    launches, rep = media_main(sc, cam, card, profile)
    step('waves')
    grads = media_grads(sc, cam, card)
    step('grads')
    log('media phase steps (s): '
        + ', '.join(f'{k} {v:.1f}' for k, v in steps.items()))
    return launches, dict(scene_o=rep, march_check=check,
                          card_vs_cpu_flipped=flips, scene_o_grads=grads,
                          ghost_flagship=ghost, seconds=steps)


CLI_SPP = 1             # samples of the CLI's 1080p render (one wave; 4
                        # before the fluid phase, 2 before the time
                        # limit's cuts)
CLI_SMALL = (480, 270)  # the module entry point's subprocess render
CLI_SUB_LAT = 200       # its sphere: 79,600 triangles (the 2.4M-triangle
                        # file took it 27 s to parse and build)
RESUME_SPP = 2          # checkpoint/resume's samples, stopped after half
                        # (4 before the time limit's cuts)
# the .scn mesh's keyframes: at --frame 1 it sits where the main path's does
CLI_KEYFRAMES = {0.0: {'translation': (-2.0, -15.0, 0.0)},
                 2.0: {'translation': (2.0, -15.0, 0.0)}}
KPCN_CROP = 256         # KPCN-lite's card-vs-CPU crop
KPCN_MARGIN = 8         # its receptive field: six 3x3 convs and the 5x5 taps
KPCN_TOL = 1e-4         # max |card - CPU| over the crop's max |output|


def write_cli_scene(d, lat=1100, size=(W, H)):
    """The main path's scene as files in `d`: the 2.4M-tri sphere as an
    OBJ (port's save_obj), the slate and the sphere as a .scn (port's
    save_scn) with its non-lenticular block, has_denoiser 1 and the
    sphere on two keyframes.  Vertices are written as (z, y, -x), which
    the loader's axis swap turns back into the sphere's own.  Returns
    (.scn path, triangles)."""
    import copy
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.io import obj as obj_io
    from pathtracer_tpu_torch.io import scn_export
    from pathtracer_tpu_torch.scene import scene as scn
    from pathtracer_tpu_torch.utils import procgen
    md = procgen.sphere_mesh(lat, lat, radius=14.0, displace_amp=0.25)
    saved = copy.copy(md)
    saved.vertices = md.vertices[:, [2, 1, 0]] * np.float32([1, 1, -1])
    obj_path = os.path.join(d, 'sphere.obj')
    obj_io.save_obj(saved, obj_path)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(md, translation=(0.0, -15.0, 0.0),
                                keyframes=CLI_KEYFRAMES, name='sphere.obj',
                                is_centered=False))
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cfg = pt.RenderConfig(width=size[0], height=size[1], nrays=CLI_SPP,
                          nb_bounces=BOUNCES, has_denoiser=True)
    path = os.path.join(d, 'scene.scn')
    scn_export.save_scn(path, objs, scn.default_light_intensity(), cam, cfg,
                        {})
    return path, md.num_triangles


@contextlib.contextmanager
def sample_timer():
    """Renderer.step split into one-sample steps, each timed by CUDA
    events with the two sweeps' launches counted (samples are keyed by
    absolute index, so the split changes no bit); restored on exit.
    Yields a dict of the per-sample lists and the renderers seen."""
    from pathtracer_tpu_torch.render import renderer as rnd
    orig = rnd.Renderer.step
    rec = dict(ms=[], closest=[], any=[], renderers=[])

    def step(self, nsamples=None):
        if not any(r is self for r in rec['renderers']):
            rec['renderers'].append(self)
        for _ in range(nsamples or self.cfg.samples_per_wave):
            n0 = launch_counts()
            rec['ms'].append(timed(lambda: orig(self, 1))[1])
            n = launches_since(n0)
            rec['closest'].append(n['cluster_sweep_closest'])
            rec['any'].append(n['cluster_sweep_any'])
        return self

    rnd.Renderer.step = step
    try:
        yield rec
    finally:
        rnd.Renderer.step = orig


@contextlib.contextmanager
def recorded_sweeps():
    """Both sweeps recorded (record_sweeps) while the block runs."""
    closest, restore_c = record_sweeps('cluster_sweep')
    anyhit, restore_a = record_sweeps('cluster_sweep_any')
    try:
        yield closest, anyhit
    finally:
        restore_a()
        restore_c()


def hold_sweeps(closest, anyhit, what, picks=(0, -1)):
    """The recorded launches at `picks` of each sweep against its plain
    version on the same inputs, bit for bit; returns how many launches
    were recorded and held.  anyhit None: a closest-hit query only (the
    any-hit sweep must not have launched)."""
    from pathtracer_tpu_torch.ops import cluster as cl
    if not closest or anyhit is not None and not anyhit:
        raise AssertionError(f'{what}: a sweep was never launched')
    held = 0
    for calls, plain, kind in ((closest, cl.cluster_sweep_plain, 'closest'),
                               (anyhit or [], cl.cluster_sweep_any_plain,
                                'any')):
        for i in sorted({p % len(calls) for p in picks} if calls else ()):
            args, out_k = calls[i]
            out_p = plain(*args)
            out_p = out_p if isinstance(out_p, tuple) else (out_p,)
            if not same_bits(out_k, out_p):
                raise AssertionError(f'{what}: {kind} sweep launch {i} '
                                     f'differs from its plain version')
            held += 1
    return dict(closest_launches=len(closest),
                any_launches=len(anyhit or ()), held=held,
                lanes=int(closest[0][0][4].shape[0]))


class AfterSamples:
    """A preemption guard whose request stands once `r` has `n` samples."""

    def __init__(self, r, n):
        self.r, self.n = r, n

    @property
    def requested(self):
        return self.r.samples_done >= self.n


def resume_check(sc, cam, cfg, d):
    """Checkpoint and resume on the card: two straight renders give the
    same bits; render_resumable stopped after half the samples (one a
    wave) writes its .npz, a second call completes bit-equal to the
    straight render and removes it.  Returns the times."""
    import torch
    import pathtracer_tpu_torch as pt
    out, ms = [], []
    for _ in range(2):
        r, t = timed(lambda: pt.Renderer(sc, cam, cfg).render())
        out.append((r.image.clone(), r.sample_count.clone(),
                    tuple(a.clone() for a in r.aux)))
        ms.append(t)
    if not (torch.equal(out[0][0], out[1][0])
            and torch.equal(out[0][1], out[1][1])
            and all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))):
        raise AssertionError('two straight renders differ: the path is not '
                             'deterministic')
    path = os.path.join(d, 'resume.npz')
    half = cfg.nrays // 2
    r = pt.Renderer(sc, cam, cfg)
    (_, t_first) = timed(lambda: r.render_resumable(
        path, guard=AfterSamples(r, half)))
    if r.samples_done != half or not os.path.exists(path):
        raise AssertionError(f'render_resumable did not stop at {half} '
                             f'samples with its checkpoint '
                             f'({r.samples_done})')
    nbytes = os.path.getsize(path)
    r2 = pt.Renderer(sc, cam, cfg)
    (_, t_second) = timed(lambda: r2.render_resumable(path))
    if r2.samples_done != cfg.nrays or os.path.exists(path):
        raise AssertionError('the resumed render did not complete or left '
                             'its checkpoint')
    if not (torch.equal(r2.image, out[0][0])
            and torch.equal(r2.sample_count, out[0][1])
            and all(torch.equal(a, b) for a, b in zip(r2.aux, out[0][2]))):
        raise AssertionError('resumed render differs from the straight one')
    return dict(straight_ms=ms, first_call_ms=t_first,
                second_call_ms=t_second, checkpoint_bytes=nbytes)


def kpcn_check(r, dev):
    """KPCN-lite with the shipped weights on the CLI render's buffers: the
    whole 1080p frame on the card (timed, peak memory), and a
    KPCN_CROP^2 crop on the card and on the CPU; the card's crop and the
    full frame's crop interior must match the CPU within KPCN_TOL of the
    crop's largest |output|."""
    import torch
    from pathtracer_tpu_torch.render import denoise_net as dnn
    model = dnn.load_model(device=dev)
    if model is None:
        raise AssertionError('the shipped KPCN weights did not load')
    n = max(r.samples_done, 1)
    color, albedo = r.aux[0] / n, r.aux[1] / n
    nrm = r.aux[2] / torch.clamp_min(torch.linalg.vector_norm(
        r.aux[2], dim=-1, keepdim=True), 1e-9)
    dnn.denoise_apply(model, color, albedo, nrm)          # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    full, ms = timed(lambda: dnn.denoise_apply(model, color, albedo, nrm))
    peak = torch.cuda.max_memory_allocated(dev) - base
    learned = dnn.denoise_learned(color, albedo, nrm)
    if not torch.allclose(learned, full, rtol=0.0,
                          atol=KPCN_TOL * float(full.abs().max())):
        raise AssertionError('denoise_learned did not take the learned path')
    h, w = color.shape[:2]
    y0, x0 = (h - KPCN_CROP) // 2, (w - KPCN_CROP) // 2
    crop = [x[y0:y0 + KPCN_CROP, x0:x0 + KPCN_CROP] for x in (color, albedo,
                                                               nrm)]
    on_card = dnn.denoise_apply(model, *crop)
    on_cpu = dnn.denoise_apply(dnn.load_model(device='cpu'),
                               *(x.cpu() for x in crop))
    scale = float(on_cpu.abs().max())
    err_crop = float((on_card.cpu() - on_cpu).abs().max())
    m = KPCN_MARGIN
    inner = (slice(m, KPCN_CROP - m), slice(m, KPCN_CROP - m))
    err_full = float((full[y0:y0 + KPCN_CROP, x0:x0 + KPCN_CROP][inner].cpu()
                      - on_cpu[inner]).abs().max())
    if not np.isfinite(full.cpu().numpy()).all() or scale <= 0.0:
        raise AssertionError('KPCN output not finite or empty')
    if max(err_crop, err_full) > KPCN_TOL * scale:
        raise AssertionError(f'KPCN on the card differs from the CPU: '
                             f'{err_crop:.3g} (crop), {err_full:.3g} (frame)'
                             f' against {KPCN_TOL * scale:.3g}')
    return dict(ms=ms, peak_bytes=peak, max_abs_err_crop=err_crop,
                max_abs_err_frame=err_full, crop_scale=scale)


def preview_check(sc, cam, cfg):
    """--progressive's fill-in at full size: preview() (W/16 x H/16, one
    sample, timed) and display_fill_in() before the first wave (the pure
    upsampled preview) and after it (a blend)."""
    import torch
    import torch.nn.functional as F
    import pathtracer_tpu_torch as pt
    r = pt.Renderer(sc, cam, cfg)
    low, ms_preview = timed(r.preview)
    d0, ms_fill0 = timed(r.display_fill_in)
    up = F.interpolate(low.permute(2, 0, 1)[None], size=d0.shape[:2],
                       mode='bilinear', align_corners=False)[0]
    want = torch.clamp(torch.pow(torch.clamp_min(up.permute(1, 2, 0), 0.0),
                                 1.0 / cfg.gamma), 0.0, 1.0)
    if not torch.equal(d0, want) or not float(low.max()) > 0.0:
        raise AssertionError('fill-in before the first wave is not the '
                             'upsampled preview')
    r.step(1)
    d1, ms_fill1 = timed(r.display_fill_in)
    if not torch.isfinite(d1).all() or torch.equal(d1, r.display()):
        raise AssertionError('fill-in after one wave is not a blend')
    return dict(preview_shape=list(low.shape), preview_ms=ms_preview,
                fill_in_ms_before=ms_fill0, fill_in_ms_after=ms_fill1)


def cli_phase(dev, card, size=(W, H), lat=1100, spp=CLI_SPP):
    """The headless entry point on the main path's scene written as .scn:
    the files round-trip; `cli.main` renders it at `size` (1080p) with
    --denoise, every sample timed, both sweeps launched and held against
    their plain versions; the denoised display, the lenticular camera,
    checkpoint/resume, the preview fill-in and KPCN-lite on its result;
    then the module entry point as a subprocess.  Returns the launches of
    the CLI's render and the phase's numbers."""
    import subprocess as sp
    import tempfile
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch import cli
    from pathtracer_tpu_torch.io import image as image_io
    from pathtracer_tpu_torch.io import scn_export, scn_import
    steps, rep = {}, {}
    t0 = time.perf_counter()

    def step(name):
        nonlocal t0
        steps[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    w, h = size
    with tempfile.TemporaryDirectory() as d:
        path, n_tris = write_cli_scene(d, lat, size)
        step('write')
        parsed = scn_import.load_scn(path, device=dev)
        objs, _, cam, cfg, _ = parsed
        if objs[-1].mesh_data.num_triangles != n_tris or not (
                objs[-1].keyframes and len(objs[-1].keyframes) == 2) \
                or cam.is_lenticular or (cfg.width, cfg.height) != size:
            raise AssertionError('the .scn did not load back its mesh, '
                                 'keyframes, camera or size')
        # save_scn(load_scn(f)) parses the same: both write the same text
        texts = []
        for name in ('again.scn', 'again2.scn'):
            scn_export.save_scn(os.path.join(d, name), *parsed)
            with open(os.path.join(d, name)) as f:
                texts.append(f.read())
            parsed = scn_import.load_scn(os.path.join(d, name), device=dev)
        if texts[0] != texts[1] or \
                parsed[0][-1].mesh_data.num_triangles != n_tris:
            raise AssertionError('save_scn(load_scn(f)) does not parse the '
                                 'same')
        del parsed, objs
        step('load')

        out = os.path.join(d, 'out.hdr')
        argv = [path, out, '--spp', str(spp), '--size', f'{w}x{h}',
                '--frame', '1', '--denoise']
        counted = launch_counts()
        with recorded_sweeps() as (closest, anyhit), sample_timer() as rec:
            rc = cli.main(argv)
        launches = launches_since(counted)
        step('cli')
        img = image_io.load_hdr(out)
        region = img[int(h * 0.55):int(h * 0.9), int(w * 0.4):int(w * 0.6)]
        if rc != 0 or img.shape != (h, w, 3) or not np.isfinite(img).all() \
                or not region.mean() > 0.0:
            raise AssertionError(f'the CLI render failed: rc {rc}, image '
                                 f'{img.shape}')
        for name in ('cluster_sweep_closest', 'cluster_sweep_any',
                     'pcg_draw'):
            if launches[name] <= 0:
                raise AssertionError(f'{name} never launched by the CLI')
        r = rec['renderers'][0]
        held = hold_sweeps(closest, anyhit, 'CLI render')
        del closest, anyhit
        rays = r.rays_traced
        rep['cli'] = dict(argv=argv[2:], ms_per_sample=spread(rec['ms']),
                          live_rays_per_s=rays / (sum(rec['ms']) / 1e3),
                          closest_per_sample=rec['closest'],
                          any_per_sample=rec['any'], sweeps_held=held,
                          compact_rays=r.cfg.compact_rays,
                          hdr_mean=float(img.mean()))
        r.denoised_display()
        den, ms_den = timed(r.denoised_display)
        if not np.isfinite(den.cpu().numpy()).all():
            raise AssertionError('denoised display not finite')
        rep['atrous_ms'] = ms_den
        step('sweeps_and_atrous')

        lcam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0),
                              is_lenticular=True)
        lcfg = r.cfg._replace(nrays=1)
        with recorded_sweeps() as (closest, anyhit), sample_timer() as lrec:
            pt.Renderer(r.scene, lcam, lcfg).step(1)
        rep['lenticular'] = dict(
            ms=lrec['ms'][0], closest=lrec['closest'][0],
            any=lrec['any'][0],
            sweeps_held=hold_sweeps(closest, anyhit, 'lenticular', (0,)))
        del closest, anyhit
        step('lenticular')

        rcfg = r.cfg._replace(nrays=RESUME_SPP, samples_per_wave=1,
                              compact_rays=True)
        rep['resume'] = resume_check(r.scene, r.cam, rcfg, d)
        step('resume')
        rep['preview'] = preview_check(r.scene, r.cam, r.cfg)
        step('preview')
        rep['kpcn'] = kpcn_check(r, dev)
        step('kpcn')
        sc = r.scene
        del r, rec, sc

        small = os.path.join(d, 'small.hdr')
        sub_dir = os.path.join(d, 'sub')
        os.mkdir(sub_dir)
        sub_path, _ = write_cli_scene(sub_dir, CLI_SUB_LAT, CLI_SMALL)
        here = os.path.dirname(os.path.abspath(__file__))
        proc = sp.run([sys.executable, '-m', 'pathtracer_tpu_torch.cli',
                       sub_path, small, '--spp', '2', '--size',
                       f'{CLI_SMALL[0]}x{CLI_SMALL[1]}'], cwd=here,
                      capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or not os.path.exists(small):
            raise AssertionError(f'python -m pathtracer_tpu_torch.cli exited '
                                 f'{proc.returncode}: {proc.stderr[-2000:]}')
        small_img = image_io.load_hdr(small)
        if small_img.shape != (CLI_SMALL[1], CLI_SMALL[0], 3) \
                or not np.isfinite(small_img).all():
            raise AssertionError('the subprocess CLI image is wrong')
        rep['subprocess'] = dict(rc=proc.returncode,
                                 stdout=proc.stdout.strip().splitlines()[-3:])
        step('subprocess')
    rep['seconds'] = steps
    rep['triangles'] = n_tris
    c = rep['cli']
    log(f'CLI {w}x{h} x {spp} spp, {n_tris} tris from .scn, frame 1, '
        f'--denoise ({card}): ms per sample median '
        f'{c["ms_per_sample"]["median"]:.1f} (min '
        f'{c["ms_per_sample"]["min"]:.1f}, max {c["ms_per_sample"]["max"]:.1f})'
        f'; {c["live_rays_per_s"]:.4g} live rays/s; sweep launches per '
        f'sample closest {c["closest_per_sample"]}, any {c["any_per_sample"]}'
        f'; held bit-equal {c["sweeps_held"]}; a-trous (4 levels) '
        f'{rep["atrous_ms"]:.1f} ms')
    lt = rep['lenticular']
    log(f'  lenticular (10 images, pixel width 1) 1 spp: {lt["ms"]:.1f} ms, '
        f'launches closest {lt["closest"]}, any {lt["any"]}; held '
        f'{lt["sweeps_held"]}')
    log(f'  resume: {rep["resume"]}; preview: {rep["preview"]}')
    log(f'  KPCN-lite {w}x{h}: {rep["kpcn"]["ms"]:.1f} ms, peak '
        f'{rep["kpcn"]["peak_bytes"] / 2**20:.1f} MiB, crop errors '
        f'{rep["kpcn"]["max_abs_err_crop"]:.3g} / '
        f'{rep["kpcn"]["max_abs_err_frame"]:.3g} of scale '
        f'{rep["kpcn"]["crop_scale"]:.4g}; subprocess {rep["subprocess"]}')
    log('CLI phase steps (s): '
        + ', '.join(f'{k} {v:.1f}' for k, v in steps.items()))
    return launches, rep


FLUID_N = 128           # scene F's grid: 128^3 cells of 0.375 (cubic cells,
FLUID_LO = (-24.0, -30.0, -24.0)   # as the solver assumes)
FLUID_HI = (24.0, 18.0, 24.0)
FLUID_DT = 0.03
FLUID_SUBSTEPS = 2
FLUID_FRAMES = 10
FLUID_PARTICLES = 320_000   # about 8 per inside cell of the r = 8 shape
FLUID_RADIUS = 0.2
FLUID_WAVES = 1         # timed opaque 1080p waves of scene F, after a warm-up
                        # (3 before the training phase)
FLUID_T_WAVES = 1       # timed transparent waves, after a warm-up (2 before
                        # the training phase)
FLUID_STRIDE = 16       # every 16th 1080p primary held against brute force
FLUID_UNION_LANES = 2048   # rays from inside the fluid, union exit held
FLUID_UNION_ITERS = 40     # passes of the converged brute union walk
FLUID_LABELS = ('pcull', 'pslots', 'preroute', 'pbrute', 'cull')
FLUID_SMALL = (480, 270)   # the disk cloud's and the yarns' timed wave
FLUID_CPU_TOL = 1e-4    # card vs CPU particles, of the extent's size (the
                        # CPU tests' tolerance against JAX)


def checker(n, c0, c1, tiles=8):
    """An n x n checker of two linear colours in [0, 1]
    (scripts/gallery_fluid_colored.py's kd map)."""
    ij = np.add.outer(np.arange(n) * tiles // n,
                      np.arange(n) * tiles // n) % 2
    return np.where(ij[..., None] == 0, np.asarray(c0, np.float32),
                    np.asarray(c1, np.float32)).astype(np.float32)


def fluid_config():
    """Scene F's grid over FLUID_LO..FLUID_HI."""
    from pathtracer_tpu_torch.sim import fluid as fl
    n = FLUID_N
    return fl.FluidConfig(lo=FLUID_LO, hi=FLUID_HI, nx=n, ny=n, nz=n,
                          dt=FLUID_DT, nsubsteps=FLUID_SUBSTEPS)


def shape_objects(lat=400, radius=8.0, center=(0.0, 8.0, 0.0), tex=512):
    """The default slate and the checker-textured sphere_mesh the fluid
    is seeded from (row 3)."""
    from pathtracer_tpu_torch.scene import scene as scn
    from pathtracer_tpu_torch.utils import procgen
    objs = scn.default_objects()
    objs.append(scn.mesh_object(
        procgen.sphere_mesh(lat, lat, radius=radius), translation=center,
        textures={'kd': checker(tex, (0.9, 0.35, 0.15), (0.2, 0.45, 0.9))}))
    return objs


def solid_objects(lat=1100):
    """The default slate and the main path's sphere, the solid the fluid
    is poured on (row 3)."""
    from pathtracer_tpu_torch.scene import scene as scn
    from pathtracer_tpu_torch.utils import procgen
    objs = scn.default_objects()
    objs.append(scn.mesh_object(
        procgen.sphere_mesh(lat, lat, radius=14.0, displace_amp=0.25),
        translation=(0.0, -15.0, 0.0)))
    return objs


@contextlib.contextmanager
def substep_timer():
    """fluid.substep timed by CUDA events, each pressure solve's
    iterations and final residual logged (fluid.CG_LOG); restored on
    exit.  Yields {'ms': [...], 'cg': [...]}."""
    from pathtracer_tpu_torch.sim import fluid as fl
    orig = fl.substep
    rec = dict(ms=[], cg=[])

    def step(cfg, st):
        out, ms = timed(lambda: orig(cfg, st))
        rec['ms'].append(ms)
        return out

    fl.substep, fl.CG_LOG = step, rec['cg']
    try:
        yield rec
    finally:
        fl.substep, fl.CG_LOG = orig, None


def check_frames(cfg, frames, n, what):
    """Every frame holds the n particles, finite and inside the extent;
    the mean height falls.  Returns the first and last mean heights."""
    lo, hi = np.asarray(cfg.lo), np.asarray(cfg.hi)
    for f in frames:
        if f.shape != (n, 3) or not np.isfinite(f).all() \
                or (f < lo).any() or (f > hi).any():
            raise AssertionError(f'{what}: a frame lost particles or left '
                                 f'the extent')
    y0, y1 = float(frames[0][:, 1].mean()), float(frames[-1][:, 1].mean())
    if not y1 < y0:
        raise AssertionError(f'{what}: the mean height did not fall '
                             f'({y0:.4f} -> {y1:.4f})')
    return y0, y1


def fluid_sim(dev, solids, card):
    """Scene F's simulation: the solid cells by rasterize_solids (12 casts
    through the 2.4M-tri sphere, backface cull off), particles seeded by
    seed_from_object from the checker sphere (12 casts, from inside the
    shape), both casts' closest-hit sweeps recorded and their first and
    last launches held bit for bit; then `run` for FLUID_FRAMES frames of
    FLUID_SUBSTEPS substeps, each substep timed, each solve's CG
    iterations and residual read.  Returns (frames, colours, report)."""
    from pathtracer_tpu_torch.sim import fluid as fl
    cfg = fluid_config()
    rep = {}
    t0 = time.perf_counter()
    with recorded_sweeps() as (closest, anyhit):
        solid = fl.rasterize_solids(cfg, solids, device=dev)
    rep['solid_seconds'] = time.perf_counter() - t0
    rep['solid_casts_held'] = hold_sweeps(closest, anyhit or None,
                                          'solid casts')
    rep['solid_cells'] = int(solid.sum())
    del closest, anyhit
    t0 = time.perf_counter()
    shape = shape_objects()
    rep['shape_seconds'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with recorded_sweeps() as (closest, anyhit):
        pts, cols = fl.seed_from_object(cfg, shape, 3, FLUID_PARTICLES,
                                        device=dev)
    rep['seed_seconds'] = time.perf_counter() - t0
    rep['seed_casts_held'] = hold_sweeps(closest, anyhit or None,
                                         'seeding casts')
    del closest, anyhit, shape
    if not 0.5 * FLUID_PARTICLES < len(pts) < 1.5 * FLUID_PARTICLES:
        raise AssertionError(f'seeded {len(pts)} particles')
    n_colours = len(np.unique(np.round(cols, 3), axis=0))
    if n_colours < 2:
        raise AssertionError('the seeded particles lost the checker colours')
    st = fl.reclassify(cfg, fl.init_state(cfg, pts, solid, device=dev))
    with substep_timer() as rec:
        t0 = time.perf_counter()
        st, frames = fl.run(cfg, st, FLUID_FRAMES)
        rep['run_seconds'] = time.perf_counter() - t0
    y0, y1 = check_frames(cfg, frames, len(pts), 'scene F')
    iters = [c['iters'] for c in rec['cg']]
    res = [c['residual'] for c in rec['cg']]
    capped = sum(r > cfg.cg_tol for r in res)
    rep.update(grid=FLUID_N, particles=len(pts), colours=n_colours,
               substeps=len(rec['ms']), ms_per_substep=spread(rec['ms']),
               cg_iters=iters, cg_residual=res, cg_capped=capped,
               cg_tol=cfg.cg_tol, cg_cap=cfg.cg_iters, mean_height=[y0, y1],
               fluid_cells=int((st.celltypes == fl.FLUID).sum()))
    log(f'scene F simulation {FLUID_N}^3 ({card}): solid cells '
        f'{rep["solid_cells"]} by rasterize_solids in '
        f'{rep["solid_seconds"]:.1f} s (closest-hit launches held '
        f'{rep["solid_casts_held"]}); {len(pts)} particles, {n_colours} '
        f'colours, seeded in {rep["seed_seconds"]:.1f} s (held '
        f'{rep["seed_casts_held"]}); {len(rec["ms"])} substeps, ms per '
        f'substep median {rep["ms_per_substep"]["median"]:.1f} (min '
        f'{rep["ms_per_substep"]["min"]:.1f}, max '
        f'{rep["ms_per_substep"]["max"]:.1f}); CG iterations {iters}, '
        f'final residuals max {max(res):.3g} (cg_tol {cfg.cg_tol:g})'
        + (f'; the cap of {cfg.cg_iters} iterations bit in {capped} of '
           f'{len(res)} solves' if capped else '')
        + f'; mean height {y0:.3f} -> {y1:.3f}')
    return frames, cols, rep


def particle_hold(ps, cam, dev):
    """The particle tier on the 1080p primaries: clustered_sphere_sweep
    over every lane (timed), held on every FLUID_STRIDE-th lane against
    the brute sphere_sweep on the card; clustered_union_exit on
    FLUID_UNION_LANES rays started just inside the fluid along those
    primaries, held against the brute walk after 12 passes (what an
    overflowed packet's lanes get, as in JAX) and after
    FLUID_UNION_ITERS (the slot walk's fixed point).  Index equal on >= 99.9% of lanes, the rest ties within 2^-16
    relative t; the overflowed packets counted (pointset.SWEEP_LOG)."""
    import torch
    from pathtracer_tpu_torch.scene import pointset as tps
    org, dirn = primary_rays(cam, dev)
    big = torch.full((org.shape[0],), BIG_T, device=dev)
    tps.SWEEP_LOG = []
    try:
        (t_c, i_c), ms_c = timed(
            lambda: tps.clustered_sphere_sweep(ps, org, dirn, big))
        entry_log = tps.SWEEP_LOG[-1]
        sub = slice(None, None, FLUID_STRIDE)
        (t_b, i_b), ms_b = timed(
            lambda: tps.sphere_sweep(ps, org[sub], dirn[sub], big[sub]))
        entry = hold_particles(t_c[sub], i_c[sub], t_b, i_b, 'entry')
        hit = (t_c < BIG_T).nonzero()[:, 0]
        if hit.numel() < FLUID_UNION_LANES:
            raise AssertionError('too few primaries hit the fluid')
        pick = hit[torch.linspace(0, hit.numel() - 1, FLUID_UNION_LANES,
                                  device=dev).long()]
        o_in = org[pick] + (t_c[pick] + 0.05)[:, None] * dirn[pick]
        d_in = dirn[pick].contiguous()
        (e_c, x_c, n_c), ms_u = timed(
            lambda: tps.clustered_union_exit(ps, o_in, d_in))
        union_log = tps.SWEEP_LOG[-1]
        walks = {}
        for iters in (12, FLUID_UNION_ITERS):
            walks[iters], ms_ub = timed(lambda: tps.sphere_union_exit(
                ps, o_in, d_in, iters=iters))
        # a ray grazing its first sphere leaves it within the 0.05 step
        if not all(torch.equal(n_c, w[2]) for w in walks.values()) \
                or float(n_c.float().mean()) < 0.9:
            raise AssertionError('union exit: the inside flags differ or '
                                 'too few rays start inside the fluid')
        union = hold_particles(e_c, x_c, *zip(*(w[:2] for w in
                                                 walks.values())),
                               what='union exit')
    finally:
        tps.SWEEP_LOG = None
    rep = dict(entry=dict(lanes=int(org.shape[0]), held_lanes=int(
        t_b.numel()), hit_share=float((t_c < BIG_T).float().mean()),
        ms=ms_c, brute_ms=ms_b, **entry, **entry_log),
        union=dict(lanes=FLUID_UNION_LANES, inside_share=float(
            n_c.float().mean()), ms=ms_u, brute_ms=ms_ub, **union,
            **union_log))
    log(f'particle tier on the 1080p primaries: clustered_sphere_sweep '
        f'{ms_c:.1f} ms over {org.shape[0]} lanes ({rep["entry"]["hit_share"]:.3f}'
        f' hit), {entry_log["overflowed"]} of {entry_log["packets"]} packets '
        f'overflowed MAXC_P, {entry_log["residual"]} lanes rerouted; against '
        f'brute on every {FLUID_STRIDE}th lane ({ms_b:.1f} ms): {entry}; '
        f'clustered_union_exit {ms_u:.1f} ms on {FLUID_UNION_LANES} inside '
        f'rays ({union_log["overflowed"]} packets overflowed, '
        f'{union_log["residual"]} lanes rerouted) against the brute walk '
        f'(12 and {FLUID_UNION_ITERS} passes, {ms_ub:.1f} ms the latter): '
        f'{union}')
    return rep


def hold_particles(t_c, i_c, t_b, i_b, what):
    """Clustered (t_c, i_c) against brute force: index equal on >= 99.9%
    of lanes, the rest both hits and ties within 2^-16 relative t; t
    equal where the index is.  t_b and i_b may be tuples of brute runs
    (the union walk after 12 passes, JAX's overflow reroute, and run to
    its fixed point, the slot walk's): each lane is held to the run its
    index agrees with, else to the first."""
    import torch
    if not isinstance(t_b, tuple):
        t_b, i_b = (t_b,), (i_b,)
    same = torch.zeros_like(i_c, dtype=torch.bool)
    t_ref, i_ref = t_b[0].clone(), i_b[0].clone()
    for tb, ib in reversed(list(zip(t_b, i_b))):
        m = (i_c == ib) & (t_c == tb)
        t_ref[m], i_ref[m] = tb[m], ib[m]
        same |= m
    frac = float(same.float().mean())
    d = ~same
    if frac < 0.999 or bool(((i_c[d] < 0) | (i_ref[d] < 0)).any()) \
            or bool(((t_c[d] - t_ref[d]).abs() > TIE * t_ref[d].abs()).any()):
        raise AssertionError(f'{what}: clustered and brute differ beyond '
                             f'ties (equal on {frac:.5f})')
    return dict(index_equal=frac, ties=int(d.sum()))


def fluid_scene_f(solids, frames, cols, dev):
    """Scene F: the solids and the fluid's last frame as a clustered
    particle-sphere set (FLUID_RADIUS, the seeded colours)."""
    from pathtracer_tpu_torch.scene import pointset as tps
    from pathtracer_tpu_torch.scene import scene as scn
    ps = tps.fluid_pointset(frames[-1], radius=FLUID_RADIUS, color=cols,
                            device=dev)
    objs = list(solids) + [scn.pointset_object(ps)]
    return scn.build_scene(objs, scn.default_light_intensity(), device=dev)


def transparent(sc, refr=1.33):
    """`sc` with its point set's row transparent (union exit, refraction),
    as pointset_object(ps, transp=True, refr_index=refr) builds it."""
    row = sc.pointsets[0].obj_row
    transp, refr_index = sc.transp.clone(), sc.refr_index.clone()
    transp[row], refr_index[row] = True, refr
    return sc.replace(transp=transp, refr_index=refr_index, pointsets=(
        sc.pointsets[0].replace(transparent=True),))


HOST_TIMED = (('pointset', '_cull_spheres'), ('pointset', '_entry_slots'),
              ('pointset', '_union_slots'), ('pointset', '_reroute_entry'),
              ('pointset', '_reroute_union'), ('cluster', '_cull'))


@contextlib.contextmanager
def host_timers():
    """Time each call of the HOST_TIMED functions on the host clock, the
    card synchronized before and after it (the particle tier's steps and
    the mesh culls); restored on exit.  Yields {name: [seconds, calls]}
    (a nested call counts in both)."""
    import torch
    from pathtracer_tpu_torch.ops import cluster as cl
    from pathtracer_tpu_torch.scene import pointset as tps
    mods = {'pointset': tps, 'cluster': cl}
    acc, saved = {}, []
    for mod_name, name in HOST_TIMED:
        mod = mods[mod_name]
        f = getattr(mod, name)
        saved.append((mod, name, f))
        acc[name] = [0.0, 0]

        def g(*a, _f=f, _rec=acc[name], **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _f(*a, **k)
            torch.cuda.synchronize()
            _rec[0] += time.perf_counter() - t0
            _rec[1] += 1
            return out

        setattr(mod, name, functools.wraps(f)(g))
    try:
        yield acc
    finally:
        for mod, name, f in reversed(saved):
            setattr(mod, name, f)


def fluid_waves(sc, cam, card, waves, what, profile=False):
    """`sc` at 1920x1080, 1 sample per wave, 3 bounces, compaction: one
    warm-up, `waves` waves timed one by one (every kernel's launches
    counted over them; the particle sweeps' packets,
    overflows and rerouted lanes from pointset.SWEEP_LOG), the warm-up
    split on the host clock by host_timers; with `profile` the warm-up's
    sweeps recorded and held bit for bit, and one more wave under
    torch.profiler split into FLUID_LABELS."""
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.scene import pointset as tps
    cfg = pt.RenderConfig(width=W, height=H, nrays=16, nb_bounces=BOUNCES,
                          samples_per_wave=1, compact_rays=True)
    r = pt.Renderer(sc, cam, cfg)
    rep = {}
    with host_timers() as split_s:
        if profile:
            with recorded_sweeps() as (closest, anyhit):
                warm = timed(r.step)[1]
        else:
            warm = timed(r.step)[1]
    if profile:
        rep['sweeps_held'] = hold_sweeps(closest, anyhit, what)
        del closest, anyhit
    rep['warmup_host_split'] = {k: dict(seconds=v[0], calls=v[1])
                                for k, v in split_s.items()}
    counted = launch_counts()
    tps.SWEEP_LOG = []
    rays0, ms = r.rays_traced, []
    try:
        for _ in range(waves):
            ms.append(timed(r.step)[1])
    finally:
        sweeps, tps.SWEEP_LOG = tps.SWEEP_LOG, None
    launches = launches_since(counted)
    img = r.display().cpu().numpy()
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError(f'{what} image not finite / wrong shape')
    region = img[int(H * 0.2):int(H * 0.6), int(W * 0.35):int(W * 0.65)]
    if not region.mean() > 0.02 or not region.std() > 0.01:
        raise AssertionError(f'{what}: the fluid region is not lit')
    for name in ('cluster_sweep_closest', 'cluster_sweep_any',
                 'pcg_draw'):
        if launches[name] <= 0:
            raise AssertionError(f'{name} never launched on {what}')
    if not sweeps:
        raise AssertionError(f'{what}: no clustered particle sweep ran')
    kinds = collections.Counter(e['kind'] for e in sweeps)
    rep.update(warmup_ms=warm, ms_per_wave=spread(ms),
               live_rays_per_s=(r.rays_traced - rays0) / (sum(ms) / 1e3),
               launches_per_wave={k: v / waves for k, v in launches.items()},
               particle_sweeps_per_wave={k: v / waves
                                         for k, v in kinds.items()},
               particle_packets_per_wave=sum(e['packets'] for e in sweeps)
               / waves,
               overflowed_packets_per_wave=sum(e['overflowed']
                                               for e in sweeps) / waves,
               rerouted_lanes_per_wave=sum(e['residual'] for e in sweeps)
               / waves,
               slot_steps_per_wave=sum(e['slots'] for e in sweeps) / waves,
               image_mean=float(img.mean()))
    if profile:
        t0 = time.perf_counter()
        split, busy, n_kern, inclusive = profile_split(r, FLUID_LABELS)
        rep.update(profiled_split_ms=split, profiled_inclusive_ms=inclusive,
                   profiled_busy_ms=busy, profiled_kernels=n_kern,
                   profile_seconds=time.perf_counter() - t0)
    log(f'{what} {W}x{H}, {sc.meshes[0].n_tris} tris + '
        f'{sc.pointsets[0].num_points} particle slots, 3 bounces, '
        f'compaction ({card}): warm-up {warm:.1f} ms; ms per '
        f'wave median {rep["ms_per_wave"]["median"]:.1f} (min {min(ms):.1f},'
        f' max {max(ms):.1f}); {rep["live_rays_per_s"]:.4g} live rays/s; '
        f'launches per wave {rep["launches_per_wave"]}; particle sweeps per '
        f'wave {rep["particle_sweeps_per_wave"]}, packets '
        f'{rep["particle_packets_per_wave"]:.0f}, overflowed '
        f'{rep["overflowed_packets_per_wave"]:.0f}, rerouted lanes '
        f'{rep["rerouted_lanes_per_wave"]:.0f}, slot steps '
        f'{rep["slot_steps_per_wave"]:.0f}')
    log(f'  warm-up on the host clock (card synchronized around each call): '
        + ', '.join(f'{k} {v["seconds"]:.2f} s in {v["calls"]} calls'
                    for k, v in rep['warmup_host_split'].items()))
    if profile:
        log(f'  profiled wave (torch.profiler, device time): '
            + ', '.join(f'{k} {v:.1f} ms' for k, v in split.items())
            + '; launched inside each range: '
            + ', '.join(f'{k} {v:.1f} ms' for k, v in inclusive.items())
            + f'; all {n_kern} kernels {busy:.1f} ms, busy '
            f'{busy / rep["ms_per_wave"]["median"]:.3f} of the median wave; '
            f'sweeps held {rep["sweeps_held"]}')
    return launches, rep


def gallery_fluid(dev):
    """scripts/gallery_fluid_colored.py's fluid: a 24^3 grid, seeded from
    a checker sphere_mesh(28, 28, radius=6) with 18,000 particles on
    `dev`.  Returns (cfg, state, colours)."""
    from pathtracer_tpu_torch.scene import scene as scn
    from pathtracer_tpu_torch.sim import fluid as fl
    from pathtracer_tpu_torch.utils import procgen
    cfg = fl.FluidConfig(lo=(-12.0, -26.0, -12.0), hi=(12.0, -2.0, 12.0),
                         nx=24, ny=24, nz=24, dt=FLUID_DT,
                         nsubsteps=FLUID_SUBSTEPS)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(
        procgen.sphere_mesh(28, 28, radius=6.0), translation=(0.0, -10.0, 0.0),
        textures={'kd': checker(128, (0.9, 0.35, 0.15), (0.2, 0.45, 0.9))}))
    pts, cols = fl.seed_from_object(cfg, objs, 3, 18000, device=dev)
    return cfg, fl.reclassify(cfg, fl.init_state(cfg, pts, device=dev)), cols


def write_cloud(path, n=20000, seed=MAT_SEED):
    """A bumpy coloured sheet facing the camera as an XYZ file (x y z r g
    b, colours 0-255), made with numpy; its columns for load_xyz."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-20.0, 20.0, n)
    y = rng.uniform(-27.0, -3.0, n)
    z = 2.5 * np.sin(x * 0.4) * np.cos((y + 15.0) * 0.3)
    rgb = np.stack([128 + 100 * np.sin(x * 0.2), 128 + 100 * np.cos(y * 0.3),
                    np.full(n, 90.0)], -1)
    np.savetxt(path, np.concatenate([np.stack([x, y, z], -1), rgb], 1),
               fmt='%.5f')
    return [0, 1, 2, 6, 7, 8]


def write_yarns(path, n_yarns=60, n_points=100):
    """A woven patch of polylines as a .yarn file (scaled x50 on load),
    made with numpy: half along x, half along y, in front of the slate."""
    lines = [str(n_yarns)]
    s = np.linspace(-0.4, 0.4, n_points)
    for k in range(n_yarns):
        c = -0.4 + 0.8 * (k // 2) / (n_yarns // 2 - 1)
        wave = 0.01 * np.sin(s * 120 + k)
        if k % 2 == 0:
            pts = np.stack([s, c * 0.5 - 0.3 + 0 * s, wave], -1)
        else:
            pts = np.stack([c + 0 * s, s * 0.5 - 0.3, -wave], -1)
        lines.append(str(n_points))
        lines += [f'{a:.6f} {b:.6f} {cc:.6f}' for a, b, cc in pts]
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')


def small_point_scenes(dev, d, fluid_pts, fluid_cols):
    """The card-vs-CPU scenes on the default slate, on `dev`: a disk cloud
    (load_xyz of write_cloud's file, normals and radii estimated), the
    yarns of write_yarns, and the gallery fluid's particles as opaque and
    as transparent spheres (clustered)."""
    from pathtracer_tpu_torch.scene import pointset as tps
    from pathtracer_tpu_torch.scene import scene as scn
    xyz, yarn = os.path.join(d, 'cloud.xyz'), os.path.join(d, 'w.yarn')
    cols = write_cloud(xyz)
    write_yarns(yarn)
    li = scn.default_light_intensity()
    out = {}
    cloud = tps.make_pointset(xyz, cols=cols, centered=False, device=dev)
    for name, obj in (
            ('disks', scn.pointset_object(cloud, ks=(0.2, 0.2, 0.2))),
            ('yarns', scn.yarn_object(yarn, kd=(0.8, 0.6, 0.2))),
            ('fluid', scn.pointset_object(tps.fluid_pointset(
                fluid_pts, radius=0.55, color=fluid_cols, device=dev))),
            ('transparent', scn.pointset_object(tps.fluid_pointset(
                fluid_pts, radius=0.55, color=fluid_cols, device=dev),
                transp=True, refr_index=1.33))):
        out[name] = scn.build_scene(scn.default_objects() + [obj], li,
                                    device=dev)
    if out['fluid'].pointsets[0].n_clusters == 0 \
            or not out['transparent'].pointsets[0].transparent:
        raise AssertionError('the small fluid is not on the clustered tier')
    return out


def small_wave(sc, cam, name, card):
    """One warm-up and one timed wave of `sc` at FLUID_SMALL, 3 bounces,
    compaction; the image finite and lit."""
    import pathtracer_tpu_torch as pt
    w, h = FLUID_SMALL
    r = pt.Renderer(sc, cam, pt.RenderConfig(
        width=w, height=h, nrays=2, nb_bounces=BOUNCES, samples_per_wave=1,
        compact_rays=True))
    r.step()
    ms = timed(r.step)[1]
    img = r.display().cpu().numpy()
    if not np.isfinite(img).all() or not img.mean() > 0.02:
        raise AssertionError(f'{name} {w}x{h} image not finite / not lit')
    log(f'{name} {w}x{h} wave ({card}): {ms:.1f} ms')
    return ms


def fluid_card_vs_cpu(dev, cam, card):
    """The gallery fluid for one frame of FLUID_SUBSTEPS substeps on the
    card and on the CPU from one seeded state (particles within
    FLUID_CPU_TOL of the extent, cell types on >= 99.9% of cells); the
    disk cloud, the yarns and the gallery fluid's last frame, opaque and
    transparent, at 64x48 on the card against the CPU plain path; the
    disk cloud's and the yarns' timed FLUID_SMALL waves."""
    import tempfile
    import torch
    from pathtracer_tpu_torch.sim import fluid as fl
    cfg, st, cols = gallery_fluid(dev)
    out = {}
    for name, s in (('cuda', st), ('cpu', fl.FluidState(
            *(x.cpu() for x in st)))):
        out[name] = fl.run(cfg, s, 1)
    ext = max(h - l for l, h in zip(cfg.lo, cfg.hi))
    err = float(np.abs(out['cuda'][1][-1] - out['cpu'][1][-1]).max()) / ext
    same_ct = float((out['cuda'][0].celltypes.cpu()
                     == out['cpu'][0].celltypes).float().mean())
    check_frames(cfg, out['cuda'][1], st.particles.shape[0], 'gallery fluid')
    if err > FLUID_CPU_TOL or same_ct < 0.999:
        raise AssertionError(f'gallery fluid card vs CPU: particles '
                             f'{err:.3g} of the extent, cell types '
                             f'{same_ct:.5f}')
    rep = dict(sim=dict(particles=int(st.particles.shape[0]),
                        max_err_of_extent=err, celltypes_equal=same_ct))
    log(f'gallery fluid 24^3, {st.particles.shape[0]} particles, one frame '
        f'of {FLUID_SUBSTEPS} substeps, card vs CPU: particles within '
        f'{err:.3g} of the extent, cell types equal on {same_ct:.5f}')
    with tempfile.TemporaryDirectory() as d:
        scenes = small_point_scenes(dev, d, out['cuda'][1][-1], cols)
    flips = {name: card_vs_cpu(s, f'point scene {name}')
             for name, s in scenes.items()}
    rep['flipped'] = flips
    rep['small_wave_ms'] = {name: small_wave(scenes[name], cam, name, card)
                            for name in ('disks', 'yarns')}
    rep['small_counts'] = dict(disks=scenes['disks'].pointsets[0].num_points,
                               yarn_segments=scenes['yarns'].yarns[0]
                               .num_segments)
    del scenes
    torch.cuda.empty_cache()
    return rep


def fluid_phase(dev, cam, card):
    """Scene F: the fluid simulated at FLUID_N^3 (fluid_sim) and rendered
    at 1080p on the main path's sphere, opaque (fluid_waves with the held
    wave and the profiled split) and transparent; the particle tier held
    against brute force on the card (particle_hold); the small card-vs-CPU
    checks (fluid_card_vs_cpu).  Returns the launches of the opaque waves
    and the phase's numbers."""
    import torch
    steps = {}
    t0 = time.perf_counter()

    def step(name):
        nonlocal t0
        steps[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    solids = solid_objects()
    step('solid_mesh')
    frames, cols, sim = fluid_sim(dev, solids, card)
    step('simulation')
    sc = fluid_scene_f(solids, frames, cols, dev)
    ps = sc.pointsets[0]
    step('build')
    log(f'scene F build {steps["build"]:.1f} s: {sc.meshes[0].n_tris} tris, '
        f'{ps.num_points} particle slots in {ps.n_clusters} clusters, '
        f'backface cull {sc.meshes[0].backface_cull}')
    if not ps.n_clusters:
        raise AssertionError('scene F is not on the clustered tier')
    launches, opaque = fluid_waves(sc, cam, card, FLUID_WAVES, 'scene F',
                                   profile=True)
    step('opaque_waves')
    hold = particle_hold(ps, cam, dev)
    step('particle_hold')
    _, transp = fluid_waves(transparent(sc), cam, card, FLUID_T_WAVES,
                            'scene F transparent')
    if not transp['particle_sweeps_per_wave'].get('union'):
        raise AssertionError('the transparent fluid ran no union walk')
    step('transparent_waves')
    del sc, ps
    torch.cuda.empty_cache()
    small = fluid_card_vs_cpu(dev, cam, card)
    step('card_vs_cpu')
    log('fluid phase steps (s): '
        + ', '.join(f'{k} {v:.1f}' for k, v in steps.items()))
    return launches, dict(simulation=sim, opaque=opaque, transparent=transp,
                          particle_hold=hold, small=small, seconds=steps)


TRAIN_SPP = 2           # the train step's samples per pixel at 1080p
TRAIN_LR = 100.0        # its SGD rate: the HDR image's MSE is about 1e-5
                        # and its kd gradient about 1e-4, so lr 100 moves
                        # kd by about 1e-2 a step (the loss falls about 1%
                        # a step on a CPU rehearsal at 96x54)
TRAIN_TARGET_KD = [0.8, 0.3, 0.2]   # the ground plane's kd in the target
TRAIN_SMALL = (480, 270)    # the two-process world-size check
TRAIN_RANKS = 2             # processes sharing the card (gloo)
C2_FLIPPED = 1e-4           # C2's image against the unsharded routed one:
C2_MEAN_REL = 1e-6          # share of samples beyond 1e-3 and mean rel
                            # (0 and <= 9.9e-9 measured on an H100)
KPCN_SCENES = 2             # the trainer's scenes (+ 1 held out; 10 + 1 in
KPCN_STEPS = 100            # the script), steps (1500) and target spp (128)
KPCN_SPP_TGT = 64
WORKER_TIMEOUT = 300        # seconds a rank process may take


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def hdr_target(sc, cam, cp, cfg, mesh):
    """The HDR image (make_train_step's loss space) of sc with the ground
    plane's kd set to TRAIN_TARGET_KD."""
    import torch
    from pathtracer_tpu_torch.parallel import sharding
    from pathtracer_tpu_torch.render import film as film_mod
    kd = sc.kd.clone()
    kd[2] = torch.tensor(TRAIN_TARGET_KD, device=kd.device)
    film = film_mod.make_film(cfg.width, cfg.height, cfg.sigma_filter,
                              device=sc.device)
    with torch.no_grad():
        img, cnt = sharding.make_sharded_render(mesh, cfg)(
            sc.replace(kd=kd), cam, cp)
    return film_mod.crop(film, img) / film_mod.RADIANCE_SCALE \
        / torch.clamp_min(film_mod.crop(film, cnt), 1e-9)[..., None]


def train_params(sc):
    return {k: getattr(sc, k).clone() for k in ('kd', 'ks',
                                                'light_intensity')}


def grads_agree(got, want, what):
    """tests/test_torch_grad.py's rule: every leaf within 5e-4 of its
    largest |grad|."""
    for k, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(np.asarray(got[k]) - w).max())
        if err > 5e-4 * max(float(np.abs(w).max()), 1e-30):
            raise AssertionError(f'{what}: gradient of {k} differs by {err:.3g}'
                                 f' (largest |grad| {np.abs(w).max():.3g})')


def spawn_ranks(world, d):
    """Run `chip_smoke.py --worker rank world init d` (rank_worker) in
    `world` processes sharing the card (gloo); each must end within
    WORKER_TIMEOUT s, and all are killed otherwise.  Returns each rank's
    results."""
    init = os.path.join(d, 'ranks.init')
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--worker', str(r),
         str(world), init, d], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f'rank {r} exited {p.returncode}:\n'
                                 f'{out[-4000:]}')
        for line in out.strip().splitlines()[-4:]:
            log(f'  [rank {r}] {line}')
    return [dict(np.load(os.path.join(d, f'ranks_out_r{r}.npz')))
            for r in range(world)]


def rank_worker(argv):
    """One rank of the training phase's checks B, C and C2 (spawn_ranks):
    joins a gloo group; B: loads the scene from the parent's file, the
    loss and gradients at dp = world; C and C2: loads its partition, then
    its routed partition, one wave each at dp = 1 x scene = world
    (scene_rank).  Writes one npz."""
    import torch
    from pathtracer_tpu_torch.parallel import distributed as pd
    from pathtracer_tpu_torch.parallel import sharding
    rank, world, init, d = argv
    rank, world = int(rank), int(world)
    pd.init_multihost(f'file://{init}', world, rank, backend='gloo')

    def load(kind):
        blob = torch.load(os.path.join(d, f'{kind}_r{rank}.pt'),
                          weights_only=False)
        return blob, blob['sc'], blob['cam'], blob['cp'], blob['cfg']

    blob, sc, cam, cp, cfg = load('world')
    fn = sharding.make_loss_and_grads(sharding.make_mesh(dp=world), cfg)
    params = train_params(sc)
    fn(params, sc, cam, cp, blob['target'])                  # warm-up
    (loss, grads), ms = timed(lambda: fn(params, sc, cam, cp,
                                         blob['target']))
    out = dict(world_loss=float(loss), world_ms=ms,
               **{f'world_grad_{k}': g.cpu().numpy()
                  for k, g in grads.items()})
    print(f'loss and gradients at {cfg.width}x{cfg.height}: {ms:.1f} ms '
          f'(two processes on one card)', flush=True)
    del blob, sc, fn, params, grads
    torch.cuda.empty_cache()

    mesh = sharding.make_mesh(dp=1, scene=world)
    for kind in ('scene', 'routed'):
        out.update({f'{kind}_{k}': v for k, v in scene_rank(
            load(kind)[1:], mesh, f'{kind} shard {rank}').items()})
        torch.cuda.empty_cache()
    np.savez(os.path.join(d, f'ranks_out_r{rank}.npz'), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def lean(sc):
    """sc without the host copy of its mesh's triangles (oracles only)."""
    m = sc.meshes[0]
    return sc.replace(meshes=(m.replace(clustered=dataclasses.replace(
        m.clustered, host_tris=None)),) + sc.meshes[1:])


def train_step_phase(sc, cam, card):
    """A: make_train_step at 1920x1080 x TRAIN_SPP on the main path's scene
    at world 1 (NCCL), three steps toward hdr_target: the loss must fall
    and both sweeps launch in the forward and in the recompute.  Returns
    the launches and the numbers."""
    import unittest.mock as mock
    import torch
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.core import rng_host
    from pathtracer_tpu_torch.parallel import sharding
    dev = sc.device
    mesh = sharding.make_mesh(dp=1, sp=1)
    cfg = pt.RenderConfig(width=W, height=H, nrays=TRAIN_SPP,
                          nb_bounces=BOUNCES, compact_rays=True,
                          remat_samples=True)
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(W, H), device=dev)
    target = hdr_target(sc, cam, cp, cfg, mesh)
    step = sharding.make_train_step(mesh, cfg, lr=TRAIN_LR)
    params = train_params(sc)
    orig_grad = torch.autograd.grad
    split = []

    def counted_grad(*a, **kw):
        before = launch_counts()
        out = orig_grad(*a, **kw)
        split.append(({k: before[k] - base[k] for k in before},
                      launches_since(before)))
        return out

    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    counted = launch_counts()
    for _ in range(3):
        base = launch_counts()
        with mock.patch.object(torch.autograd, 'grad', counted_grad):
            (loss, params), t = timed(lambda: step(params, sc, cam, cp,
                                                   target))
        losses.append(float(loss))
        ms.append(t)
    launches = launches_since(counted)
    peak = torch.cuda.max_memory_allocated()
    fwd, rec = split[0]
    for name in ('cluster_sweep_closest', 'cluster_sweep_any', 'hier_cull',
                 'pcg_draw'):
        if fwd[name] <= 0 or rec[name] <= 0:
            raise AssertionError(f'train step: {name} launched {fwd[name]} '
                                 f'times in forward, {rec[name]} in the '
                                 f'recompute')
    if not losses[2] < losses[0]:
        raise AssertionError(f'the train step\'s loss did not fall: {losses}')
    log(f'train step 1080p x {TRAIN_SPP} spp, 2.4M tris, {BOUNCES} bounces, '
        f'compaction, remat, world 1 (nccl), lr {TRAIN_LR} toward ground kd '
        f'{TRAIN_TARGET_KD} ({card}): ms per step '
        f'{", ".join(f"{x:.1f}" for x in ms)}; loss '
        f'{", ".join(f"{x:.6g}" for x in losses)}; peak memory '
        f'{peak / 2**30:.2f} GiB; sweep launches a step in forward '
        f'{fwd}, in the recompute {rec}; ground kd {params["kd"][2].tolist()}')
    return launches, fwd, rec, dict(ms=ms, loss=losses, peak_bytes=int(peak),
                                    lr=TRAIN_LR)


def world_inputs(sc, cam, d):
    """B's inputs for the ranks (the scene, TRAIN_SMALL rays, the target)
    and the one-process loss and gradients they must give."""
    import torch
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.core import rng_host
    from pathtracer_tpu_torch.parallel import sharding
    w, h = TRAIN_SMALL
    cfg = pt.RenderConfig(width=w, height=h, nrays=TRAIN_SPP,
                          nb_bounces=BOUNCES)
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(w, h),
                         device=sc.device)
    mesh = sharding.make_mesh(dp=1, sp=1)
    target = hdr_target(sc, cam, cp, cfg, mesh)
    fn = sharding.make_loss_and_grads(mesh, cfg)
    fn(train_params(sc), sc, cam, cp, target)                  # warm-up
    (loss, grads), ms = timed(lambda: fn(train_params(sc), sc, cam, cp,
                                         target))
    blob = dict(sc=lean(sc), cam=cam, cp=cp, cfg=cfg, target=target)
    for r in range(TRAIN_RANKS):
        torch.save(blob, os.path.join(d, f'world_r{r}.pt'))
    return dict(loss=float(loss), ms=ms,
                grads={k: g.cpu().numpy() for k, g in grads.items()})


def world_check(ref, outs, card):
    """B: the loss and gradients at TRAIN_SMALL with dp = TRAIN_RANKS
    processes sharing the card over gloo equal the one-process step's."""
    for r, o in enumerate(outs):
        if abs(float(o['world_loss']) - ref['loss']) > 1e-5 * ref['loss']:
            raise AssertionError(f'rank {r} loss {float(o["world_loss"])} '
                                 f'against {ref["loss"]}')
        grads_agree({k: o[f'world_grad_{k}'] for k in ref['grads']},
                    ref['grads'], f'rank {r}')
    ms2 = [float(o['world_ms']) for o in outs]
    w, h = TRAIN_SMALL
    log(f'world-size check {w}x{h} x {TRAIN_SPP} spp ({card}): dp = '
        f'{TRAIN_RANKS} (gloo, two processes on one card) loss and gradients '
        f'equal one process\'s; step {ref["ms"]:.1f} ms in one process, '
        f'{", ".join(f"{x:.1f}" for x in ms2)} ms in the two (two processes '
        f'on one card: says nothing of scaling across cards)')
    return dict(one_process_ms=ref['ms'], two_process_ms=ms2,
                loss=ref['loss'])


def scene_inputs(sc, cam, d):
    """C's inputs: the 2.4M-tri mesh in TRAIN_RANKS partitions
    (shard_clustered_mesh here, one file a rank) and the unsharded 1080p x
    1 spp wave they must give.  The mesh's backface cull is off on both
    sides: with it on, a bounce ray that starts a float error inside the
    surface and meets a back face is hit or not by its packet's other rays
    (the cull keeps a cluster that any ray of the packet may see), and a
    partition's packets cull against other clusters and another root box
    (2 of 129,600 lanes at 480x270 on a 500 x 500 sphere, CPU); the
    combine itself is exact."""
    import pathtracer_tpu_torch as pt
    cfg = pt.RenderConfig(width=W, height=H, nrays=1, nb_bounces=BOUNCES)
    return partition_inputs(
        sc.replace(meshes=(sc.meshes[0].replace(backface_cull=False),)),
        cam, cfg, d, 'scene')


def scene_check(ref, outs, card):
    """C: one 1080p wave of 1 spp through make_sharded_render at dp = 1 x
    scene = TRAIN_RANKS against the unsharded render: counts exactly, the
    image within rtol = atol = 1e-5; both sweeps launch on every rank and
    their first launches equal the plain version bit for bit."""
    img, cnt = ref['image'], ref['count']
    for r, o in enumerate(outs):
        if not np.array_equal(o['scene_count'], cnt):
            raise AssertionError(f'scene rank {r}: counts differ')
        bad = ~np.isclose(o['scene_image'], img, rtol=1e-5, atol=1e-5)
        if bad.any():
            px = np.argwhere(bad.any(-1))
            raise AssertionError(
                f'scene rank {r}: image differs beyond 1e-5 at {len(px)} '
                f'pixels, e.g. {px[:8].tolist()}: '
                f'{o["scene_image"][bad][:8]} against {img[bad][:8]}')
    per_rank = rank_numbers(outs, 'scene')
    log(f'scene axis 1080p x 1 spp, {BOUNCES} bounces, backface cull off, '
        f'2.4M tris in {TRAIN_RANKS} partitions of {ref["c_pad"]} cluster '
        f'slots, rows {ref["rows"]} ({card}): unsharded wave '
        f'{ref["ms"]:.1f} ms; per rank (gloo, two processes on one card) '
        f'{per_rank}; counts equal, image within 1e-5')
    return dict(unsharded_ms=ref['ms'], ranks=per_rank, rows=ref['rows'],
                c_pad=ref['c_pad'])


def scene_rank(inputs, mesh, what):
    """C or C2 on one rank: one wave of its partition at dp = 1 x scene =
    world, both sweeps recorded and held, the collectives, the routed
    queries (ROUTE_LOG) and the residual net timed.  Returns the numbers
    and the film."""
    import torch
    from pathtracer_tpu_torch.ops import routed_cluster as rc
    from pathtracer_tpu_torch.parallel import distributed as pd
    from pathtracer_tpu_torch.parallel import sharding
    sc, cam, cp, cfg = inputs
    render = sharding.make_sharded_render(mesh, cfg)
    counted = launch_counts()
    pd.COLLECTIVE_LOG, rc.ROUTE_LOG = [], []
    with recorded_sweeps() as (closest, anyhit), net_timer() as net, \
            torch.no_grad():
        (img, cnt), ms = timed(lambda: render(sc, cam, cp))
    coll, pd.COLLECTIVE_LOG = pd.COLLECTIVE_LOG, None
    route, rc.ROUTE_LOG = route_numbers(rc.ROUTE_LOG), None
    n = launches_since(counted)
    held = hold_sweeps(closest, anyhit, what, picks=(0,))
    coll_ms = 1e3 * sum(sec for _, sec, _ in coll)
    out = dict(image=img.cpu().numpy(), count=cnt.cpu().numpy(), ms=ms,
               closest=n['cluster_sweep_closest'],
               any=n['cluster_sweep_any'], pcg_draw=n['pcg_draw'],
               held=held['held'],
               collective_ms=coll_ms, collectives=len(coll),
               collective_bytes=sum(b for _, _, b in coll),
               run_packets=route['run_packets'],
               residual_lanes=route['residual_lanes'],
               route_calls=route['calls'],
               net_ms=net[0] * 1e3, net_calls=net[1], net_lanes=net[2])
    routed = (f'; run packets {route["run_packets"]}, residual lanes '
              f'{route["residual_lanes"]}, the net '
              f'{out["net_ms"]:.1f} ms on {net[2]} lanes in {net[1]} calls'
              if route['calls'] else '')
    print(f'{what}: 1080p wave {ms:.1f} ms, sweep launches {out["closest"]} '
          f'+ {out["any"]}, the first of each bit-equal{routed}; '
          f'{len(coll)} collectives {coll_ms:.1f} ms on the host clock, '
          f'{out["collective_bytes"] / 2**20:.1f} MiB in', flush=True)
    return out


def rank_numbers(outs, kind):
    """Each rank's scene_rank numbers of `kind` ('scene', 'routed'), and
    fails unless both sweeps launched and their first launches were
    held."""
    per_rank = []
    for r, o in enumerate(outs):
        o = {k[len(kind) + 1:]: v for k, v in o.items()
             if k.startswith(kind + '_')}
        if o['closest'] <= 0 or o['any'] <= 0 or o['held'] < 2:
            raise AssertionError(f'{kind} rank {r}: sweeps {o["closest"]} + '
                                 f'{o["any"]}, {o["held"]} held')
        rec = dict(ms=float(o['ms']), closest=int(o['closest']),
                   any=int(o['any']), pcg_draw=int(o['pcg_draw']),
                   collective_ms=float(o['collective_ms']),
                   collectives=int(o['collectives']),
                   collective_bytes=int(o['collective_bytes']))
        if kind == 'routed':
            rec.update(run_packets=[int(x) for x in o['run_packets']],
                       residual_lanes=[int(x) for x in o['residual_lanes']],
                       net_ms=float(o['net_ms']),
                       net_calls=int(o['net_calls']),
                       net_lanes=int(o['net_lanes']))
        per_rank.append(rec)
    return per_rank


def partition_inputs(sc, cam, cfg, d, kind):
    """The unsharded 1080p x 1 spp wave of sc by cfg (its net timed), and
    sc's mesh in TRAIN_RANKS partitions, one file a rank
    (`{kind}_r{rank}.pt`).  Returns the reference."""
    import torch
    from pathtracer_tpu_torch.core import rng_host
    from pathtracer_tpu_torch.ops import routed_cluster as rc
    from pathtracer_tpu_torch.parallel import scene_shard, sharding
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(W, H),
                         device=sc.device)
    render = sharding.make_sharded_render(sharding.make_mesh(dp=1, sp=1), cfg)
    rc.ROUTE_LOG = []
    with net_timer() as net, torch.no_grad():
        (img, cnt), ms = timed(lambda: render(sc, cam, cp))
    route, rc.ROUTE_LOG = route_numbers(rc.ROUTE_LOG), None
    shards = scene_shard.shard_clustered_mesh(sc.meshes[0], TRAIN_RANKS)
    for r, m in enumerate(shards):
        torch.save(dict(sc=lean(sc).replace(meshes=(m,)), cam=cam, cp=cp,
                        cfg=cfg), os.path.join(d, f'{kind}_r{r}.pt'))
    ref = dict(image=img.cpu().numpy(), count=cnt.cpu().numpy(), ms=ms,
               net_ms=net[0] * 1e3, net_calls=net[1], net_lanes=net[2],
               route_calls=route['calls'],
               residual_lanes=route['residual_lanes'],
               rows=[m.shard_rows for m in shards],
               c_pad=shards[0].n_clusters)
    del shards
    torch.cuda.empty_cache()
    return ref


def routed_scene_inputs(sc, cam, d):
    """C2's inputs (partition_inputs): the main path's sphere uploaded
    routed (routed_scene), backface cull off as in C, in partitions that
    keep the whole soup and BVH, rendered with compaction as R2: without
    it the dead lanes of a bounce miss in overflowed packets and stay
    residual (about 1.3M lanes of a wave, 31 s of the net on an H100)."""
    import pathtracer_tpu_torch as pt
    t0 = time.perf_counter()
    rsc = routed_scene(sc, sc.device)
    m = rsc.meshes[0].replace(backface_cull=False)
    upload_s = time.perf_counter() - t0
    cfg = pt.RenderConfig(width=W, height=H, nrays=1, nb_bounces=BOUNCES,
                          compact_rays=True)
    ref = partition_inputs(rsc.replace(meshes=(m,)), cam, cfg, d, 'routed')
    return dict(ref, upload_s=upload_s, clusters=m.n_clusters)


def net_matches_residual(what, calls, net_calls, residual, net_lanes):
    """Fails unless the routed queries' residual lanes were netted: one
    bvh_hit_sparse call a routed_hit call, on as many lanes as it left
    residual."""
    if net_calls != calls or net_lanes != sum(residual):
        raise AssertionError(
            f'{what}: {calls} routed queries left {sum(residual)} residual '
            f'lanes, but {net_calls} nets ran on {net_lanes} lanes')


def routed_scene_check(ref, outs, card):
    """C2: the routed partitions' 1080p x 1 spp wave at dp = 1 x scene =
    TRAIN_RANKS: the ranks' images and counts bit-equal to each other;
    against the unsharded routed render the counts equal and the image
    within the per-sample rule and within C2_FLIPPED / C2_MEAN_REL (a
    lane the net resolves on one side only takes the net's t formula
    there; a skipped or misplaced net shows in the net counts, since too
    few lanes change for the image); on every rank and unsharded, each
    routed query's residual lanes netted, and some residual lanes on
    both sides; both sweeps launch on every rank, their first launches
    equal the plain versions."""
    for r, o in enumerate(outs):
        for k in ('image', 'count'):
            if not np.array_equal(o[f'routed_{k}'], outs[0][f'routed_{k}']):
                raise AssertionError(f'routed scene rank {r}: {k} differs '
                                     f'from rank 0\'s')
        if not np.array_equal(o['routed_count'], ref['count']):
            raise AssertionError(f'routed scene rank {r}: counts differ')
    a, b = outs[0]['routed_image'], ref['image']
    what = 'routed scene ranks vs unsharded 1080p'
    image = samples_agree(a, b, what)
    image['max_rel'] = float((np.abs(a - b).max(-1)
                              / max(float(np.abs(b).max()), 1e-6)).max())
    if image['flipped'] > C2_FLIPPED or image['mean_rel'] > C2_MEAN_REL:
        raise AssertionError(f'{what}: {image} beyond {C2_FLIPPED} flipped '
                             f'or {C2_MEAN_REL} mean rel')
    per_rank = rank_numbers(outs, 'routed')
    net_matches_residual('unsharded routed wave', ref['route_calls'],
                         ref['net_calls'], ref['residual_lanes'],
                         ref['net_lanes'])
    for r, (o, p) in enumerate(zip(outs, per_rank)):
        net_matches_residual(f'routed scene rank {r}',
                             int(o['routed_route_calls']), p['net_calls'],
                             p['residual_lanes'], p['net_lanes'])
    if not (ref['net_lanes'] > 0 and sum(p['net_lanes'] for p in per_rank)):
        raise AssertionError('C2 left no residual lane to net: '
                             f'unsharded {ref["net_lanes"]}, ranks '
                             f'{[p["net_lanes"] for p in per_rank]}')
    log(f'routed scene axis 1080p x 1 spp, {BOUNCES} bounces, compaction, '
        f'backface cull off, 2.4M tris ({ref["clusters"]} clusters) in '
        f'{TRAIN_RANKS} partitions of {ref["c_pad"]} cluster slots, rows '
        f'{ref["rows"]}, soup and BVH on every rank ({card}): upload '
        f'{ref["upload_s"]:.1f} s, unsharded wave {ref["ms"]:.1f} ms (net '
        f'{ref["net_ms"]:.1f} ms on {ref["net_lanes"]} lanes); per rank '
        f'(gloo, two processes on one card) {per_rank}; ranks bit-equal, '
        f'counts equal, every residual lane netted, image vs unsharded '
        f'flipped {image["flipped"]!r}, mean rel {image["mean_rel"]!r}, '
        f'max rel {image["max_rel"]!r}')
    return dict(unsharded_ms=ref['ms'], unsharded_net_ms=ref['net_ms'],
                unsharded_net_lanes=ref['net_lanes'],
                unsharded_residual_lanes=ref['residual_lanes'],
                upload_s=ref['upload_s'], ranks=per_rank, rows=ref['rows'],
                c_pad=ref['c_pad'], image=image)


def kpcn_trainer_phase(dev, card, d):
    """D: the KPCN-lite trainer (scripts/train_denoiser.py) at its crop and
    batch on KPCN_SCENES + 1 scenes (targets at KPCN_SPP_TGT spp) for
    KPCN_STEPS steps: the loss falls,
    the saved file reads back to the same outputs; the denoiser gate
    (scripts/denoiser_eval.py at the JAX test's size) on the shipped
    weights."""
    import torch
    from pathtracer_tpu_torch.render import denoise_net as dnn
    from pathtracer_tpu_torch.scripts import denoiser_eval as de
    from pathtracer_tpu_torch.scripts import train_denoiser as td
    t0 = time.perf_counter()
    data = td.make_dataset(KPCN_SCENES, spp_tgt=KPCN_SPP_TGT, device=dev,
                           log=lambda *a: None)
    t_data = time.perf_counter() - t0
    (model, losses), ms = timed(lambda: td.train(data, KPCN_STEPS,
                                                 log=lambda *a: None))
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not last < first:
        raise AssertionError(f'KPCN trainer: loss {first:.4f} -> {last:.4f}')
    path = os.path.join(d, 'kpcn.npz')
    td.save_weights(model, path)
    back = dnn.load_model(path, device=dev)
    cin, alb, nrm, _ = data[-1]
    if not torch.equal(dnn.denoise_apply(model, cin, alb, nrm),
                       dnn.denoise_apply(back, cin, alb, nrm)):
        raise AssertionError('KPCN weights do not read back to the same '
                             'outputs')
    held = td.held_out_mse(model, data[-1])
    gate = de.evaluate(96, 64, 2, 64, device=dev)
    if not (gate['learned_minus_noisy_db'] > 2.0
            and gate['learned_minus_atrous_db'] > 1.0):
        raise AssertionError(f'denoiser gate: {gate}')
    log(f'KPCN trainer ({card}): {KPCN_SCENES} + 1 scenes at {td.W}x{td.H}, '
        f'{td.SPP_IN} / {KPCN_SPP_TGT} spp, {t_data:.1f} s; {KPCN_STEPS} steps '
        f'of {td.BATCH} x {td.CROP}^2 crops, {ms / KPCN_STEPS:.1f} ms a step; '
        f'loss {first:.4f} -> {last:.4f} (means of the first and last 10); '
        f'held-out log-MSE {held}; gate on the shipped weights at 96x64 '
        f'(2 vs 64 spp): noisy {gate["psnr_noisy_db"]:.2f}, a-trous '
        f'{gate["psnr_atrous_db"]:.2f}, learned {gate["psnr_learned_db"]:.2f}'
        f' dB')
    return dict(dataset_s=t_data, ms_per_step=ms / KPCN_STEPS,
                loss_first10=first, loss_last10=last, held_out=held,
                gate=gate)


def train_phase(sc, cam, card):
    """The training paths (after the gradient phase, on the main path's
    scene): A the train step at 1080p on NCCL (world 1), B the world-size
    check, C the scene axis, C2 the routed scene axis, D the KPCN-lite
    trainer.  Refuses to run without a card.  Returns the sweeps' launches
    on the train step, per scene rank and per routed scene rank, and the
    numbers."""
    import tempfile
    import torch
    from pathtracer_tpu_torch.parallel import distributed as pd
    if not torch.cuda.is_available():
        raise SystemExit('the training phase needs a CUDA device')
    steps = {}
    t0 = time.perf_counter()

    def step(name):
        nonlocal t0
        steps[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    pd.init_multihost(f'localhost:{free_port()}', 1, 0, backend='nccl')
    try:
        launches, fwd, rec, rep_a = train_step_phase(sc, cam, card)
        step('train_step')
        with tempfile.TemporaryDirectory() as d:
            ref_b = world_inputs(sc, cam, d)
            ref_c = scene_inputs(sc, cam, d)
            step('scene_inputs')
            ref_c2 = routed_scene_inputs(sc, cam, d)
            step('routed_scene_inputs')
            outs = spawn_ranks(TRAIN_RANKS, d)
            rep_b = world_check(ref_b, outs, card)
            rep_c = scene_check(ref_c, outs, card)
            rep_c2 = routed_scene_check(ref_c2, outs, card)
            step('world_size_and_scene_axes')
    finally:
        torch.distributed.destroy_process_group()
    with tempfile.TemporaryDirectory() as d:
        rep_d = kpcn_trainer_phase(sc.device, card, d)
    step('kpcn')
    log('train phase steps (s): '
        + ', '.join(f'{k} {v:.1f}' for k, v in steps.items()))
    return (launches, fwd, rec, rep_c['ranks'], rep_c2['ranks'],
            dict(train_step=rep_a, world_size=rep_b, scene_axis=rep_c,
                 routed_scene_axis=rep_c2, kpcn=rep_d, seconds=steps))


DRAWS = ('make_stream', 'next_uniform', 'next_uniform2')


@contextlib.contextmanager
def counted_draws():
    """Count the calls of core/rng.py's three draw wrappers and of their
    plain versions while it stands: yields a Counter by name."""
    from pathtracer_tpu_torch.core import rng as prng
    calls = collections.Counter()
    origs = {n: getattr(prng, n) for n in DRAWS + tuple(
        f'{d}_plain' for d in DRAWS)}

    def stand_in(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f

    for n, fn in origs.items():
        setattr(prng, n, stand_in(n, fn))
    try:
        yield calls
    finally:
        for n, fn in origs.items():
            setattr(prng, n, fn)


@contextlib.contextmanager
def plain_draws():
    """core/rng.py's three draw wrappers replaced by their plain versions
    while it stands (the torch chain on any device)."""
    from pathtracer_tpu_torch.core import rng as prng
    origs = {n: getattr(prng, n) for n in DRAWS}
    for n in DRAWS:
        setattr(prng, n, getattr(prng, f'{n}_plain'))
    try:
        yield
    finally:
        for n, fn in origs.items():
            setattr(prng, n, fn)


def pcg_inputs(n, dev, seed=0):
    """Keys of n lanes as the camera makes them for one sample ((seed,
    lane * 64 + 3), 64 spp, sample 3) and a gate with about half its
    lanes True, from a seeded generator on `dev`."""
    import torch
    key_lo = torch.arange(n, dtype=torch.int64, device=dev) * 64 + 3
    key_hi = torch.full_like(key_lo, seed & 0xFFFFFFFF)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gate = torch.rand(n, generator=gen, device=dev) < 0.5
    return key_hi, key_lo, gate


def pcg_check(key_hi, key_lo, gate):
    """The kernel's seed, gated draw and gated pair against the plain
    versions on the same inputs: True when every half and uniform has the
    same bits."""
    import torch
    from pathtracer_tpu_torch.core import rng as prng
    st = prng.make_stream(key_hi, key_lo)
    ok = all(torch.equal(a, b) for a, b in
             zip(st, prng.make_stream_plain(key_hi, key_lo)))
    for fn, plain in ((prng.next_uniform, prng.next_uniform_plain),
                      (prng.next_uniform2, prng.next_uniform2_plain)):
        k, p = fn(st, gate), plain(st, gate)
        ok = ok and same_bits(k[:-1], p[:-1]) and all(
            torch.equal(a, b) for a, b in zip(k[-1], p[-1]))
    return ok


def pcg_kernel_ms(lib, fn, args, n, dev):
    """Milliseconds a launch of the PCG kernel's C entry `fn` on `args`
    (tensors or None) and n lanes, over PCG_REPS launches straight
    through ctypes (no wrapper, so the host enqueues faster than the card
    runs them)."""
    import torch
    ptrs = [0 if a is None else a.data_ptr() for a in args]
    stream = torch.cuda.current_stream(dev).cuda_stream
    call = getattr(lib, fn)

    def run():
        for _ in range(PCG_REPS):
            if call(*ptrs, n, stream) != 0:
                raise RuntimeError(f'{fn} launch failed')

    return cuda_ms(run) / PCG_REPS


def pcg_phase(dev, cam, card):
    """The PCG32 kernel (csrc/pcg_draw.cu, core/rng.py) on one 1080p
    sample pass of lanes: bit-equal to the plain versions, timed per
    launch beside its bytes bound and the plain chain, the wrappers' own
    time per call; then one sample pass of the flagship at 1080p with the
    draw calls and launches counted (engagement) and its film bit-equal
    to the plain draws'.  Returns the kernel record."""
    import torch
    from pathtracer_tpu_torch.core import rng as prng
    from pathtracer_tpu_torch.ops import binding
    from pathtracer_tpu_torch.render import renderer as rnd
    n = W * H
    key_hi, key_lo, gate = pcg_inputs(n, dev, seed=7)
    agree = pcg_check(key_hi, key_lo, gate)
    odd = pcg_check(*pcg_inputs(n - 1, dev, seed=8))
    if not (agree and odd):
        raise AssertionError('the PCG kernel differs from its plain version')
    st = prng.make_stream(key_hi, key_lo)
    out = [torch.empty_like(key_hi) for _ in range(4)]
    u = [torch.empty(n, device=dev) for _ in range(2)]
    lib = binding.lib('pcg_draw')
    ms = {'draw': pcg_kernel_ms(lib, 'pcg_draw', list(st) + [gate] + out[:2]
                                + [u[0], None], n, dev),
          'pair': pcg_kernel_ms(lib, 'pcg_draw', list(st) + [gate] + out[:2]
                                + u, n, dev),
          'seed': pcg_kernel_ms(lib, 'pcg_seed', [key_hi, key_lo] + out, n,
                                dev)}
    call_ms = {'draw': cuda_ms(lambda: prng.next_uniform(st, gate),
                               reps=PCG_REPS),
               'pair': cuda_ms(lambda: prng.next_uniform2(st, gate),
                               reps=PCG_REPS),
               'seed': cuda_ms(lambda: prng.make_stream(key_hi, key_lo),
                               reps=PCG_REPS)}
    plain_ms = {'draw': cuda_ms(lambda: prng.next_uniform_plain(st, gate),
                                reps=5),
                'pair': cuda_ms(lambda: prng.next_uniform2_plain(st, gate),
                                reps=5),
                'seed': cuda_ms(lambda: prng.make_stream_plain(key_hi,
                                                               key_lo),
                                reps=5)}
    nbytes = {'draw': PCG_DRAW_BYTES * n, 'pair': PCG_PAIR_BYTES * n,
              'seed': PCG_SEED_BYTES * n}
    bound_ms = {k: bound(0, b)[0] for k, b in nbytes.items()}
    sc = flagship_scene(dev)
    cfg = rnd.RenderConfig(width=W, height=H, nrays=64, nb_bounces=BOUNCES,
                           samples_per_wave=1, tile_size=0)
    r = rnd.Renderer(sc, cam, cfg)
    r.step()                                    # warm-up
    torch.cuda.synchronize()
    with counted_draws() as calls:
        before = launch_counts()
        r.step()
        torch.cuda.synchronize()
        launched = launches_since(before)['pcg_draw']
    wrapper_calls = sum(calls[d] for d in DRAWS)
    plain_calls = sum(calls[f'{d}_plain'] for d in DRAWS)
    r_p = rnd.Renderer(sc, cam, cfg)
    with plain_draws():
        r_p.step(2)
    film_equal = same_bits((r.image, r.sample_count),
                           (r_p.image, r_p.sample_count))
    if launched != wrapper_calls or plain_calls or not film_equal:
        raise AssertionError(f'PCG engagement: {launched} launches for '
                             f'{wrapper_calls} draw calls, {plain_calls} '
                             f'plain calls, film equal {film_equal}')
    for k in ms:
        log(f'PCG {k} at {n} lanes: kernel {ms[k] * 1e3:.2f} us a launch '
            f'(bound {bound_ms[k] * 1e3:.2f} us, {nbytes[k] / n:.0f} B a '
            f'lane at {PEAK_BYTES:.3g} B/s: {bound_ms[k] / ms[k]:.1%}), '
            f'{call_ms[k] * 1e3:.2f} us a wrapper call, plain chain '
            f'{plain_ms[k] * 1e3:.1f} us ({card})')
    log(f'PCG engagement, one 1080p flagship sample pass: {launched} '
        f'launches for {wrapper_calls} draw calls ({dict(calls)}), '
        f'{plain_calls} plain calls; film bit-equal to the plain draws\' '
        f'{film_equal}; bit-equal at {n} and {n - 1} lanes')
    rec = entry(
        'pcg_draw', 'pathtracer_tpu_torch/csrc/pcg_draw.cu',
        'none: XLA code, pathtracer_tpu/core/rng.py (no pallas_call)', 0.0,
        1.0, ms['draw'], plain_ms['draw'], 0, nbytes['draw'],
        lanes=n, ms_pair=ms['pair'], ms_seed=ms['seed'],
        plain_ms_pair=plain_ms['pair'], plain_ms_seed=plain_ms['seed'],
        bound_ms_pair=bound_ms['pair'], bound_ms_seed=bound_ms['seed'],
        call_ms=call_ms, launches_per_sample_pass=launched,
        draw_calls_per_sample_pass=wrapper_calls, plain_calls=plain_calls,
        engagement=launched / wrapper_calls, film_equal=film_equal)
    return rec


def build_kernels():
    """One nvcc process per csrc/*.cu source, all started together."""
    from pathtracer_tpu_torch.ops import binding
    logs = {}
    with concurrent.futures.ThreadPoolExecutor(len(binding.LIBS)) as ex:
        futs = [ex.submit(binding.lib, k,
                          log=lambda m, k=k: logs.setdefault(k, m))
                for k in binding.LIBS]
        for f in futs:
            f.result()
    for k, m in logs.items():
        log(f'[{k}] {m.strip()}')


def main():
    import argparse
    if sys.argv[1:2] == ['--worker']:
        return rank_worker(sys.argv[2:])
    ap = argparse.ArgumentParser(description='Smoke run of the PyTorch port '
                                 'on one CUDA card.')
    ap.add_argument('--profile-all', action='store_true',
                    help='also profile a wave of the main path, of scene M '
                    'and of scene O (about 165 s more on an H100)')
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py needs a CUDA device; none found')
    log(f'python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda}')
    card = card_line()
    log(card)
    rate, sms, mhz = issue_rate()
    log(f'fp32 issue rate {rate:.5g} /s = {sms} SMs x 128 x {mhz:.0f} MHz '
        f'(clocks.max.sm): the operations bound of the CUDA-core kernels')
    log(f'dense TF32 rate {tf32_rate():.5g} flop/s = {sms} SMs x '
        f'{TF32_MACS_PER_SM} MACs x 2 x {mhz:.0f} MHz: the TF32 product\'s '
        f'operations bound')
    dev = torch.device('cuda:0')
    import pathtracer_tpu_torch as pt

    t0 = time.perf_counter()
    build_kernels()
    log(f'kernel build {time.perf_counter() - t0:.1f} s')

    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0)).to(dev)
    t0 = time.perf_counter()
    pcg = pcg_phase(dev, cam, card)
    log(f'PCG phase {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    sc, n_tris = big_scene(dev)
    log(f'scene build {time.perf_counter() - t0:.1f} s: {n_tris} tris, '
        f'{sc.meshes[0].n_clusters} clusters, backface cull '
        f'{sc.meshes[0].backface_cull}')
    t0 = time.perf_counter()
    kernels = kernel_phase(sc, cam, dev) + [pcg]
    log(f'kernel phase {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    reference_phase()
    log(f'reference phase {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    launches, main_rep = main_path(sc, cam, card, args.profile_all)
    log(f'main path {time.perf_counter() - t0:.1f} s')
    t_routed = time.perf_counter()
    routed_launches, routed_rep = routed_phase(sc, cam, card, main_rep)
    t_routed = time.perf_counter() - t_routed
    log(f'routed phase (R1, R2) {t_routed:.1f} s')
    flag, mesh = grad_phase(sc, cam, card)
    t0 = time.perf_counter()
    (train_launches, train_fwd, train_rec, scene_ranks, routed_ranks,
     train_rep) = train_phase(sc, cam, card)
    log(f'train phase {time.perf_counter() - t0:.1f} s')
    del sc
    t0 = time.perf_counter()
    mat_launches, mat = materials_phase(dev, cam, card, args.profile_all)
    log(f'materials phase {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    med_launches, med = media_phase(dev, cam, card, args.profile_all)
    log(f'media phase {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    cli_launches, cli_rep = cli_phase(dev, card)
    log(f'CLI phase {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    fluid_launches, fluid_rep = fluid_phase(dev, cam, card)
    log(f'fluid phase {time.perf_counter() - t0:.1f} s')
    for k in kernels:
        k['launches'] = launches[k['name']]
        k['launches_grad_forward'] = mesh['launches_forward'][k['name']]
        k['launches_grad_backward'] = mesh['launches_backward'][k['name']]
        k['launches_materials'] = mat_launches[k['name']]
    for name, fn in (('tree', lambda: [tree_phase(dev, cam)]),
                     ('packet', lambda: [packet_phase(dev, cam, card)]),
                     ('probe', lambda: probe_phase(dev))):
        t0 = time.perf_counter()
        kernels.extend(fn())
        log(f'{name} phase {time.perf_counter() - t0:.1f} s')
        if name == 'tree':
            # R3 next to the tree phase, whose host builds it reuses
            t0 = time.perf_counter()
            routed_rep['tree'] = routed_tree(dev, cam)
            t_tree = time.perf_counter() - t0
            routed_rep['phase_s'] = t_routed + t_tree
            log(f'routed phase (R3) {t_tree:.1f} s; the phase '
                f'{routed_rep["phase_s"]:.1f} s')
    from pathtracer_tpu_torch.ops import cluster as cl
    recs = {k['name']: k for k in kernels}
    main_sweep, abl = recs['cluster_sweep_closest'], recs['sweep_ablate']
    abl['cluster_sweep_main_ps_per_pair'] = (
        main_sweep['ms'] * 1e9 / (main_sweep['rows'] * cl.SUBT))
    log(f'ablation full {abl["ps_per_pair"]:.3f} ps per pair; the production '
        f'cluster_sweep {abl["cluster_sweep_ps_per_pair"]:.3f} on the same '
        f'inputs, {abl["cluster_sweep_main_ps_per_pair"]:.3f} on the main '
        f'path\'s first round')
    for k in kernels:
        # a probe record's name carries its script: dot_fp32[prof_sweep]
        k['launches_media'] = med_launches[k['name'].split('[')[0]]
        k['launches_cli'] = cli_launches[k['name'].split('[')[0]]
        k['launches_fluid'] = fluid_launches[k['name'].split('[')[0]]
        name = k['name'].split('[')[0]
        k['launches_train'] = train_launches[name]
        k['launches_train_forward'] = train_fwd[name]
        k['launches_train_recompute'] = train_rec[name]
        k['launches_scene_ranks'] = [
            r.get(name.replace('cluster_sweep_', ''), 0) for r in scene_ranks]
        k['launches_scene_ranks_routed'] = [
            r.get(name.replace('cluster_sweep_', ''), 0)
            for r in routed_ranks]
        k['launches_routed'] = routed_launches[name]
        k['launches_routed_tree'] = routed_rep['tree']['launches'].get(name,
                                                                       0)
    log(f'whole run {time.perf_counter() - t_start:.1f} s after the start '
        f'of main')
    log(json.dumps({'routed': routed_rep}))
    log(json.dumps({'training': train_rep}))
    log(json.dumps({'fluid': fluid_rep}))
    log(json.dumps({'cli': cli_rep}))
    log(json.dumps({'media': med}))
    log(json.dumps({'materials': mat}))
    log(json.dumps({'gradients': {'flagship': flag, 'mesh': mesh}}))
    log(card)
    log(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
