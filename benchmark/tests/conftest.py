"""Shared pieces of the benchmark's own tests: tiny overrides of each cell
for the CPU, and the card fixture of the tests marked `gpu`."""

import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

with open(os.path.join(ROOT, 'BENCHMARK.json')) as _f:
    BENCH = json.load(_f)
CELLS = [w['name'] for w in BENCH['workloads']]

# each cell at a size the CPU runs in seconds: every code path of the
# cell, a handful of pixels
TINY = {
    'frames': {'config': {'resolution': [24, 16], 'mesh': {'n_lat': 24,
                                                           'n_lon': 24}},
               'check': {'pixels_per_image': 16}},
    'grad_steps': {'config': {'resolution': [24, 16], 'spp': 4}},
}


def tiny(cell: str) -> dict:
    """Overrides that shrink `cell` for the CPU: the image, the mesh, and an
    image of two waves."""
    entry = next(w for w in BENCH['workloads'] if w['name'] == cell)
    with open(os.path.join(ROOT, 'benchmark', 'traffic',
                           entry['traffic'] + '.json')) as f:
        traffic = json.load(f)
    ov = json.loads(json.dumps(TINY[traffic['driver']]))
    with open(os.path.join(ROOT, 'benchmark', 'configs',
                           entry['config'] + '.json')) as f:
        if 'mesh' not in json.load(f):
            ov['config'].pop('mesh', None)
    if traffic['driver'] == 'frames':
        spw = min(traffic['samples_per_wave'], 2)
        ov['traffic'] = {'samples_per_wave': spw}
        ov['config']['spp'] = 2 * spw
    return ov


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')
