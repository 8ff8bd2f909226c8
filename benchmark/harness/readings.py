"""Readings that set a cell's limits: the program's compared numbers over
many seeds and the control's (the reference in bfloat16, in the program's
place), each seed a whole run of the cell in one process.

    python3 -m benchmark.harness.readings --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control]

One JSON line a seed: the program's numbers, whether they pass the cell's
limits, and the control's numbers and verdict.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control', action='store_true')
    a = ap.parse_args(argv)
    import torch
    from benchmark import run as bench_run
    if not torch.cuda.is_available():
        sys.exit('readings are taken on a CUDA card')
    controls = (torch.bfloat16,) if a.control else ()
    for seed in a.seeds:
        res, lines = bench_run.run(a.workload, seed, a.seconds, False,
                                   controls=controls)
        print(json.dumps({'seed': seed, 'correct': res['correct'],
                          'check': res['check'],
                          'controls': res.get('controls'),
                          'metrics': res['metrics']}), flush=True)


if __name__ == '__main__':
    main()
