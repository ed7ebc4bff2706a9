#!/usr/bin/env python3
"""Per-launch device times of two kernels of the port, on one NVIDIA card.

Run from the root of a checkout: ``python3 trace_kernels.py [--root DIR]``.
``--root`` names the checkout whose ``ysmr_tpu_torch`` is traced (default:
this one), so two versions of the kernels can be traced in one run with
the same inputs. The inputs are ``chip_smoke.py``'s: the pixel lists of
the bench and dense scenes' first 64 frames (``cc_labels_at_pixels``,
double and single threshold) and random blobs with the serpentine, and
the assign inputs at 4096x4096 (K = 2 and 3) and 16384x16384. With
``--dense-e2e N`` it also runs the smoke's dense scene (150 frames, 3000
rods) in memory through the stage-1 loop N times, the device path whose
tracker launches the assign kernel once per frame step.

Each call is traced with ``torch.profiler``; the script prints every
kernel the call launched (the entries' internal launches included) with
its mean device time, grid, block, registers, shared memory and the
profiler's estimate of achieved occupancy, and the call's span on CUDA
events.
"""

import argparse
import importlib.util
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=HERE,
                    help='checkout whose ysmr_tpu_torch is traced')
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--dense-e2e', type=int, default=0, metavar='N',
                    help='also run the dense scene in memory through the '
                    'stage-1 loop N times (frames/s and stage split)')
    return ap.parse_args()


def load_smoke(root):
    """chip_smoke.py of this checkout, importing the package of ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def trace(name, fn, reps, smoke):
    """Profile ``reps`` calls of ``fn`` after a warm-up; print each kernel's
    mean device time and launch shape, and the call's CUDA-event span."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    span = smoke.cuda_ms(fn, reps=reps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    kernels = {}
    for ev in events:
        if ev.get('cat') != 'kernel':
            continue
        args = ev.get('args', {})
        k = kernels.setdefault(ev['name'], {
            'n': 0, 'us': 0.0, 'grid': args.get('grid'),
            'block': args.get('block'),
            'registers': args.get('registers per thread'),
            'smem': args.get('shared memory'),
            'occupancy': args.get('est. achieved occupancy %')})
        k['n'] += 1
        k['us'] += float(ev.get('dur', 0.0))
    print('{}: span {:.4f} ms per call (CUDA events, median of {})'.format(
        name, span, reps), flush=True)
    total = 0.0
    for kname, k in kernels.items():
        per_call = k['us'] / reps / 1e3
        total += per_call
        print('  {:.4f} ms x{} per call  grid {} block {} regs {} smem {} '
              'est. occupancy {}%  {}'.format(
                  per_call, k['n'] // reps, k['grid'], k['block'],
                  k['registers'], k['smem'], k['occupancy'], kname[:90]),
              flush=True)
    print('  kernels sum {:.4f} ms per call'.format(total), flush=True)


def main():
    args = parse_args()
    smoke = load_smoke(args.root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this script runs on a GPU')
    from ysmr_tpu_torch.ops import cc
    from ysmr_tpu_torch.ops.assign import row_min_argmin
    print('tracing the package of {}'.format(os.path.abspath(args.root)),
          flush=True)
    print(smoke.phase_environment(), flush=True)
    smoke.phase_build()
    os.makedirs(smoke.WORK, exist_ok=True)
    dev = torch.device('cuda', 0)
    settings = smoke.bench_settings()
    dsettings = smoke.dense_settings()
    bench = smoke.lists_from_packed(*smoke.packed_batch(
        smoke.BenchScene(), settings), dev)
    dense = smoke.lists_from_packed(*smoke.packed_batch(
        smoke.BenchScene(seed=smoke.DENSE_SEED, n_bugs=smoke.DENSE_BUGS),
        dsettings), dev)
    masks, markers = smoke.random_blob_masks(
        np.random.default_rng(smoke.SEED + 4), 8)
    blobs = smoke.lists_from_masks(masks, markers, dev)
    for name, lists in (('bench', bench), ('dense', dense),
                        ('blobs', blobs)):
        for double in (True, False):
            kw = dict(h=smoke.H, w=smoke.W, double_threshold=double)
            trace('cc_labels_at_pixels {} T={} F={} {}'.format(
                name, lists[0].shape[0], lists[0].shape[1],
                'double' if double else 'single'),
                lambda: cc.cc_labels_at_pixels(*lists, **kw), args.reps,
                smoke)
    rng = np.random.default_rng(smoke.SEED)
    for n, k in ((4096, 2), (4096, 3), (16384, 2)):
        a = smoke.assign_inputs(rng, n, n, k, dev)
        trace('row_min_argmin {}x{} K={}'.format(n, n, k),
              lambda: row_min_argmin(*a), args.reps, smoke)
    if args.dense_e2e:
        scene = smoke.BenchScene(seed=smoke.DENSE_SEED,
                                 n_bugs=smoke.DENSE_BUGS)
        frames = [scene.frame(t) for t in range(smoke.DENSE_FRAMES)]
        for i in range(args.dense_e2e):
            _, _, stats = smoke.run_loop(frames, dsettings, 'cuda',
                                         'trace_dense{}'.format(i))
            print('dense scene in memory run {}: {:.2f} frames/s, stage '
                  'split (ms/frame): {}'.format(i, stats['fps'],
                                                smoke.per_frame(stats)),
                  flush=True)


if __name__ == '__main__':
    main()
