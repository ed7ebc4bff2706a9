#!/usr/bin/env python3
"""Per-launch device times of the port's kernels, on one NVIDIA card.

Run from the root of a checkout: ``python3 trace_kernels.py [--root DIR]
[--groups run_prop,cc]``. ``--root`` names the checkout whose
``ysmr_tpu_torch`` is traced (default: this one), so two versions of the
kernels can be traced in one run with the same inputs. The inputs are
``chip_smoke.py``'s, in four groups:

- ``run_prop``: ``propagate_min_fused`` on the run graphs of the bench and
  dense scenes' first 64 frames (the run wire's R bucket, the 4-connected
  weak init and the 8-connected iota) and on the random R = 131072 graphs;
- ``cc``: ``binary_reconstruct`` and the 8-connected
  ``label_components_whole_frame`` on the bench scene's first 64 frames
  thresholded by the device preprocess (64 x 922 x 1228), and the
  reconstruction on random blobs with the serpentine;
- ``pixels``: ``cc_labels_at_pixels`` on the pixel lists of the bench and
  dense batches (double and single threshold) and of the random blobs;
- ``assign``: ``row_min_argmin`` at 4096x4096 (K = 2 and 3) and
  16384x16384.

With ``--dense-e2e N`` it also runs the smoke's dense scene (150 frames,
3000 rods) in memory through the stage-1 loop N times, the device path
whose tracker launches the assign kernel once per frame step, and N times
in dense exact mode (host rects and the float64 tracker); with
``--e2e N`` the bench scene on the run wire, the dense scene and the bench
scene in frames mode, N times each (frames/s of each).

Each call is traced with ``torch.profiler``; the script prints every
kernel the call launched (the entries' internal launches included) with
its mean device time, grid, block, registers, shared memory and the
profiler's estimate of achieved occupancy (the torch kernels a wrapper
launches before its own appear as lines of their own), and the call's
span on CUDA events.
"""

import argparse
import importlib.util
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
GROUPS = ('run_prop', 'cc', 'pixels', 'assign')


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=HERE,
                    help='checkout whose ysmr_tpu_torch is traced')
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--groups', default=','.join(GROUPS),
                    help='comma-separated groups to trace, of ' +
                    ', '.join(GROUPS))
    ap.add_argument('--e2e', type=int, default=0, metavar='N',
                    help='also run the bench scene (run wire), the dense '
                    'scene and the bench scene in frames mode in memory N '
                    'times each (frames/s)')
    ap.add_argument('--dense-e2e', type=int, default=0, metavar='N',
                    help='also run the dense scene in memory through the '
                    'stage-1 loop N times, and N times in dense exact mode '
                    '(frames/s and stage split)')
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


def trace_run_prop(smoke, args, dev):
    import numpy as np
    from ysmr_tpu_torch.ops.run_prop import propagate_min_fused
    batches = [('bench', smoke.W) + smoke.first_batch_runs(
        smoke.BenchScene(), smoke.bench_settings()),
        ('dense', smoke.W) + smoke.first_batch_runs(
            smoke.BenchScene(seed=smoke.DENSE_SEED, n_bugs=smoke.DENSE_BUGS),
            smoke.dense_settings())]
    t, h, w, r, dens = smoke.RANDOM_GRAPHS[1]
    batches.append(('random', w) + smoke.random_runs(
        np.random.default_rng(smoke.SEED), t, h, w, r, dens))
    for name, w, runs, rc in batches:
        for conn in (4, 8):
            init, win, link = smoke.graph_inputs(runs, rc, w, conn, dev)
            trace('propagate_min_fused {} T={} R={} {}-conn'.format(
                name, runs.shape[0], runs.shape[1], conn),
                lambda: propagate_min_fused(
                    init, win, link, max_iters=smoke.MAX_ITERS),
                args.reps, smoke)


def trace_cc(smoke, args, dev):
    import numpy as np
    import torch
    from ysmr_tpu_torch.ops import cc
    mask, marker = smoke.bench_masks(smoke.BenchScene(),
                                     smoke.bench_settings(), dev)
    marker = marker & mask
    shape = 'x'.join(str(n) for n in mask.shape)
    trace('binary_reconstruct bench {}'.format(shape),
          lambda: cc.binary_reconstruct(mask, marker), args.reps, smoke)
    trace('label_components_whole_frame 8-conn bench {}'.format(shape),
          lambda: cc.label_components_whole_frame(mask, 8), args.reps, smoke)
    masks, markers = smoke.random_blob_masks(
        np.random.default_rng(smoke.SEED), 8)
    bmask = torch.from_numpy(masks).to(dev)
    bmarker = torch.from_numpy(markers).to(dev)
    trace('binary_reconstruct random blobs with the serpentine {}'.format(
        'x'.join(str(n) for n in bmask.shape)),
        lambda: cc.binary_reconstruct(bmask, bmarker), args.reps, smoke)


def trace_pixels(smoke, args, dev):
    import numpy as np
    from ysmr_tpu_torch.ops import cc
    bench = smoke.lists_from_packed(*smoke.packed_batch(
        smoke.BenchScene(), smoke.bench_settings()), dev)
    dense = smoke.lists_from_packed(*smoke.packed_batch(
        smoke.BenchScene(seed=smoke.DENSE_SEED, n_bugs=smoke.DENSE_BUGS),
        smoke.dense_settings()), dev)
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


def trace_assign(smoke, args, dev):
    import numpy as np
    from ysmr_tpu_torch.ops.assign import row_min_argmin
    rng = np.random.default_rng(smoke.SEED)
    for n, k in ((4096, 2), (4096, 3), (16384, 2)):
        a = smoke.assign_inputs(rng, n, n, k, dev)
        trace('row_min_argmin {}x{} K={}'.format(n, n, k),
              lambda: row_min_argmin(*a), args.reps, smoke)


def end_to_end(smoke, args):
    """The smoke's scenes in memory through the stage-1 loop on cuda:
    frames/s and stage split of each run."""
    runs = []
    if args.e2e:
        scene = smoke.BenchScene()
        frames = [scene.frame(t) for t in range(smoke.N_FRAMES)]
        settings = smoke.bench_settings()
        runs += [('bench scene, run wire', frames, settings, args.e2e),
                 ('bench scene, frames mode', frames,
                  {**settings, **smoke.FRAMES}, args.e2e)]
    n_dense = max(args.e2e, args.dense_e2e)
    if n_dense:
        scene = smoke.BenchScene(seed=smoke.DENSE_SEED,
                                 n_bugs=smoke.DENSE_BUGS)
        frames = [scene.frame(t) for t in range(smoke.DENSE_FRAMES)]
        settings = smoke.dense_settings()
        runs.append(('dense scene', frames, settings, n_dense))
        if args.dense_e2e:
            # the host-rect gate raised to the capacity: run-CC on the
            # card, then the host rects and the float64 tracker
            runs.append(('dense scene, exact mode', frames, {
                **settings, 'cv2 exact rects max detections':
                settings['max detections per frame']}, args.dense_e2e))
    for name, frames, settings, n in runs:
        for i in range(n):
            _, _, stats = smoke.run_loop(frames, settings, 'cuda',
                                         'trace_e2e')
            print('{} in memory run {}: {:.2f} frames/s, stage split '
                  '(ms/frame): {}'.format(name, i, stats['fps'],
                                          smoke.per_frame(stats)),
                  flush=True)


def main():
    args = parse_args()
    groups = [g for g in args.groups.split(',') if g]
    if set(groups) - set(GROUPS):
        raise SystemExit('unknown group in {} (of {})'.format(
            args.groups, ', '.join(GROUPS)))
    smoke = load_smoke(args.root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this script runs on a GPU')
    print('tracing the package of {}'.format(os.path.abspath(args.root)),
          flush=True)
    print(smoke.phase_environment(), flush=True)
    smoke.phase_build()
    os.makedirs(smoke.WORK, exist_ok=True)
    dev = torch.device('cuda', 0)
    tracers = {'run_prop': trace_run_prop, 'cc': trace_cc,
               'pixels': trace_pixels, 'assign': trace_assign}
    for g in GROUPS:
        if g in groups:
            tracers[g](smoke, args, dev)
    end_to_end(smoke, args)


if __name__ == '__main__':
    main()
