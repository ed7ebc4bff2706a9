#!/usr/bin/env python3
"""Per-launch device times of the port's kernels, on one NVIDIA card.

Run from the root of a checkout: ``python3 trace_kernels.py [--root DIR]
[--groups run_prop,cc]``. ``--root`` names the checkout whose
``ysmr_tpu_torch`` is traced (default: this one), so two versions of the
kernels can be traced in one run with the same inputs (the other
checkout's package must hold every module this ``chip_smoke.py``
imports). The inputs are ``chip_smoke.py``'s, in these groups:

- ``run_prop``: ``propagate_min_fused`` on the run graphs of the bench and
  dense scenes' first 64 frames (the run wire's R bucket, the 4-connected
  weak init and the 8-connected iota) and on the random R = 131072 graphs;
- ``cc``: ``binary_reconstruct`` and the 8- and 4-connected
  ``label_components_whole_frame`` on the bench scene's first 64 frames
  thresholded by the device preprocess (64 x 922 x 1228), and the
  reconstruction on random blobs with the serpentine;
- ``rects``: ``hull_edge_vectors``, ``sweep_extents`` and the rect
  tail's kernels (``cv2_centers_from_tables``, ``edge_finish``,
  ``rect_select``; phase 31's inputs) on the dense batch's tables
  (262,144 x 48) and on the frames-mode bench batch's (32,768 x 64), and
  the hull on random tables (16384 x 96);
- ``tail``: the stats tail's kernels on the tables alone, the hull (from
  min_y, with count), the sweep (the tables at the hull's corners, (1, 0)
  implicit) and the rect select, on the dense and frames-mode bench
  batches, then the whole route from the row tables to the rect
  (``_stats_tail_from_tables`` and ``rect_from_tables``) as one call;
- ``pixels``: ``cc_labels_at_pixels`` on the pixel lists of the bench and
  dense batches (double and single threshold) and of the random blobs;
- ``assign``: ``row_min_argmin`` at 4096x4096 (K = 2 and 3) and
  16384x16384;
- ``gsff``: ``register_and_step`` (the tracker's GSFF block) on random
  mid-run states of 4096 slots with the default bank and of 1024 slots
  with n_max 256 and 8 filters (phase 29's);
- ``preprocess``: the two entries of ``csrc/adaptive_mean.cu``, the int32
  ``adaptive_gaussian_mean`` on the bench scene's blurred first 64
  frames and the fused ``adaptive_masks_from_bgr`` on their BGR (the
  bench configuration, with and without the gray; a checkout from before
  the fused entry traces the int32 one alone);
- ``mean``: mean-threshold mode's entries of ``csrc/adaptive_mean.cu`` on
  the bench scene's first 64 frames and on smoke phase 34's 16-frame
  640x480 batch, ``mean_prepare_from_bgr`` on their
  BGR (with and without the gray) and ``mean_masks`` on its blurred
  frames with the thresholds the host sets from its sums; a checkout from
  before them: ``prepare_batch(needs_sums=True)`` and ``global_threshold
  & frame_valid``, the torch passes they replace;
- ``frame_step``: ``match_and_register`` (the tracker's match, ageing,
  registration and emissions: the rank and update launches of
  ``csrc/frame_step.cu``) on random states at the dense size (4096
  slots, 3000 live, 3000 detections near them), V = 1 and 4 (phase
  30's);
- ``compact``: frames mode's compaction and row tables on the bench and
  dense scenes' first 64 frames as its detect hands them over
  (preprocess, reconstruction, 8-connected labeling; the packed mask
  where the labeling returns it): ``compact_row_tables``
  (``csrc/compact.cu``) or, in a checkout from before it, its
  ``compact_labels`` followed by ``component_row_tables``;
- ``run_cc``: ``run_cc_components`` (double threshold) on the bench
  scene's first 64 frames as the host-rect path calls it (ids only) and
  on the dense scene's with the device rects' stats tables, the run
  wire's R bucket: in a checkout whose finish writes the row tables, its
  six launches of ``csrc/run_cc.cu`` around ``csrc/run_prop.cu``'s and
  the stats tail; before, the sorted runs and ``component_stats_runs``;
- ``lum``: the luminosity paths' two steps at the smoke's inputs (phase
  36's): ``rect_mean_luminosity`` on the bench batch's host rects (uint8
  gray, 64 x 512 slots), the dense batch's device rects (64 x 4096) and
  the frames-mode bench batch's (int32 gray), and its plain version
  where the checkout has one (the torch passes, which are the whole
  function in a checkout from before the kernel); the pixel finish on
  the luminosity wires' labels, the bench batch's host-rect plane and
  the dense batch's row tables: ``cc.pixel_finish`` where the checkout
  has it, and the torch sequence it replaces (``pixel_finish_plain``, or
  before it ``_compact_ids`` and the plane's concatenation or
  ``component_stats``' tables);
- ``table_cc``: the sparse table CC of ``use table cc`` on the bench and
  dense batches' pixel lists (double and single threshold):
  ``cc.cc_labels_table`` on the wire's raster prefix (the pipeline's
  route) and sorted first, its plain version (``cc_labels_table_plain``),
  and ``cc_labels_at_pixels`` on the same lists (the yardstick; the only
  call of a checkout from before the table route), with the host
  synchronisations of each table call; then the 'run cc =
  off' detect of both batches (the bench one with the host-rect plane,
  the dense one with the device rects and cv2 centres) without and, where
  the checkout has it, with ``use_table``;
- ``torch_blocks``: the device blocks that were in torch off the default
  path: the run wire expanded to the pixel table for 'run cc = off'
  (``run_cc.expand_runs``, ``csrc/expand_runs.cu``, and its plain
  version; in a checkout from before the kernel
  ``detect_pixels._expand_runs``) on the bench and dense batches' run
  wires, and ``tracker.compact_emissions_device`` (the compact readback)
  on the emissions of the dense scene's first 64 frames (frames-mode
  detect, dense tracker with GSFF) at buckets 1024 and 4096, each with
  the least bytes it must move and their time at 3.35 TB/s.

With ``--dense-e2e N`` it also runs the smoke's dense scene (150 frames,
3000 rods) in memory through the stage-1 loop N times, the device path
whose tracker launches the assign kernel once per frame step, and N times
in dense exact mode (host rects and the float64 tracker); with
``--lum-e2e N`` the in-memory runs of smoke phases 14-16 (luminosity:
the bench scene with GSFF, host rects feeding the device tracker; the
dense scene, device rects; the bench scene in frames mode), N times
each (every in-memory run also prints its reader's prefetch thread's
wall and CPU time making batches, ms a frame); with
``--e2e N`` the bench scene on the run wire, the dense scene and the bench
scene in frames mode, N times each (frames/s of each).

Each call is traced with ``torch.profiler``; the script prints every
kernel the call launched (the entries' internal launches included) with
its mean device time, grid, block, registers, shared memory and the
profiler's estimate of achieved occupancy (the torch kernels a wrapper
launches before its own appear as lines of their own), the call's span
on CUDA events and, for a call of several launches, its device span (the
first launch's start to the last one's end: launches may overlap, as the
frame step's update overlaps its rank launch).
"""

import argparse
import functools
import importlib.util
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
GROUPS = ('run_prop', 'cc', 'rects', 'tail', 'pixels', 'assign', 'gsff',
          'frame_step', 'preprocess', 'mean', 'compact', 'run_cc', 'lum',
          'table_cc', 'torch_blocks')


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
    ap.add_argument('--lum-e2e', type=int, default=0, metavar='N',
                    help='also run smoke phases 14-16\'s scenes in memory '
                    '(luminosity: bench with GSFF, dense, frames mode) N '
                    'times each (frames/s and stage split)')
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
    import numpy as np
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
    launches = sorted((float(ev['ts']), float(ev.get('dur', 0.0)))
                      for ev in events if ev.get('cat') == 'kernel')
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
    ops = sum(1 for ev in events if ev.get('cat') in (
        'kernel', 'gpu_memset', 'gpu_memcpy'))
    print('  device operations {:.1f} per call (kernels, memsets and '
          'copies)'.format(ops / reps), flush=True)
    per = len(launches) // reps
    if per > 1 and per * reps == len(launches):
        # a call's launches may overlap (a programmatic launch) or leave
        # gaps: the device span from its first start to its last end
        spans = [max(t + d for t, d in launches[i:i + per]) -
                 launches[i][0] for i in range(0, len(launches), per)]
        print('  device span {:.4f} ms per call (first kernel start to last '
              'end, median)'.format(float(np.median(spans)) / 1e3),
              flush=True)


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
    for conn in (8, 4):
        trace('label_components_whole_frame {}-conn bench {}'.format(
            conn, shape), lambda: cc.label_components_whole_frame(mask, conn),
            args.reps, smoke)
    masks, markers = smoke.random_blob_masks(
        np.random.default_rng(smoke.SEED), 8)
    bmask = torch.from_numpy(masks).to(dev)
    bmarker = torch.from_numpy(markers).to(dev)
    trace('binary_reconstruct random blobs with the serpentine {}'.format(
        'x'.join(str(n) for n in bmask.shape)),
        lambda: cc.binary_reconstruct(bmask, bmarker), args.reps, smoke)


def trace_rects(smoke, args, dev):
    import numpy as np
    from ysmr_tpu_torch.ops import cv2_centers as cv2c
    from ysmr_tpu_torch.ops import rect
    from ysmr_tpu_torch.ops.hull import hull_edge_vectors
    from ysmr_tpu_torch.ops.sweep import sweep_extents
    dsettings = smoke.dense_settings()
    dscene = smoke.BenchScene(seed=smoke.DENSE_SEED, n_bugs=smoke.DENSE_BUGS)
    batches = [
        ('dense', smoke.dense_tables(
            *smoke.first_batch_runs(dscene, dsettings), dsettings, dev)),
        ('frames-mode bench', smoke.frames_tables(
            smoke.BenchScene(), smoke.bench_settings(), dev)),
        ('random', (smoke.random_row_tables(
            np.random.default_rng(smoke.SEED), 16384, 96, dev), None))]
    for name, (hull_args, sweep_args) in batches:
        trace('hull_edge_vectors {} D={} R={}'.format(
            name, *hull_args[0].shape),
            lambda: hull_edge_vectors(*hull_args), args.reps, smoke)
        if sweep_args is None:
            continue
        trace('sweep_extents {} D={} R={} K={}'.format(
            name, *sweep_args[0].shape, sweep_args[6].shape[1] + 1),
            lambda: sweep_extents(*sweep_args), args.reps, smoke)
        cv2_args, chains, select_args = smoke.rect_tail_inputs(hull_args,
                                                               sweep_args)
        r = cv2_args[0].shape[1]
        trace('cv2_centers_from_tables {} D={} R={}'.format(
            name, *cv2_args[0].shape),
            lambda: cv2c.cv2_centers_from_tables(*cv2_args, max_bh=r),
            args.reps, smoke)
        trace('edge_finish {} D={} R={}'.format(name, *chains[0].shape),
              lambda: rect.edge_finish(*chains), args.reps, smoke)
        trace('rect_select {} D={} K={}'.format(name, *select_args[0].shape),
              lambda: rect.rect_select(*select_args), args.reps, smoke)


def trace_tail(smoke, args, dev):
    from ysmr_tpu_torch.ops import labeling as lb
    from ysmr_tpu_torch.ops import rect
    from ysmr_tpu_torch.ops.hull import hull_edge_vectors
    from ysmr_tpu_torch.ops.sweep import sweep_extents
    dsettings = smoke.dense_settings()
    dscene = smoke.BenchScene(seed=smoke.DENSE_SEED, n_bugs=smoke.DENSE_BUGS)
    batches = [
        ('dense', smoke.dense_tables(
            *smoke.first_batch_runs(dscene, dsettings), dsettings, dev)),
        ('frames-mode bench', smoke.frames_tables(
            smoke.BenchScene(), smoke.bench_settings(), dev))]
    for name, (rows, sweep_args) in batches:
        d, r = rows[0].shape
        trace('hull_edge_vectors {} D={} R={}'.format(name, d, r),
              lambda: hull_edge_vectors(*rows), args.reps, smoke)
        trace('sweep_extents {} D={} R={} K={}'.format(name, d, r, 2 * r - 1),
              lambda: sweep_extents(*sweep_args), args.reps, smoke)
        select_args = smoke.rect_tail_inputs(rows, sweep_args)[2]
        trace('rect_select {} D={} K={}'.format(name, d, 2 * r - 1),
              lambda: rect.rect_select(*select_args), args.reps, smoke)
        trace('stats tail + rect from the tables {} D={} R={}'.format(
            name, d, r), lambda: lb.rect_from_tables(
                lb._stats_tail_from_tables(*rows)), args.reps, smoke)


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


def trace_gsff(smoke, args, dev):
    import numpy as np
    from ysmr_tpu_torch.ops.gsff import GSFFParams, register_and_step
    rng = np.random.default_rng(smoke.SEED + 29)
    for n, bank in ((4096, {}), (1024, {'n_max': 256, 'n_f': 8})):
        params = GSFFParams(fps=smoke.FPS, **bank)
        a = smoke.gsff_case(rng, n, params, dev)
        trace('register_and_step N={} n_max={} n_f={} ({} active)'.format(
            n, params.n_max, params.n_f, int(a[6].sum())),
            lambda: register_and_step(*a), args.reps, smoke)


def trace_frame_step(smoke, args, dev):
    import numpy as np
    from ysmr_tpu_torch.ops import frame_step as fs
    rng = np.random.default_rng(smoke.SEED + 30)
    for v in (1, 4):
        state, frame, row_min, cand = smoke.step_inputs(
            rng, 'dense', (v, 4096, 4096, 2), dev)
        trace('match_and_register V={} S=C=4096 ({} live)'.format(
            v, int(state['active'].sum())),
            lambda: fs.match_and_register(state, row_min, cand, *frame,
                                          max_disappeared=float(smoke.FPS)),
            args.reps, smoke)


def trace_preprocess(smoke, args, dev):
    import torch
    from ysmr_tpu_torch.ops import preprocess as pp
    from ysmr_tpu_torch.pipeline import detect
    scene = smoke.BenchScene()
    cfg = detect.DetectorConfig(smoke.bench_settings())
    bgr = smoke.bgr_batch([scene.frame(t) for t in range(64)], dev)
    blurred = detect.prepare_batch(bgr)[1]
    shape = 'x'.join(str(n) for n in blurred.shape)
    trace('adaptive_gaussian_mean bench {}'.format(shape),
          lambda: pp.adaptive_gaussian_mean(blurred), args.reps, smoke)
    if not hasattr(pp, 'adaptive_masks_from_bgr'):
        return      # a checkout from before the fused preprocess
    valid = torch.ones(bgr.shape[0], dtype=torch.bool, device=dev)
    for gray in (False, True):
        trace('adaptive_masks_from_bgr bench {} {}{}'.format(
            shape, cfg.mode, ' with the gray' if gray else ''),
            lambda: pp.adaptive_masks_from_bgr(
                bgr, valid, cfg.mode, cfg.offset, cfg.double_delta,
                cfg.white_on_dark, gray), args.reps, smoke)


def trace_mean(smoke, args, dev):
    import torch
    from ysmr_tpu_torch.ops import preprocess as pp
    from ysmr_tpu_torch.pipeline import detect
    scene = smoke.BenchScene()
    bgr = smoke.bgr_batch([scene.frame(t) for t in range(64)], dev)
    valid = torch.ones(bgr.shape[0], dtype=torch.bool, device=dev)
    shape = 'x'.join(str(n) for n in bgr.shape[:3])
    if not hasattr(pp, 'mean_prepare_from_bgr'):
        # a checkout from before the mean-mode kernels: its torch passes
        _, blurred, *sums = detect.prepare_batch(bgr, needs_sums=True)
        thr = smoke.host_thresholds(torch.stack(sums, 1), valid,
                                    bgr.shape[1] * bgr.shape[2], True)
        trace('prepare_batch(needs_sums=True) bench {}'.format(shape),
              lambda: detect.prepare_batch(bgr, needs_sums=True), args.reps,
              smoke)
        trace('global_threshold & frame_valid bench {}'.format(shape),
              lambda: pp.global_threshold(blurred, thr, True) &
              valid[:, None, None], args.reps, smoke)
        return
    # the bench batch and smoke phase 34's 16-frame 640x480 batch
    seed, _, (ow, oh) = smoke.MV_OTHER
    other = smoke.BenchScene(seed=seed)
    small = smoke.bgr_batch([other.frame(t)[:oh, :ow] for t in range(16)],
                            dev)
    for name, bgr in (('bench', bgr), ('640x480', small)):
        shape = 'x'.join(str(n) for n in bgr.shape[:3])
        valid = torch.ones(bgr.shape[0], dtype=torch.bool, device=dev)
        blurred, sums, _ = pp.mean_prepare_from_bgr(bgr)
        thr = smoke.host_thresholds(sums, valid,
                                    bgr.shape[1] * bgr.shape[2], True)
        for gray in (False, True):
            trace('mean_prepare_from_bgr {} {}{}'.format(
                name, shape, ' with the gray' if gray else ''),
                lambda: pp.mean_prepare_from_bgr(bgr, gray), args.reps,
                smoke)
        trace('mean_masks {} {}'.format(name, shape),
              lambda: pp.mean_masks(blurred, thr, valid, True), args.reps,
              smoke)


def trace_compact(smoke, args, dev):
    from ysmr_tpu_torch.ops import cc
    from ysmr_tpu_torch.ops import labeling as lb
    for name, scene, settings in (
            ('bench', smoke.BenchScene(), smoke.bench_settings()),
            ('dense', smoke.BenchScene(seed=smoke.DENSE_SEED,
                                       n_bugs=smoke.DENSE_BUGS),
             smoke.dense_settings())):
        max_det = settings['max detections per frame']
        max_bh = settings['max bounding box height']
        mask, marker = smoke.bench_masks(scene, settings, dev)
        mask = cc.binary_reconstruct(mask, marker & mask)
        labels = cc.label_components_whole_frame(mask, 8)
        shape = 'x'.join(str(n) for n in mask.shape)
        if hasattr(lb, 'compact_row_tables'):
            # the packed mask, where the labeling hands it over
            bits = smoke.compact_bits(labels, mask) \
                if hasattr(smoke, 'compact_bits') else None
            kw = {} if bits is None else {'fg_bits': bits}
            trace('compact_row_tables {} {}{}'.format(
                name, shape, '' if bits is None else ' (packed mask)'),
                lambda: lb.compact_row_tables(labels, mask, max_det=max_det,
                                              max_bh=max_bh, **kw),
                args.reps, smoke)
            continue

        def steps():
            comp, _ = lb.compact_labels(labels, mask, max_det=max_det)
            return lb.component_row_tables(comp, mask, max_det=max_det,
                                           max_bh=max_bh)
        trace('compact_labels + component_row_tables {} {}'.format(
            name, shape), steps, args.reps, smoke)


def trace_run_cc(smoke, args, dev):
    """Run-CC at the bench batch (the host-rect path: ids only) and at the
    dense batch with the device rects' stats tables after it: the finish's
    row tables and the stats tail (in a checkout from before the finish
    wrote them, the sorted runs and ``component_stats_runs``)."""
    import inspect

    import numpy as np
    import torch
    from ysmr_tpu_torch.ops import labeling as lb
    from ysmr_tpu_torch.ops import run_cc
    tables = 'row_tables' in inspect.signature(
        run_cc.run_cc_components).parameters
    # a checkout whose stats tail forms abs_y from max_bh
    old_tail = 'max_bh' in inspect.signature(
        lb._stats_tail_from_tables).parameters
    for name, scene, settings, dense in (
            ('bench', smoke.BenchScene(), smoke.bench_settings(), False),
            ('dense', smoke.BenchScene(seed=smoke.DENSE_SEED,
                                       n_bugs=smoke.DENSE_BUGS),
             smoke.dense_settings(), True)):
        runs, rc = smoke.first_batch_runs(scene, settings)
        wire = (torch.from_numpy(runs.view(np.int32)).to(dev),
                torch.from_numpy(rc).to(dev))
        kw = dict(w=smoke.W, double_threshold=True,
                  max_iters=smoke.MAX_ITERS)
        sizes = dict(h=smoke.H, max_det=settings['max detections per frame'],
                     max_bh=settings['max bounding box height'])

        def call(dense=dense):
            if not dense:
                return run_cc.run_cc_components(*wire, **kw)
            if tables:
                out = run_cc.run_cc_components(*wire, **kw,
                                               row_tables=sizes)
                return lb._stats_tail_from_tables(
                    *(out[k] for k in run_cc.TABLE_KEYS),
                    **({'max_bh': sizes['max_bh'], 'cv2_centers': True}
                       if old_tail else {}))
            out = run_cc.run_cc_components(*wire, **kw, sorted_runs=True)
            n = out['n_components']
            rev = torch.where(out['s_comp'] >= 0,
                              n[:, None] - 1 - out['s_comp'],
                              torch.full_like(out['s_comp'], -1))
            return lb.component_stats_runs(out['s_start'], out['s_len'], rev,
                                           w=smoke.W, cv2_centers=True,
                                           **sizes)
        trace('run_cc_components {} T={} R={}{}'.format(
            name, runs.shape[0], runs.shape[1],
            ' + stats tables ({})'.format(
                'row tables, stats tail' if tables else
                'sorted runs, component_stats_runs') if dense else ''),
            call, args.reps, smoke)


def trace_lum(smoke, args, dev):
    from ysmr_tpu_torch.ops import cc
    from ysmr_tpu_torch.ops import luminosity as lum
    for name, largs, win in smoke.lum_batches(dev):
        label = '{} T={} D={} gray {} win {}'.format(
            name, *largs[1].shape, str(largs[0].dtype).split('.')[-1], win)
        trace('rect_mean_luminosity ' + label,
              lambda: lum.rect_mean_luminosity(*largs, win=win), args.reps,
              smoke)
        if hasattr(lum, 'rect_mean_luminosity_plain'):
            trace('rect_mean_luminosity_plain ' + label,
                  lambda: lum.rect_mean_luminosity_plain(*largs, win=win),
                  args.reps, smoke)
    for name, fargs, kw in smoke.finish_batches(dev):
        label = '{} T={} F={}'.format(name, *fargs[0].shape)
        if hasattr(cc, 'pixel_finish'):
            trace('pixel_finish ' + label,
                  lambda: cc.pixel_finish(*fargs, **kw), args.reps, smoke)
        trace('pixel finish torch passes ' + label,
              lambda: smoke.finish_torch_passes(fargs, **kw), args.reps,
              smoke)


def trace_table_cc(smoke, args, dev):
    import torch
    from ysmr_tpu_torch.ops import cc
    from ysmr_tpu_torch.pipeline import detect_pixels as dp
    scenes = (('bench', smoke.BenchScene(), smoke.bench_settings()),
              ('dense', smoke.BenchScene(seed=smoke.DENSE_SEED,
                                         n_bugs=smoke.DENSE_BUGS),
               smoke.dense_settings()))
    table = hasattr(cc, 'cc_labels_table')
    for name, scene, settings in scenes:
        packed, counts = smoke.packed_batch(scene, settings)
        lists = smoke.lists_from_packed(packed, counts, dev)
        lin = (lists[1] * smoke.W + lists[0]).contiguous()
        label = '{} T={} F={}'.format(name, *lin.shape)
        for double in (True, False):
            kw = dict(h=smoke.H, w=smoke.W, double_threshold=double,
                      max_iters=smoke.MAX_ITERS)
            tag = '{} {}'.format(label, 'double' if double else 'single')
            if table:
                for prefix in (True, False):
                    call = functools.partial(
                        cc.cc_labels_table, lin, lists[2], lists[3],
                        raster_prefix=prefix, **kw)
                    name_c = 'cc_labels_table {} ({})'.format(
                        tag, 'raster prefix' if prefix else 'sorted')
                    trace(name_c, call, args.reps, smoke)
                    print('  host syncs {} per call'.format(
                        host_syncs(call)), flush=True)
                call = functools.partial(cc.cc_labels_table_plain, lin,
                                         lists[2], lists[3], **kw)
                trace('cc_labels_table_plain ' + tag, call, 3, smoke)
                print('  host syncs {} per call'.format(host_syncs(call)),
                      flush=True)
            trace('cc_labels_at_pixels ' + tag,
                  lambda: cc.cc_labels_at_pixels(*lists, **kw), args.reps,
                  smoke)
        runs, rc = smoke.encode(packed, counts, smoke.W, None)
        t = runs.shape[0]
        dkw = dict(px_x=None, px_y=None, px_marker=None,
                   frame_valid=torch.ones(t, dtype=torch.bool, device=dev),
                   px_counts=to_dev(counts, dev),
                   px_runs=to_dev(runs.view('int32'), dev),
                   run_counts=to_dev(rc, dev), expanded_f=packed.shape[1],
                   use_run_cc=False, h=smoke.H, w=smoke.W,
                   double_threshold=True,
                   max_det=settings['max detections per frame'],
                   max_bh=settings['max bounding box height'],
                   cc_iters=settings['connected components max iterations'])
        if name == 'dense':
            dkw['cv2_centers'] = True
        else:
            dkw['readback_pixels'] = smoke.pixel_bucket(counts,
                                                        packed.shape[1])
        for use_table in ((False, True) if table else (False,)):
            trace("detect_from_pixels 'run cc = off' {}{}".format(
                label, ' use_table' if use_table else ''),
                lambda: dp.detect_from_pixels(
                    **dkw, **({'use_table': True} if use_table else {})),
                args.reps, smoke)


def host_syncs(fn):
    """The host synchronisations of one call of ``fn``: the warnings
    ``torch.cuda.set_sync_debug_mode('warn')`` raises in it."""
    import warnings
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            fn()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    return sum('synchroniz' in str(w.message) for w in caught)


def to_dev(arr, dev):
    import torch
    return torch.from_numpy(arr).to(dev)


def trace_torch_blocks(smoke, args, dev):
    import torch
    from ysmr_tpu_torch.ops import run_cc as rcc
    from ysmr_tpu_torch.pipeline import detect_pixels as dp
    from ysmr_tpu_torch.pipeline import tracker as trk
    dscene = smoke.BenchScene(seed=smoke.DENSE_SEED, n_bugs=smoke.DENSE_BUGS)
    dsettings = smoke.dense_settings()
    for name, scene, settings in (
            ('bench', smoke.BenchScene(), smoke.bench_settings()),
            ('dense', dscene, dsettings)):
        packed, counts = smoke.packed_batch(scene, settings)
        runs, rc = smoke.encode(packed, counts, smoke.W, None)
        wire = to_dev(runs.view('int32'), dev)
        rcount = to_dev(rc, dev)
        f = packed.shape[1]
        nbytes, n_runs = smoke.expand_bytes(runs, rc, f)
        print('the run wire expanded, {} T={} R={} F={} runs {}: bound '
              '{:.4f} ms (bytes, {:.2f} MB)'.format(
                  name, runs.shape[0], runs.shape[1], f, n_runs,
                  nbytes / smoke.PEAK_BYTES * 1e3, nbytes / 1e6), flush=True)
        label = '{} T={} R={} F={}'.format(name, runs.shape[0],
                                           runs.shape[1], f)
        if hasattr(rcc, 'expand_runs'):
            trace('expand_runs ' + label,
                  lambda: rcc.expand_runs(wire, rcount, f, True), args.reps,
                  smoke)
            trace('expand_runs_plain ' + label,
                  lambda: rcc.expand_runs_plain(wire, rcount, f, True),
                  args.reps, smoke)
        else:
            trace('_expand_runs ' + label,
                  lambda: dp._expand_runs(wire, rcount, f, True), args.reps,
                  smoke)
    dframes = [dscene.frame(t) for t in range(64)]
    tables, params, tkw = smoke.dense_tracker_inputs(dframes, dsettings, dev)
    state = trk.init_tracker_state(dsettings['max track slots'], dev,
                                   use_gsff=True, gsff_params=params)
    _, emissions = trk.run_tracker_scan(state, *tables, **tkw)
    n_comp = tables[2].sum(dim=1, dtype=torch.int32)
    torch.cuda.synchronize()
    t, s = emissions['mask'].shape
    k = emissions['pos'].shape[2]
    live = int(emissions['mask'].sum())
    for bucket in (1024, 4096):
        # the mask and the live slots' payload (5 + K words) in, the
        # buffer out
        nbytes = t * s + live * (5 + k) * 4 + t * (bucket + 1) * (5 + k) * 4
        print('compact_emissions_device dense T={} S={} live {} bucket {}: '
              'bound {:.4f} ms (bytes, {:.1f} MB)'.format(
                  t, s, live, bucket, nbytes / smoke.PEAK_BYTES * 1e3,
                  nbytes / 1e6), flush=True)
        trace('compact_emissions_device dense bucket {}'.format(bucket),
              lambda: trk.compact_emissions_device(emissions, n_comp,
                                                   bucket=bucket),
              args.reps, smoke)


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
    if args.lum_e2e:
        scene = smoke.BenchScene()
        frames = [scene.frame(t) for t in range(smoke.N_FRAMES)]
        settings = {**smoke.bench_settings(), **smoke.LUM}
        dscene = smoke.BenchScene(seed=smoke.DENSE_SEED,
                                  n_bugs=smoke.DENSE_BUGS)
        dframes = [dscene.frame(t) for t in range(smoke.DENSE_FRAMES)]
        runs += [('bench scene with luminosity and GSFF (phase 14)', frames,
                  settings, args.lum_e2e),
                 ('dense scene with luminosity (phase 15)', dframes,
                  {**smoke.dense_settings(), **smoke.LUM}, args.lum_e2e),
                 ('bench scene, frames mode with luminosity (phase 16)',
                  frames, {**settings, **smoke.FRAMES}, args.lum_e2e)]
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
            reader = ''
            if 'reader_s' in stats:
                # the prefetch thread's time making batches (wall, CPU)
                reader = '; reader (ms/frame): {}'.format(json.dumps({
                    k: round(v / stats['frames'] * 1e3, 4)
                    for k, v in stats['reader_s'].items()}))
            print('{} in memory run {}: {:.2f} frames/s, stage split '
                  '(ms/frame): {}{}'.format(name, i, stats['fps'],
                                            smoke.per_frame(stats), reader),
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
               'rects': trace_rects, 'tail': trace_tail,
               'pixels': trace_pixels,
               'assign': trace_assign, 'gsff': trace_gsff,
               'frame_step': trace_frame_step,
               'preprocess': trace_preprocess, 'mean': trace_mean,
               'compact': trace_compact,
               'run_cc': trace_run_cc, 'lum': trace_lum,
               'table_cc': trace_table_cc, 'torch_blocks': trace_torch_blocks}
    for g in GROUPS:
        if g in groups:
            tracers[g](smoke, args, dev)
    end_to_end(smoke, args)


if __name__ == '__main__':
    main()
