#!/usr/bin/env python3
"""Dense detect of the port on one NVIDIA card: its device operations and
device time, split by step (and run-CC by sub-step), for one or more
checkouts in turns.

Run from the root of a checkout::

    python3 dense_detect_times.py [--roots DIR,DIR,...] [--passes 3]
        [--batches dense,bench,lum_bench,lum_dense,off_bench,off_dense,
                   table_bench,table_dense]

``--roots`` lists checkouts in the order to run them (default: this one),
e.g. ``.scratch/parent,.,.,.scratch/parent`` after unpacking the other
tree with ``git archive <commit> | tar -x -C .scratch/parent``. Each runs
in a process of its own that imports that checkout's ``ysmr_tpu_torch``
and ``chip_smoke.py`` and prints one JSON line.

The ``dense`` batch is the dense scene's first 64 frames (1228x922, 3000
rods, seed 125) as the pipeline's run wire, at ``bench.py:624-631``'s
capacities (4096 detections, ``max_bh`` 48, 131072 foreground pixels):
run-CC, device rects and cv2 centres, as ``track_bacteria`` calls
``detect_from_pixels`` on the dense path. The ``bench`` batch is the bench
scene's first 64 frames (200 rods, seed 123) at ``bench_settings()``'s
capacities on the host-rect path: run-CC and the int16 plane that
``stage_detect`` copies to the host (``readback_runs``: the first runs'
detection index, the count and the steps, which run-CC's finish writes;
in a checkout from before it, ``skip_rect`` and ``det_px_as_runs``
followed by ``stage_detect``'s slice, casts and concatenation).

The luminosity batches take the split pixel wire that luminosity uses
(int16 x and y, uint8 marker, with the uint8 gray frames; it never enters
run-CC) of the same first 64 frames (smoke ``lum_wire``). ``lum_bench``
is the host-rect path at the bench capacities: the detect and the int16
plane ``stage_detect`` copies (``readback_pixels``, which the pixel
finish writes; in a checkout from before it, ``return_det_px`` and
``skip_rect`` followed by ``stage_detect``'s slice, casts and
concatenation), then ``det_xy_with_rect_lum`` on the batch's host rects
(measured once beforehand by the native cv2 recipe, as ``finish_detect``
measures them): their upload, the rect mean and the [cx, cy, lum]
stack. ``lum_dense`` is the dense path with luminosity: device rects,
cv2 centres and the exact rect mean of the gray frames. Both add the
steps ``pixel labels`` (``cc_labels_at_pixels``), ``pixel finish``
(``cc.pixel_finish``, or ``_compact_ids`` before it), ``component_stats``
(the row tables' torch sequence before the finish wrote them) and
``rect mean`` (``rect_mean_luminosity``), and a ``rect_mean`` record of
the rect mean called alone on the arguments the batch gave it: device
operations and ms, CUDA-event ms and host synchronisations. Every
batch's record holds ``detect_syncs``, the host synchronisations of one
call (the warnings of ``torch.cuda.set_sync_debug_mode``). Each batch's
record holds:

- ``detect_ms``: median host-clock ms (card synchronised; 10 calls after
  2 warm-ups) of the whole call, and ``device_ops`` / ``device_ms``: its
  device operations (kernels, memsets, copies) and their summed device
  time under ``torch.profiler`` (median of ``--passes`` calls);
- ``split``: the same call with each step wrapped in a
  ``record_function`` window that opens after a synchronise and ends with
  one, the window of each step holding the device operations that start
  inside it and inside no window nested in it (median of ``--passes``
  passes): per step
  ``device_ops``, ``device_ms``, ``span_ms`` (host clock, the nested
  windows' spans taken out) and the three longest kernels. The steps are
  the package functions both layouts share: ``run-CC``
  (``run_cc_components``; since its finish writes the row tables, with
  them), ``component_stats_runs`` (the row-table scatters over the
  sorted runs; 0 operations where run-CC writes the tables),
  ``stats tail`` (the tail's own operations: count and the candidate
  points in a checkout that builds them, none where the hull writes count
  and the sweep reads the tables), ``hull`` (``hull_edge_vectors``),
  ``edge finish`` (the rest of ``_hull_edge_data``), ``sweep``
  (``sweep_extents``), ``rect select`` (the rest of ``min_area_rect``, or
  of ``rect_from_tables`` where the checkout has it), ``cv2 centres``
  (``_cv2_center_override``), ``output`` (the rest of
  ``detections_from_tables``) and ``detect`` (the rest of the call); a
  step the call does not reach reports 0. The split's outputs are held
  to the plain call's.
- ``run_cc``: run-CC by sub-step, from the same passes: each call of the
  propagation wrapper (``ops/run_prop.py::propagate_min_fused``) in a
  window of its own, ``4-conn propagation`` and ``8-conn propagation``
  (a single threshold has only the second), and the run-CC window's
  other device operations by when they start: before the first
  propagation ``prepare`` (decode, windows, links), between the two
  ``compaction``, after the last ``finish`` (ids, scatter, counts and
  what the dense path asks for: the sorted runs before the finish wrote
  the row tables, the tables since); ``run_cc_kernels``: the run-CC
  window's device ms by kernel name (each launch of ``csrc/run_cc.cu``:
  ``keys_kernel``, ``prepare_kernel``, ``keep_kernel``,
  ``compact_kernel``, ``roots_kernel``, ``ids_kernel``, and the
  propagation's); and ``run_cc_alone``, the same sub-steps for a call
  of ``run_cc_components`` alone on the batch's wire with neither, whose
  ``finish`` is ids and scatter only, so that the difference is the
  sorted runs' or the tables' cost.

The ``off_bench`` and ``off_dense`` batches are the same first 64
frames' run wires with ``run cc = off`` (the pixel-table branch: the run
wire expanded, the step ``expand runs``: ``run_cc.expand_runs``, or
``detect_pixels._expand_runs`` in a checkout from before it; then the
pixel labels and the finish; the bench batch with the plane the host-rect
path copies, ``readback_pixels``, the dense batch with the device rects
and cv2 centres); ``table_bench`` and ``table_dense`` add ``use table
cc`` (``use_table``: the pixel labels by ``cc.cc_labels_table``; a
checkout from before it refuses them).

The last line is the card's name and power limit from ``nvidia-smi``.
"""

import argparse
import functools
import inspect
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

#: (step name, module attribute, function names) of the wrapped steps;
#: each name the checkout's module has is wrapped
STEPS = (('run-CC', 'rcc', ('run_cc_components',)),
         ('component_stats_runs', 'lb', ('component_stats_runs',)),
         ('stats tail', 'lb', ('_stats_tail_from_tables',)),
         ('hull', 'hull', ('hull_edge_vectors',)),
         ('edge finish', 'lb', ('_hull_edge_data',)),
         ('sweep', 'sweep', ('sweep_extents',)),
         ('rect select', 'lb', ('min_area_rect', 'rect_from_tables')),
         ('cv2 centres', 'dp', ('_cv2_center_override',)),
         ('output', 'dp', ('detections_from_tables',)),
         ('expand runs', 'dp', ('_expand_runs',)),
         ('expand runs', 'rcc', ('expand_runs',)),
         ('pixel labels', 'cc', ('cc_labels_at_pixels', 'cc_labels_table')),
         ('pixel finish', 'dp', ('_compact_ids',)),
         ('pixel finish', 'cc', ('pixel_finish',)),
         ('component_stats', 'lb', ('component_stats',)),
         ('rect mean', 'lum', ('rect_mean_luminosity',)))
STEP_NAMES = tuple(dict.fromkeys(s[0] for s in STEPS))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _setup(root, dev, batch):
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from ysmr_tpu_torch.pipeline import detect_pixels as dp
    os.makedirs(cs.WORK, exist_ok=True)
    if batch.startswith('lum_'):
        return _setup_lum(cs, dp, dev, batch)
    # 'run cc = off' and, for the table batches, use_table
    off = batch.startswith(('off_', 'table_'))
    if batch.endswith('dense'):
        settings = cs.dense_settings()
        scene = cs.BenchScene(seed=cs.DENSE_SEED, n_bugs=cs.DENSE_BUGS)
        path = dict(cv2_centers=True)
    else:
        settings = cs.bench_settings()
        scene = cs.BenchScene()
        path = dict(return_det_px=True, skip_rect=True, det_px_as_runs=True)
    packed, counts = cs.packed_batch(scene, settings)
    runs, rc = cs.encode(packed, counts, cs.W, None)
    t = runs.shape[0]
    # stage_detect's width of the plane it copies to the host
    rb = min(runs.shape[1], max(64, 1 << max(int(rc.max()) - 1,
                                             1).bit_length()))
    readback = batch == 'bench' and 'readback_runs' in inspect.signature(
        dp.detect_from_pixels).parameters
    if readback:
        path = dict(readback_runs=rb)
    elif off and not batch.endswith('dense'):
        path = dict(readback_pixels=cs.pixel_bucket(counts, packed.shape[1]))
    if batch.startswith('table_'):
        path['use_table'] = True
    kw = dict(px_x=None, px_y=None, px_marker=None,
              frame_valid=torch.ones(t, dtype=torch.bool, device=dev),
              px_counts=torch.from_numpy(counts).to(dev),
              px_runs=torch.from_numpy(runs.view(np.int32)).to(dev),
              run_counts=torch.from_numpy(rc).to(dev),
              expanded_f=packed.shape[1], use_run_cc=not off,
              h=cs.H, w=cs.W, double_threshold=True,
              max_det=settings['max detections per frame'],
              max_bh=settings['max bounding box height'],
              cc_iters=settings['connected components max iterations'],
              **path)
    if batch == 'bench' and not readback:
        # a checkout from before the plane: stage_detect's slice, casts
        # and concatenation after the detect

        def call():
            out = dp.detect_from_pixels(**kw)
            return {'readback': torch.cat(
                [out['det_run_idx'][:, :rb],
                 out['n_components'].clamp(max=32767)[:, None].to(
                     torch.int16),
                 out['cc_steps'][:, None].to(torch.int16)], dim=1)}
        return dp, call, kw
    return dp, lambda: dp.detect_from_pixels(**kw), kw


def _setup_lum(cs, dp, dev, batch):
    """The luminosity batches (see the module docstring)."""
    from ysmr_tpu_torch import native
    from ysmr_tpu_torch.ops import luminosity as lum
    if batch == 'lum_dense':
        settings = cs.dense_settings()
        scene = cs.BenchScene(seed=cs.DENSE_SEED, n_bugs=cs.DENSE_BUGS)
    else:
        settings = cs.bench_settings()
        scene = cs.BenchScene()
    pre = cs.HostPreprocessor({**settings, **cs.LUM}, cs.FPS,
                              max_fg=settings['max foreground pixels per '
                                              'frame'])
    tabs = [pre(scene.frame(i)) for i in range(64)]
    counts = np.array([tb['count'] for tb in tabs], np.int32)
    wire = {}
    for k in ('px_x', 'px_y', 'px_marker'):
        wire[k] = np.stack([tb[k] for tb in tabs])
        wire[k][np.arange(wire[k].shape[1])[None, :] >= counts[:, None]] = 0
    gray = torch.from_numpy(np.stack([tb['gray'] for tb in tabs])).to(dev)
    t = len(counts)
    kw = dict({k: torch.from_numpy(v).to(dev) for k, v in wire.items()},
              frame_valid=torch.ones(t, dtype=torch.bool, device=dev),
              px_counts=torch.from_numpy(counts).to(dev), h=cs.H, w=cs.W,
              double_threshold=pre.mode == 'adaptive_double',
              max_det=settings['max detections per frame'],
              max_bh=settings['max bounding box height'],
              cc_iters=settings['connected components max iterations'])
    if batch == 'lum_dense':
        kw.update(include_luminosity=True, gray_frames=gray, lum_win=48,
                  cv2_centers=True)
        return dp, lambda: dp.detect_from_pixels(**kw), kw
    f = wire['px_x'].shape[1]
    fb = min(f, max(256, 1 << max(int(counts.max()) - 1, 1).bit_length()))
    plane = 'readback_pixels' in inspect.signature(
        dp.detect_from_pixels).parameters

    def detect():
        if plane:
            return dp.detect_from_pixels(**kw, readback_pixels=fb)['readback']
        out = dp.detect_from_pixels(**kw, return_det_px=True, skip_rect=True)
        return torch.cat(
            [out['det_px_idx'][:, :fb],
             out['n_components'].clamp(max=32767)[:, None].to(torch.int16),
             out['cc_steps'][:, None].to(torch.int16)], dim=1)

    det = np.ascontiguousarray(detect().cpu().numpy()[:, :-2])
    packed = wire['px_y'][:, :fb].astype(np.uint32) * np.uint32(cs.W) + \
        wire['px_x'][:, :fb].astype(np.uint32)
    rects, rvalid = native.cv2_rects_batch(
        np.ascontiguousarray(packed), counts, det, cs.W, kw['max_det'])
    rects = np.where(rvalid[..., None], rects, np.float32(0))
    # finish_detect's layout of the rects it uploads: the checkout's own
    # (contiguous columns where its rect mean asks for them)
    columns = hasattr(lum, 'rect_mean_luminosity_plain')
    if columns:
        rects = np.moveaxis(rects, -1, 0)

    def call():
        readback = detect()
        r = torch.from_numpy(np.ascontiguousarray(rects)).to(
            dev, non_blocking=True)
        v = torch.from_numpy(rvalid).to(dev, non_blocking=True)
        if columns:
            lum_v = lum.rect_mean_luminosity(gray, *r, v, win=48)
            xy = torch.stack([r[0], r[1], lum_v], dim=-1)
        else:
            lum_v = lum.rect_mean_luminosity(
                gray, r[..., 0], r[..., 1], r[..., 2], r[..., 3], r[..., 4],
                v, win=48)
            xy = torch.cat([r[..., :2], lum_v[..., None]], dim=-1)
        return {'readback': readback, 'det_xy': xy}
    return dp, call, kw


def _syncs(fn):
    """The host synchronisations of one call of ``fn``: the warnings
    ``torch.cuda.set_sync_debug_mode('warn')`` raises in it."""
    import warnings
    fn()
    _sync()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            fn()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    return sum('synchroniz' in str(w.message) for w in caught)


def cs_ms(fn, reps=20):
    """Median CUDA-event ms of ``fn()`` after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _host_ms(fn, reps=10):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _device_events(prof):
    gpu = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == gpu and
            not e.name.startswith('step: ')]


def _wrap(fn, name):
    """``fn`` inside the step's window; its attributes (a kernel wrapper's
    ``launches``) carried over."""
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        _sync()       # the caller's work ends before the window opens
        with record_function('step: ' + name):
            out = fn(*args, **kwargs)
            _sync()
        return out
    return wrapped


PROP = 'run-CC propagation'


def _run_cc_part(ev_start, props):
    """The run-CC sub-step of a device operation that starts at
    ``ev_start`` inside a run-CC window outside its propagations
    (``props``: that window's propagation windows, in order)."""
    done = sum(1 for p in props if p[2] <= ev_start)
    if len(props) == 2:
        return ('prepare', 'compaction', 'finish')[done]
    return ('prepare', 'finish')[min(done, 1)]


def _split(prof):
    """Per-step device operations, device ms, exclusive span ms and
    kernels of one profiled pass, run-CC's by sub-step, and the run-CC
    window's device ms by kernel."""
    cpu = torch.autograd.DeviceType.CPU
    wins = [(e.name[len('step: '):], e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cpu and
            e.name.startswith('step: ')]

    def innermost(t):
        inside = [w for w in wins if w[1] <= t < w[2]]
        return min(inside, key=lambda w: w[2] - w[1]) if inside else None

    def parent(w):
        outer = [o for o in wins if o is not w and o[1] <= w[1] and
                 w[2] <= o[2] and o[2] - o[1] > w[2] - w[1]]
        return min(outer, key=lambda o: o[2] - o[1]) if outer else None

    def new():
        return {'device_ops': 0, 'device_ms': 0.0, 'span_ms': 0.0,
                'kernels': Counter()}

    per, sub, kernels = {}, {}, Counter()
    for w in wins:
        if w[0] == PROP:
            continue
        per.setdefault(w[0], new())['span_ms'] += (w[2] - w[1]) / 1e3
        up = parent(w)
        if up is not None and up[0] != PROP:
            per.setdefault(up[0], new())['span_ms'] -= (w[2] - w[1]) / 1e3
    for ev in _device_events(prof):
        start = ev.time_range.start
        w = innermost(start)
        ms = ev.time_range.elapsed_us() / 1e3
        if w and w[0] == PROP:
            cc = parent(w)
            props = sorted(p for p in wins if p[0] == PROP and
                           cc[1] <= p[1] and p[2] <= cc[2])
            part = ('4-conn propagation' if len(props) == 2 and
                    props[0] == w else '8-conn propagation')
            w = cc
        elif w and w[0] == 'run-CC':
            props = sorted(p for p in wins if p[0] == PROP and
                           w[1] <= p[1] and p[2] <= w[2])
            part = _run_cc_part(start, props)
        else:
            part = None
        if part is not None:
            kernels[ev.name] += ms
        for name, table in ((w[0] if w else 'detect', per),
                            (part, sub)):
            if name is None:
                continue
            rec = table.setdefault(name, new())
            rec['device_ops'] += 1
            rec['device_ms'] += ms
            rec['kernels'][ev.name] += ms
    return per, sub, kernels


def _medians(runs, names, keys=('device_ops', 'device_ms', 'span_ms')):
    """Each step's medians over the passes and its last pass's three
    longest kernels; 0 for a step no pass reached."""
    out = {}
    for name in names:
        recs = [r.get(name) for r in runs]
        if all(r is None for r in recs):
            out[name] = dict({k: 0 for k in keys}, top_kernels={})
            continue
        if any(r is None for r in recs):
            continue
        out[name] = {k: float(np.median([r[k] for r in recs])) for k in keys}
        out[name]['device_ops'] = int(out[name]['device_ops'])
        out[name]['top_kernels'] = {
            k[:60]: round(v, 4) for k, v in
            recs[-1]['kernels'].most_common(3)}
    return out


SUB_STEPS = ('prepare', '4-conn propagation', 'compaction',
             '8-conn propagation', 'finish')


def measure(root, passes, batch='dense', dev='cuda'):
    """The JSON record of one checkout and batch (see the module
    docstring)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    dp, call, kw = _setup(root, torch.device(dev), batch)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    rec = {'root': root, 'batch': batch, 'detect_ms': _host_ms(call)}
    ops, dev_ms = [], []
    for _ in range(passes):
        _sync()
        with profile(activities=acts) as prof:
            want = call()
            _sync()
        evs = _device_events(prof)
        ops.append(len(evs))
        dev_ms.append(sum(e.time_range.elapsed_us() for e in evs) / 1e3)
    rec['device_ops'] = int(np.median(ops))
    rec['device_ms'] = float(np.median(dev_ms))
    rec['detect_syncs'] = _syncs(call)
    mods = {'dp': dp}
    from ysmr_tpu_torch.ops import cc, hull, sweep
    from ysmr_tpu_torch.ops import labeling as lb
    from ysmr_tpu_torch.ops import luminosity as lum
    from ysmr_tpu_torch.ops import run_cc as rcc
    from ysmr_tpu_torch.ops import run_prop
    mods.update(lb=lb, rcc=rcc, hull=hull, sweep=sweep, prop=run_prop, cc=cc,
                lum=lum)
    steps = STEPS + ((PROP, 'prop', ('propagate_min_fused',)),)
    wrapped = [(name, mods[m], f) for name, m, names in steps
               for f in names if hasattr(mods[m], f)]
    saved = [(mod, f, getattr(mod, f)) for _, mod, f in wrapped]
    for (name, mod, f), (_, _, fn) in zip(wrapped, saved):
        setattr(mod, f, _wrap(fn, name))
    lum_args = []
    try:
        def wrapped_call():
            _sync()
            with record_function('step: detect'):
                out = call()
                _sync()
            return out
        seen = lum.rect_mean_luminosity

        @functools.wraps(seen)
        def spy(*args, **kwargs):
            lum_args.append((args, kwargs))
            return seen(*args, **kwargs)
        lum.rect_mean_luminosity = spy
        got = wrapped_call()
        lum.rect_mean_luminosity = seen
        for key in want:
            if not torch.equal(want[key], got[key]):
                raise SystemExit('the split differs from the call in '
                                 '{}'.format(key))
        runs, subs, kerns = [], [], []
        for _ in range(passes):
            with profile(activities=acts) as prof:
                wrapped_call()
            per, sub, kernels = _split(prof)
            runs.append(per)
            subs.append(sub)
            kerns.append(kernels)
        # run-CC alone on the same wire, without the sorted runs or tables
        alone = []
        if 'px_runs' in kw and kw['use_run_cc']:
            cc_kw = dict(w=kw['w'], double_threshold=kw['double_threshold'],
                         max_iters=kw['cc_iters'])
            rc_eff = kw['run_counts'].to(torch.int32)
            for _ in range(passes):
                with profile(activities=acts) as prof:
                    rcc.run_cc_components(kw['px_runs'], rc_eff, **cc_kw)
                    _sync()
                alone.append(_split(prof)[1])
    finally:
        for mod, f, fn in saved:
            setattr(mod, f, fn)
    if lum_args:
        # the rect mean alone on the arguments the batch gave it
        args, kwargs = lum_args[0]

        def lum_call():
            return lum.rect_mean_luminosity(*args, **kwargs)
        ops, dev_ms = [], []
        for _ in range(passes):
            _sync()
            with profile(activities=acts) as prof:
                lum_call()
                _sync()
            evs = _device_events(prof)
            ops.append(len(evs))
            dev_ms.append(sum(e.time_range.elapsed_us() for e in evs) / 1e3)
        rec['rect_mean'] = {
            'slots': list(args[1].shape), 'valid': int(args[6].sum()),
            'gray': str(args[0].dtype), 'device_ops': int(np.median(ops)),
            'device_ms': float(np.median(dev_ms)),
            'event_ms': cs_ms(lum_call), 'syncs': _syncs(lum_call)}
    rec['split'] = _medians(runs, ('detect',) + STEP_NAMES)
    keys = ('device_ops', 'device_ms')
    rec['run_cc'] = _medians(subs, SUB_STEPS, keys)
    rec['run_cc_kernels'] = {
        k[:60]: round(float(np.median([c.get(k, 0.0) for c in kerns])), 4)
        for k in sorted(set().union(*kerns))}
    if alone:
        rec['run_cc_alone'] = _medians(alone, SUB_STEPS, keys)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--roots', default=HERE,
                    help='comma-separated checkouts, run in this order')
    ap.add_argument('--passes', type=int, default=3,
                    help='profiled passes per checkout (medians)')
    ap.add_argument('--batches', default='dense,bench',
                    help='comma-separated batches: dense, bench, lum_bench, '
                    'lum_dense, off_bench, off_dense, table_bench, '
                    'table_dense')
    ap.add_argument('--one', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this script measures the card')
    if args.one:
        for batch in args.batches.split(','):
            print(json.dumps(measure(args.one, args.passes, batch)),
                  flush=True)
        return
    for root in args.roots.split(','):
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               '--one', root, '--passes', str(args.passes),
                               '--batches', args.batches],
                              cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit('{} failed:\n{}'.format(root,
                                                     proc.stderr[-4000:]))
        for line in proc.stdout.strip().splitlines():
            if line.startswith('{'):
                print(line, flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == '__main__':
    main()
