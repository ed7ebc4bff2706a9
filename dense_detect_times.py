#!/usr/bin/env python3
"""Dense detect of the port on one NVIDIA card: its device operations and
device time, split by step, for one or more checkouts in turns.

Run from the root of a checkout::

    python3 dense_detect_times.py [--roots DIR,DIR,...] [--passes 3]

``--roots`` lists checkouts in the order to run them (default: this one),
e.g. ``.scratch/parent,.,.,.scratch/parent`` after unpacking the other
tree with ``git archive <commit> | tar -x -C .scratch/parent``. Each runs
in a process of its own that imports that checkout's ``ysmr_tpu_torch``
and ``chip_smoke.py`` and prints one JSON line.

The batch is the dense scene's first 64 frames (1228x922, 3000 rods, seed
125) as the pipeline's run wire, at ``bench.py:624-631``'s capacities
(4096 detections, ``max_bh`` 48, 131072 foreground pixels): run-CC,
device rects and cv2 centres, as ``track_bacteria`` calls
``detect_from_pixels`` on the dense path. The record holds:

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
  (``run_cc_components``), ``component_stats_runs`` (the row-table
  scatters), ``stats tail`` (count and candidate points), ``hull``
  (``hull_edge_vectors``), ``edge finish`` (the rest of
  ``_hull_edge_data``), ``sweep`` (``sweep_extents``), ``rect select``
  (the rest of ``min_area_rect``), ``cv2 centres``
  (``_cv2_center_override``), ``output`` (the rest of
  ``detections_from_tables``) and ``detect`` (the rest of the call). The
  split's outputs are held to the plain call's.

The last line is the card's name and power limit from ``nvidia-smi``.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

#: (step name, module attribute, function name) of the wrapped steps
STEPS = (('run-CC', 'rcc', 'run_cc_components'),
         ('component_stats_runs', 'lb', 'component_stats_runs'),
         ('stats tail', 'lb', '_stats_tail_from_tables'),
         ('hull', 'hull', 'hull_edge_vectors'),
         ('edge finish', 'lb', '_hull_edge_data'),
         ('sweep', 'sweep', 'sweep_extents'),
         ('rect select', 'lb', 'min_area_rect'),
         ('cv2 centres', 'dp', '_cv2_center_override'),
         ('output', 'dp', 'detections_from_tables'))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _setup(root, dev):
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from ysmr_tpu_torch.pipeline import detect_pixels as dp
    os.makedirs(cs.WORK, exist_ok=True)
    settings = cs.dense_settings()
    scene = cs.BenchScene(seed=cs.DENSE_SEED, n_bugs=cs.DENSE_BUGS)
    packed, counts = cs.packed_batch(scene, settings)
    runs, rc = cs.encode(packed, counts, cs.W, None)
    t = runs.shape[0]
    kw = dict(px_x=None, px_y=None, px_marker=None,
              frame_valid=torch.ones(t, dtype=torch.bool, device=dev),
              px_counts=torch.from_numpy(counts).to(dev),
              px_runs=torch.from_numpy(runs.view(np.int32)).to(dev),
              run_counts=torch.from_numpy(rc).to(dev),
              expanded_f=packed.shape[1], use_run_cc=True, cv2_centers=True,
              h=cs.H, w=cs.W, double_threshold=True,
              max_det=settings['max detections per frame'],
              max_bh=settings['max bounding box height'],
              cc_iters=settings['connected components max iterations'])
    return dp, lambda: dp.detect_from_pixels(**kw)


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


def _split(prof):
    """Per-step device operations, device ms, exclusive span ms and
    kernels of one profiled pass."""
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

    per = {}
    for w in wins:
        per.setdefault(w[0], new())['span_ms'] += (w[2] - w[1]) / 1e3
        up = parent(w)
        if up is not None:
            per.setdefault(up[0], new())['span_ms'] -= (w[2] - w[1]) / 1e3
    for ev in _device_events(prof):
        w = innermost(ev.time_range.start)
        name = w[0] if w else 'detect'
        rec = per.setdefault(name, new())
        ms = ev.time_range.elapsed_us() / 1e3
        rec['device_ops'] += 1
        rec['device_ms'] += ms
        rec['kernels'][ev.name] += ms
    return per


def measure(root, passes, dev='cuda'):
    """The JSON record of one checkout (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    dp, call = _setup(root, torch.device(dev))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    rec = {'root': root, 'detect_ms': _host_ms(call)}
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
    mods = {'dp': dp}
    from ysmr_tpu_torch.ops import hull, sweep
    from ysmr_tpu_torch.ops import labeling as lb
    from ysmr_tpu_torch.ops import run_cc as rcc
    mods.update(lb=lb, rcc=rcc, hull=hull, sweep=sweep)
    saved = [(mods[m], f, getattr(mods[m], f)) for _, m, f in STEPS]
    for (name, m, f), (_, _, fn) in zip(STEPS, saved):
        setattr(mods[m], f, _wrap(fn, name))
    try:
        def wrapped_call():
            _sync()
            with record_function('step: detect'):
                out = call()
                _sync()
            return out
        got = wrapped_call()
        for key in want:
            if not torch.equal(want[key], got[key]):
                raise SystemExit('the split differs from the call in '
                                 '{}'.format(key))
        runs = []
        for _ in range(passes):
            with profile(activities=acts) as prof:
                wrapped_call()
            runs.append(_split(prof))
    finally:
        for mod, f, fn in saved:
            setattr(mod, f, fn)
    split = {}
    for name in ['detect'] + [s[0] for s in STEPS]:
        recs = [r.get(name) for r in runs]
        if any(r is None for r in recs):
            continue
        split[name] = {k: float(np.median([r[k] for r in recs]))
                       for k in ('device_ops', 'device_ms', 'span_ms')}
        split[name]['device_ops'] = int(split[name]['device_ops'])
        split[name]['top_kernels'] = {
            k[:60]: round(v, 4) for k, v in
            recs[-1]['kernels'].most_common(3)}
    rec['split'] = split
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--roots', default=HERE,
                    help='comma-separated checkouts, run in this order')
    ap.add_argument('--passes', type=int, default=3,
                    help='profiled passes per checkout (medians)')
    ap.add_argument('--one', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this script measures the card')
    if args.one:
        print(json.dumps(measure(args.one, args.passes)), flush=True)
        return
    for root in args.roots.split(','):
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               '--one', root, '--passes', str(args.passes)],
                              cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit('{} failed:\n{}'.format(root,
                                                     proc.stderr[-4000:]))
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == '__main__':
    main()
