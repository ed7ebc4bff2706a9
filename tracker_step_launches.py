#!/usr/bin/env python3
"""Kernel launches and wall time of the port's tracker frame step on one
NVIDIA card.

Run from the root of a checkout::

    python3 tracker_step_launches.py [--root DIR] [--videos 1,4]

It imports ``ysmr_tpu_torch`` from ``DIR`` (default: this checkout), so
two trees can be compared in one call on one card (unpack the other with
``git archive <commit> | tar -x -C .scratch/parent``). The tables have
the dense scene's capacities (4096 slots, 4096 detections a frame, K = 2,
the GSFF bank of the default tracking.ini) and hold 3000 seeded
detections drifting by about a pixel a frame. After a warm-up scan,
``torch.profiler`` (CPU and CUDA activities) records a scan of one frame
and one of two frames, each until two of its profiles list the same
device operations (the profiler now and then drops or adds some); their
difference is one frame step, the rest the scan's own work (its checks
and buffers), and the step's device operations (kernels, memsets,
copies) are listed by name: 4 on the card with GSFF (assign, the frame
step's rank and update, GSFF, whose kernel writes the live slots'
positions itself; 5 in a checkout with the separate merge). Then five
16-frame scans are timed on the host clock with the card synchronised
(median and each).
``--videos 4`` also runs the step over four videos at once (a tree whose
``run_tracker_scan`` takes a leading video axis); ``--dims 2,3`` also
with luminosity's third coordinate. Prints one JSON line per (K, V),
then the card's name and power limit from ``nvidia-smi``.
``chip_smoke.py`` calls ``measure`` (phase 29).
"""

import argparse
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

SLOTS, DETS, LIVE = 4096, 4096, 3000
#: profiles at most of each scan, until two list the same device operations
PROFILES = 5


def tables(rng, t_len, v, dev, k=2):
    """(V, T, C, K) drifting detections (a third coordinate, luminosity's,
    drifting as the positions do), (V, T, C, 3) sizes, (V, T, C)
    validity: LIVE valid detections a frame."""
    xy = rng.uniform(0, 1228, (v, 1, DETS, k))
    xy = xy + np.cumsum(rng.normal(0, 1.0, (v, t_len, DETS, k)), axis=1)
    info = rng.uniform(1, 8, (v, t_len, DETS, 3))
    valid = np.zeros((v, t_len, DETS), bool)
    valid[..., :LIVE] = True
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (xy.astype(np.float32), info.astype(np.float32), valid)]


def count(prof):
    """(device kernels, device memsets and copies, runtime launch calls)
    of a profile, and a Counter of its device operations by name."""
    kernels = memops = launches = 0
    names = Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] += 1
            if e.name.startswith(('Memset', 'Memcpy')):
                memops += 1
            else:
                kernels += 1
        elif 'LaunchKernel' in e.name:
            launches += 1
    return (kernels, memops, launches), names


def measure(trk, params, v, dev, k=2):
    """One dense frame step of ``trk`` (a checkout's
    ``ysmr_tpu_torch.pipeline.tracker``) at V videos, K coordinates, with
    the GSFF bank ``params``: the device kernels, memsets and copies and
    runtime launch calls of the step and of a one-frame scan, and the
    host-clock ms per frame step of five 16-frame scans (median and
    each)."""
    from torch.profiler import ProfilerActivity, profile
    kwargs = dict(max_disappeared=30.0, use_gsff=True,
                  **trk.gsff_kwargs(params, dev))
    data = tables(np.random.default_rng(0), 24, v, dev, k)

    def frames(a, b):
        return [x[0, a:b] if v == 1 else x[:, a:b] for x in data]

    state = trk.init_tracker_state(SLOTS, dev, dims=k, use_gsff=True,
                                   gsff_params=params)
    if v > 1:
        state = {k: (torch.stack([x] * v) if torch.is_tensor(x) else
                     {g: torch.stack([y] * v) for g, y in x.items()})
                 for k, x in state.items()}
    state, _ = trk.run_tracker_scan(state, *frames(0, 4), **kwargs)
    counts, names, totals = {}, {}, {}
    for n in (1, 2):
        # a profile now and then records no device operation at all, or
        # another number of them than the same scan's other profiles (both
        # seen on the H100 after many profiles in one process): profile the
        # scan until two profiles list the same device operations, at most
        # PROFILES times, and keep those; with no two alike they are None
        counts[n] = names[n] = None
        totals[n], earlier = [], []
        for _ in range(PROFILES):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                trk.run_tracker_scan(state, *frames(4, 4 + n), **kwargs)
                torch.cuda.synchronize()
            got, ops = count(prof)
            totals[n].append(got[0] + got[1])
            if not got[0] + got[1]:
                continue
            if ops in earlier:
                counts[n], names[n] = got, ops
                break
            earlier.append(ops)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trk.run_tracker_scan(state, *frames(4, 20), **kwargs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / 16 * 1e3)
    keys = ('kernels', 'memops', 'launch_calls')
    stable = counts[1] is not None and counts[2] is not None
    step = [b - a for a, b in zip(counts[1], counts[2])] if stable else None
    return {'frame_step': dict(zip(keys, step)) if stable else None,
            'frame_step_ops': dict(sorted((names[2] - names[1]).items()))
            if stable else None,
            'scan_of_one_frame': dict(zip(keys, counts[1]))
            if counts[1] is not None else None,
            'device_ops_of_each_profile': {'one_frame': totals[1],
                                           'two_frames': totals[2]},
            'ms_per_frame_step': float(np.median(walls)),
            'ms_per_frame_step_each': walls}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=os.path.dirname(os.path.abspath(
        __file__)), help='checkout whose ysmr_tpu_torch is measured')
    ap.add_argument('--videos', default='1',
                    help='comma-separated video counts V (default 1)')
    ap.add_argument('--dims', default='2',
                    help='comma-separated coordinate counts K (default 2; '
                    '3 is luminosity\'s)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this script measures the card')
    sys.path.insert(0, os.path.abspath(args.root))
    from ysmr_tpu_torch.ops.gsff import GSFFParams
    from ysmr_tpu_torch.pipeline import tracker as trk
    dev = torch.device('cuda', 0)
    params = GSFFParams(fps=30.0, n_min=0, n_max=30, n_f=3)
    for k in (int(x) for x in args.dims.split(',')):
        for v in (int(x) for x in args.videos.split(',')):
            print(json.dumps({
                'root': os.path.abspath(args.root), 'videos': v, 'dims': k,
                'slots': SLOTS, 'detections': DETS, 'live': LIVE,
                **measure(trk, params, v, dev, k)}), flush=True)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())


if __name__ == '__main__':
    main()
