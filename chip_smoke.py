#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (ysmr_tpu_torch) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
device, ``nvcc`` and a C++ compiler; it builds what it runs from the
sources in the checkout (into ``ysmr_tpu_torch/.build/``). Phases:

1. environment: card name and power limit, torch and CUDA versions, the
   native host library that loaded (the committed one, or its build);
2. build of the CUDA kernel, timed;
3. kernel against its plain PyTorch version on the card: the run graphs of
   64 bench-sized frames (both the 4-connected marker reconstruction and
   the 8-connected labeling) and seeded random graphs up to R = 131072
   runs (the global-memory variant); labels must be equal, every frame
   must converge; median ms per batch of each;
4. the main path at real size: the bench scene (630 frames of 1228x922,
   200 rods, seed 123, drawn in memory) through the port's stage-1 loop on
   ``cuda`` and then on ``cpu``; the two ``_list.csv`` files must be
   byte-identical, and the kernel must have been launched on the ``cuda``
   run;
5. the public entry point ``track_bacteria(path)`` on the bench clip
   written as MJPG (needs cv2), rows held against the committed reference
   list ``bench_data/bench_clip_list.csv.gz``;
6. the dense path's kernels (hull, sweep, assign) against their plain
   PyTorch versions on the card, outputs bit-equal: hull and sweep on the
   tables of the dense scene's first batch and on seeded random tables,
   assign at 4096x4096 and 16384x16384 with K = 2 and 3 (invalid rows and
   columns, exact ties); median ms of each;
7. the dense path at full width on ``cuda``: the dense scene (150 frames
   of 1228x922, 3000 rods, seed 125; bench.py ``measure_dense_e2e``) in
   memory through the stage-1 loop (stage split), then written as MJPG
   through ``track_bacteria(path)``: every kernel launched, the track
   count within 2899 +- 10, no dropped registration, id agreement against
   ``bench_data/dense_clip_list.csv.gz`` printed;
8. ``cuda`` against ``cpu`` on the dense scene's first batch (64 frames)
   at dense capacities: TRACK_ID and POSITION_T identical, the other
   columns within the stated tolerance;
9. the frames-mode kernels (whole-frame labeling, 4- and 8-connected, and
   the marker reconstruction) against their plain PyTorch versions on the
   card, bit-equal: on the bench scene's first 64 frames thresholded by
   the port's device preprocess at 1228x922, and on seeded random blob
   masks with an all-background frame and a serpentine component far
   longer than 64 propagation steps (held to scipy, and to the plain
   version only where that converged); median ms of each;
10. frames mode (``transfer mode = frames``) at full width on ``cuda``:
   the bench scene in memory (stage split, frames/s), whose ``_list.csv``
   must be byte-identical to the pixels-mode device path's without cv2
   centers on the same frames; the dense scene in memory (stage split);
   the MJPG bench clip through ``track_bacteria(path)``; the MJPG dense
   clip through ``track_bacteria(path)`` (2899 +- 10 tracks, no dropped
   registration; the reference list is the clip's, so the gate is held on
   the clip), with every kernel of the path launched in each clip run;
11. ``cuda`` against ``cpu`` in frames mode on the bench scene's first 16
   frames (a 64-frame batch takes over a minute on the cpu): TRACK_ID and
   POSITION_T identical, the other columns within the stated tolerance.

Any failure ends the script with a non-zero exit before the result line.
The last three lines are the ``kernels`` JSON record, ``nvidia-smi``'s
card name and power limit, and the result JSON.
"""

import configparser
import json
import logging
import os
import queue
import shutil
import subprocess
import sys
import threading
import time

import cv2
import numpy as np
import pandas as pd
import torch

from ysmr_tpu_torch import _build, native
from ysmr_tpu_torch.config import default_config_dict, get_configs
from ysmr_tpu_torch.io.preproc import HostPreprocessor
from ysmr_tpu_torch.ops import assignment, cc, labeling, run_cc
from ysmr_tpu_torch.ops import preprocess as pp
from ysmr_tpu_torch.ops.assign import row_min_argmin
from ysmr_tpu_torch.ops.hull import hull_edge_vectors
from ysmr_tpu_torch.ops.run_prop import propagate_min_fused
from ysmr_tpu_torch.ops.sweep import sweep_extents
from ysmr_tpu_torch.pipeline import detect
from ysmr_tpu_torch.pipeline.track_bacteria import _track_loop, track_bacteria
from ysmr_tpu_torch.utils.csv_io import save_list

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, '.smoke')
W, H, FPS = 1228, 922, 30
N_FRAMES = 630
N_BUGS = 200
SEED = 123
MAX_ITERS = 64
DENSE_FRAMES = 150
DENSE_BUGS = 3000
DENSE_SEED = SEED + 2
DENSE_TRACKS = 2899          # tracks of bench_data/dense_clip_list.csv.gz
#: positions of the device tracker, cuda against cpu: a few float32 ulps
#: of a 1228-px coordinate (tests/test_torch_tracker.py)
POS_TOL = 1e-4


def log(*args):
    print(*args, flush=True)


def bench_settings():
    """tracking.ini defaults with the bench capacities (bench.py)."""
    parser = configparser.ConfigParser(allow_no_value=True)
    for section, values in default_config_dict().items():
        parser[section] = {k: str(v) for k, v in values.items()}
    ini = os.path.join(WORK, 'tracking.ini')
    with open(ini, 'w') as f:
        parser.write(f)
    settings = get_configs(ini)
    settings.update({
        'display video analysis': False, 'user input': False,
        'select files': False, 'save video': False, 'verbose': False,
        'log to file': False, 'rename previous result .csv': False,
        'collate results csv to xlsx': False,
        'max detections per frame': 512, 'max track slots': 1024,
        'max bounding box height': 64, 'frame batch size': 64,
        'max foreground pixels per frame': 8192,
    })
    return settings


def dense_settings():
    """bench.py measure_dense_e2e's capacities: above the 1024-detection
    gate, so the device measures and tracks."""
    settings = bench_settings()
    settings.update({
        'minimal frame count': 32, 'max detections per frame': 4096,
        'max track slots': 4096, 'max bounding box height': 48,
        'max foreground pixels per frame': 131072, 'frame batch size': 64,
    })
    return settings


class BenchScene:
    """The bench clip's scene (bench.py make_clip): seeded rods drifting
    over four noise planes, drawn per frame as grayscale."""

    def __init__(self, seed=SEED, n_bugs=N_BUGS):
        rng = np.random.default_rng(seed)
        self.pos = rng.uniform(30, [W - 30, H - 30], (n_bugs, 2))
        self.vel = rng.uniform(-2.0, 2.0, (n_bugs, 2))
        self.vel[:n_bugs // 3] = 0.0
        self.ang = rng.uniform(0, 180, n_bugs)
        self.noise = rng.normal(40, 4, (4, H, W)).clip(0, 255).astype(
            np.uint8)

    def frame(self, t):
        frame = self.noise[t % 4].copy()
        for i in range(len(self.pos)):
            p = self.pos[i] + self.vel[i] * t
            cv2.ellipse(frame, (int(round(p[0] % W)), int(round(p[1] % H))),
                        (4, 2), float(self.ang[i] + 2 * t * (i % 3)), 0, 360,
                        200, -1)
        return frame


class MemoryReader:
    """Batches of host-thresholded frames from memory, with the attributes
    and the background prefetch of io.video.BatchedVideoReader; with no
    ``preprocess``, batches of BGR frames (frames mode; gray to BGR is
    exact, the gray of (g, g, g) is g)."""

    def __init__(self, frames, preprocess, batch_size, prefetch=3):
        self.frames = frames
        self.preprocess = preprocess
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.height, self.width = frames[0].shape
        self.fps = float(FPS)
        self.frame_count = len(frames)

    def _batches(self):
        bs = self.batch_size
        for s in range(0, len(self.frames), bs):
            if self.preprocess is None:
                chunk = self.frames[s:s + bs]
                batch = np.zeros((bs, self.height, self.width, 3), np.uint8)
                for i, f in enumerate(chunk):
                    batch[i] = cv2.cvtColor(f, cv2.COLOR_GRAY2BGR)
                yield {'frames': batch, 'start': s, 'count': len(chunk)}
                continue
            tabs = [self.preprocess(f) for f in self.frames[s:s + bs]]
            fcap = tabs[0]['px_packed'].shape[0]
            batch = {'count': np.zeros(bs, np.int32),
                     'px_packed': np.zeros((bs, fcap), np.uint32)}
            for i, tab in enumerate(tabs):
                batch['count'][i] = tab['count']
                batch['px_packed'][i] = tab['px_packed']
            yield {'frames': batch, 'start': s, 'count': len(tabs)}

    def __iter__(self):
        q = queue.Queue(maxsize=self.prefetch)

        def work():
            for b in self._batches():
                q.put(b)
            q.put(None)

        thread = threading.Thread(target=work, daemon=True)
        thread.start()
        while True:
            b = q.get()
            if b is None:
                break
            yield b
        thread.join()


def cuda_ms(fn, reps=10):
    """Median milliseconds of ``fn()`` on the card (CUDA events), after two
    warm-up calls."""
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


def graph_inputs(runs, counts, w, connectivity, device):
    """(init, win, link) of one propagation at the shapes run_cc gives the
    kernel: 4-connected with the +R weak init, or 8-connected from iota."""
    geo = run_cc._prepare(torch.from_numpy(runs.view(np.int32)).to(device),
                          torch.from_numpy(counts).to(device), w=w)
    win = run_cc.run_windows(geo, dilate=1 if connectivity == 8 else 0)
    link = run_cc.chain_mask(geo, win)
    t, r = runs.shape
    iota = torch.arange(r, dtype=torch.int32, device=device).expand(t, r)
    init = torch.where(geo['rmark'], iota, iota + r) if connectivity == 4 \
        else iota
    return init.contiguous(), win, link


def compare_kernel(name, runs, counts, w, connectivity, dev):
    init, win, link = graph_inputs(runs, counts, w, connectivity, dev)
    lab, steps = propagate_min_fused(init, win, link, max_iters=MAX_ITERS)
    ref, ref_steps = run_cc.propagate_min(init, win, link,
                                          max_iters=MAX_ITERS)
    torch.cuda.synchronize()
    err = int((lab - ref).abs().max())
    k_steps, p_steps = int(steps.max()), int(ref_steps.max())
    if err or k_steps >= MAX_ITERS or p_steps >= MAX_ITERS:
        raise SystemExit('{}: kernel != plain (max |diff| {}) or not '
                         'converged (steps {} / {})'.format(
                             name, err, k_steps, p_steps))
    ms = cuda_ms(lambda: propagate_min_fused(init, win, link,
                                             max_iters=MAX_ITERS))
    plain_ms = cuda_ms(lambda: run_cc.propagate_min(init, win, link,
                                                    max_iters=MAX_ITERS),
                       reps=5)
    log('kernel check {}: T={} R={} runs<= {} equal, steps kernel {} plain '
        '{}, ms kernel {:.4f} plain {:.4f}'.format(
            name, runs.shape[0], runs.shape[1], int(counts.max()), k_steps,
            p_steps, ms, plain_ms))
    return err, ms, plain_ms


def encode(packed, counts, w, r):
    runs = np.zeros(packed.shape, np.uint32)
    rc = np.zeros(len(counts), np.int32)
    ret = native.encode_runs_batch(packed, counts, runs, rc, w=w)
    if ret is None or ret < 0:
        raise SystemExit('run encoding failed: {}'.format(ret))
    bucket = r or min(packed.shape[1], 1 << max(int(ret) - 1, 1).bit_length())
    return runs[:, :bucket].copy(), rc


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this smoke test runs on a GPU')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log('torch {} cuda {} python {}'.format(
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    log('device {} x{}'.format(torch.cuda.get_device_name(0),
                               torch.cuda.device_count()))
    t0 = time.perf_counter()
    if not native.available():
        raise SystemExit('native host library unavailable')
    log('native library {} ({:.1f} s)'.format(
        native._LIB._name, time.perf_counter() - t0))
    return smi


def phase_build():
    t0 = time.perf_counter()
    lib = _build.load_kernels()
    log('kernel build {:.1f} s: {}'.format(time.perf_counter() - t0,
                                           os.path.relpath(lib.build_path,
                                                           REPO)))
    for line in lib.build_log.splitlines():
        if 'registers' in line or 'spill' in line or \
                'Compiling entry' in line:
            log('  ptxas: ' + line.strip())


def phase_kernel(scene, settings, dev):
    pre = HostPreprocessor(settings, FPS,
                           max_fg=settings['max foreground pixels per frame'])
    t = 64
    packed = np.zeros((t, pre.max_fg), np.uint32)
    counts = np.zeros(t, np.int32)
    for i in range(t):
        tab = pre(scene.frame(i))
        packed[i], counts[i] = tab['px_packed'], tab['count']
    runs, rc = encode(packed, counts, W, None)
    results = [compare_kernel('bench 4-conn', runs, rc, W, 4, dev),
               compare_kernel('bench 8-conn', runs, rc, W, 8, dev)]
    main_ms, main_plain_ms = results[0][1:]
    rng = np.random.default_rng(SEED)
    for t, h, w, r, dens in ((64, 922, 1228, 8192, 0.004),
                             (8, 700, 700, 131072, 0.3),
                             (16, 64, 64, 512, 0.5)):
        packed = np.zeros((t, r), np.uint32)
        counts = np.zeros(t, np.int32)
        for i in range(t):
            yy, xx = np.nonzero(rng.random((h, w)) < dens)
            lin = (yy * w + xx).astype(np.uint32)[:r]
            mk = (rng.random(len(lin)) < 0.3).astype(np.uint32)
            packed[i, :len(lin)] = lin | (mk << 31)
            counts[i] = len(lin)
        runs, rc = encode(packed, counts, w, r)
        for conn in (4, 8):
            results.append(compare_kernel(
                'random {}x{} {}-conn'.format(h, w, conn), runs, rc, w, conn,
                dev))
    if propagate_min_fused.launches <= 0:
        raise SystemExit('the kernel was never launched')
    return max(r[0] for r in results), main_ms, main_plain_ms


def run_loop(scene_frames, settings, device, name):
    pre = None if settings.get('transfer mode') == 'frames' else \
        HostPreprocessor(settings, FPS,
                         max_fg=settings['max foreground pixels per frame'])
    reader = MemoryReader(scene_frames, pre, settings['frame batch size'])
    folder = os.path.join(WORK, name)
    os.makedirs(folder, exist_ok=True)
    _, list_name = save_list(path=os.path.join(folder, 'bench.avi'),
                             result_folder=folder, first_call=True,
                             rename_old_list=False)
    stats = {}
    res = _track_loop(reader, settings, float(FPS), list_name,
                      device=torch.device(device), stats=stats)
    if res is None:
        raise SystemExit('stage-1 loop on {} returned None'.format(device))
    with open(list_name, 'rb') as f:
        return res, f.read(), stats


def phase_main_path(scene, settings):
    t0 = time.perf_counter()
    frames = [scene.frame(t) for t in range(N_FRAMES)]
    log('scene: {} frames of {}x{} drawn in {:.1f} s'.format(
        N_FRAMES, W, H, time.perf_counter() - t0))
    propagate_min_fused.launches = 0
    res, cuda_bytes, stats = run_loop(frames, settings, 'cuda', 'cuda')
    launches = propagate_min_fused.launches
    torch.cuda.synchronize()
    cpu_res, cpu_bytes, cpu_stats = run_loop(frames, settings, 'cpu', 'cpu')
    rows = cuda_bytes.count(b'\n') - 1
    if cuda_bytes != cpu_bytes:
        raise SystemExit('_list.csv differs between cuda and cpu runs')
    if launches <= 0:
        raise SystemExit('the main path launched no kernel')
    if stats['capped_frames'] or cpu_stats['capped_frames']:
        raise SystemExit('frames reached the run-CC iteration cap')
    df = res[0]
    if df.shape[0] != rows or not np.isfinite(
            df[['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                'DEGREES_ANGLE']].to_numpy()).all():
        raise SystemExit('unexpected rows in the returned DataFrame')
    per = {k: round(v / stats['frames'] * 1e3, 4)
           for k, v in stats['stage_s'].items()}
    log('main path: rows {} tracks {} frames {} byte-identical cuda/cpu '
        '_list.csv; kernel launches {}; frames at the iteration cap {}'
        .format(rows, stats['tracks'], stats['frames'], launches,
                stats['capped_frames']))
    log('stage-1 fps cuda {:.2f} cpu {:.2f}'.format(stats['fps'],
                                                   cpu_stats['fps']))
    log('stage split cuda (ms/frame): {}'.format(json.dumps(per)))
    log('stage split cpu (ms/frame): {}'.format(json.dumps(
        {k: round(v / cpu_stats['frames'] * 1e3, 4)
         for k, v in cpu_stats['stage_s'].items()})))
    return launches, frames


def make_clip(path, n_frames, scene=None):
    """bench.py make_clip: a scene written as an MJPG AVI."""
    scene = scene or BenchScene()
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), FPS,
                             (W, H))
    if not writer.isOpened():
        raise SystemExit('cannot open an MJPG writer')
    for t in range(n_frames):
        writer.write(cv2.cvtColor(scene.frame(t), cv2.COLOR_GRAY2BGR))
    writer.release()
    return path


def phase_clip(settings):
    """track_bacteria(path) on the bench clip, rows held against the
    committed reference list as bench.py's check_row_parity does."""
    t0 = time.perf_counter()
    clip = make_clip(os.path.join(WORK, 'bench_clip.avi'), N_FRAMES)
    log('bench clip written in {:.1f} s'.format(time.perf_counter() - t0))
    folder = os.path.join(WORK, 'clip')
    os.makedirs(folder, exist_ok=True)
    t0 = time.perf_counter()
    res = track_bacteria(clip, settings=dict(settings), result_folder=folder)
    elapsed = time.perf_counter() - t0
    if res is None:
        raise SystemExit('track_bacteria(path) returned None')
    ours = res[0]
    ref = pd.read_csv(os.path.join(REPO, 'bench_data',
                                   'bench_clip_list.csv.gz'))
    ref = ref.sort_values(['TRACK_ID', 'POSITION_T'], kind='stable')
    if ours.shape[0] != ref.shape[0]:
        raise SystemExit('bench clip: {} rows, reference {}'.format(
            ours.shape[0], ref.shape[0]))
    for col, atol in (('TRACK_ID', 0), ('POSITION_T', 0),
                      ('POSITION_X', 1e-9), ('POSITION_Y', 1e-9),
                      ('WIDTH', 1e-9), ('HEIGHT', 1e-9),
                      ('DEGREES_ANGLE', 1e-9)):
        diff = np.abs(ours[col].to_numpy(float) - ref[col].to_numpy(float))
        if not (diff <= atol).all():
            raise SystemExit('bench clip: column {} differs from the '
                             'reference list (max {})'.format(
                                 col, float(diff.max())))
    log('bench clip via track_bacteria(path): {} rows, {} tracks, identical '
        'to bench_data/bench_clip_list.csv.gz; {:.2f} fps end to end '
        '(decode included)'.format(ours.shape[0],
                                   ours['TRACK_ID'].nunique(),
                                   N_FRAMES / elapsed))


def kernel_record(name, source, replaces, launches, err, ms, plain_ms):
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': launches, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms}


def max_abs_err(got, want):
    """Largest |kernel - plain| over a kernel's outputs (bools as 0/1)."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise SystemExit('kernel output shape or type differs')
        diff = (g.double() - w.double()).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return err


def check_equal(name, kernel, plain, args, reps=10, plain_reps=5):
    """Kernel against its plain version on the same card tensors: every
    output bit-equal; median ms of each."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit('{}: kernel != plain (max |diff| {})'.format(
            name, max_abs_err(got, want)))
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: kernel(*args), reps=reps)
    plain_ms = cuda_ms(lambda: plain(*args), reps=plain_reps)
    log('kernel check {}: bit-equal, ms kernel {:.4f} plain {:.4f}'.format(
        name, ms, plain_ms))
    return err, ms, plain_ms


def dense_first_batch(scene, settings):
    """The dense scene's first 64 frames: host threshold and run wire."""
    pre = HostPreprocessor(settings, FPS,
                           max_fg=settings['max foreground pixels per frame'])
    t = settings['frame batch size']
    packed = np.zeros((t, pre.max_fg), np.uint32)
    counts = np.zeros(t, np.int32)
    for i in range(t):
        tab = pre(scene.frame(i))
        packed[i], counts[i] = tab['px_packed'], tab['count']
    return encode(packed, counts, W, None)


def dense_tables(runs, rc, settings, dev):
    """Hull and sweep inputs at the shapes the dense path gives them:
    (T * max_det, max_bh) row tables and (T * max_det, K) directions."""
    max_det = settings['max detections per frame']
    max_bh = settings['max bounding box height']
    cc = run_cc.run_cc_components(
        torch.from_numpy(runs.view(np.int32)).to(dev),
        torch.from_numpy(rc).to(dev), w=W, double_threshold=True,
        sorted_runs=True)
    n = cc['n_components']
    comp_rev = torch.where(cc['s_comp'] >= 0,
                           n[:, None] - 1 - cc['s_comp'],
                           torch.full_like(cc['s_comp'], -1))
    tabs = labeling.component_stats_runs(
        cc['s_start'], cc['s_len'], comp_rev, w=W, h=H, max_det=max_det,
        max_bh=max_bh, cv2_centers=True)
    abs_y = (tabs['min_y'][:, None] + torch.arange(
        max_bh, dtype=torch.int32, device=dev)[None, :]).contiguous()
    hull_args = (tabs['row_min_x'], tabs['row_max_x'], tabs['row_valid'],
                 abs_y)
    d = tabs['edge_dx'].shape[0]
    one = torch.ones((d, 1), dtype=torch.float32, device=dev)
    sweep_args = (tabs['points'].contiguous(),
                  tabs['points_valid'].contiguous(),
                  torch.cat([tabs['edge_dx'], one], 1).contiguous(),
                  torch.cat([tabs['edge_dy'], one * 0], 1).contiguous())
    log('dense batch: T={} components {} of {} slots, rows/component {}, '
        'directions {}, points {}'.format(
            runs.shape[0], int(n.clamp(max=max_det).sum()), d, max_bh,
            sweep_args[2].shape[1], sweep_args[0].shape[1]))
    return hull_args, sweep_args


def random_row_tables(rng, d, r, dev):
    """Seeded random row-extreme tables with empty components, short
    components and padding rows."""
    n_rows = rng.integers(1, r + 1, size=d)
    valid = np.arange(r)[None, :] < n_rows[:, None]
    empty = rng.random(d) < 0.15
    valid[empty] = False
    min_y = np.where(empty, 1 << 30, rng.integers(0, 900, size=d))
    abs_y = (min_y[:, None] + np.arange(r)).astype(np.int32)
    cx = rng.integers(0, 1200, size=(d, 1))
    half = rng.integers(0, 30, size=(d, r))
    jitter = rng.integers(-5, 6, size=(d, r))
    lo = (cx + jitter - half).astype(np.int32)
    hi = np.maximum(lo, (cx + jitter + half).astype(np.int32))
    big = 1 << 30
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        np.where(valid, lo, big).astype(np.int32),
        np.where(valid, hi, -big).astype(np.int32), valid, abs_y))


def assign_inputs(rng, r, c, k, dev):
    """Tracker rows and detections with invalid rows and columns, exact
    distance ties and exact zeros."""
    obj = rng.uniform(0, 1228, (r, k)).astype(np.float32)
    det = rng.uniform(0, 1228, (c, k)).astype(np.float32)
    ov = rng.random(r) < 0.6
    dv = rng.random(c) < 0.6
    det[1::7] = det[0::7][:len(det[1::7])]       # duplicated detections
    dv[:8] = True
    obj[::5] = det[rng.integers(0, c, len(obj[::5]))]
    return tuple(torch.from_numpy(a).to(dev) for a in (obj, ov, det, dv))


def phase_dense_kernels(scene, settings, dev):
    runs, rc = dense_first_batch(scene, settings)
    hull_args, sweep_args = dense_tables(runs, rc, settings, dev)
    rng = np.random.default_rng(SEED)
    out = {}
    hull = [check_equal('hull dense batch', hull_edge_vectors,
                        labeling.hull_edge_vectors_plain, hull_args, reps=20)]
    for d, r in ((4096, 48), (16384, 96)):
        hull.append(check_equal(
            'hull random D={} R={}'.format(d, r), hull_edge_vectors,
            labeling.hull_edge_vectors_plain,
            random_row_tables(rng, d, r, dev)))
    out['hull'] = (max(h[0] for h in hull),) + hull[0][1:]
    sweep = [check_equal('sweep dense batch', sweep_extents,
                         labeling.sweep_extents_plain, sweep_args, reps=20)]
    for d, p, k in ((4096, 96, 95), (4096, 192, 191)):
        pts = torch.from_numpy(rng.integers(0, 1228, (d, p, 2)).astype(
            np.float32)).to(dev)
        valid = torch.from_numpy(rng.random((d, p)) < 0.5).to(dev)
        valid[:7] = False
        dx = torch.from_numpy(rng.integers(1, 90, (d, k)).astype(
            np.float32)).to(dev)
        dy = torch.from_numpy(rng.integers(0, 96, (d, k)).astype(
            np.float32)).to(dev)
        sweep.append(check_equal(
            'sweep random D={} P={} K={}'.format(d, p, k), sweep_extents,
            labeling.sweep_extents_plain, (pts, valid, dx, dy)))
    out['sweep'] = (max(x[0] for x in sweep),) + sweep[0][1:]
    assign = []
    for n in (4096, 16384):
        for k in (2, 3):
            assign.append(check_equal(
                'assign {}x{} K={}'.format(n, n, k), row_min_argmin,
                assignment.row_min_argmin_plain,
                assign_inputs(rng, n, n, k, dev), reps=10,
                plain_reps=3 if n > 4096 else 5))
    out['assign'] = (max(a[0] for a in assign),) + assign[0][1:]
    return out


class WarningCounter(logging.Handler):
    """Counts the pipeline's log records that contain a phrase."""

    def __init__(self, phrase):
        super().__init__(logging.WARNING)
        self.phrase = phrase
        self.count = 0

    def emit(self, record):
        if self.phrase in record.getMessage():
            self.count += 1


KERNELS = (propagate_min_fused, hull_edge_vectors, sweep_extents,
           row_min_argmin)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def phase_dense_path(scene, frames, settings):
    """The dense path on cuda: in memory for the stage split, then the
    MJPG clip through track_bacteria(path) with every kernel counted."""
    _, _, stats = run_loop(frames, settings, 'cuda', 'dense_mem')
    per = {k: round(v / stats['frames'] * 1e3, 4)
           for k, v in stats['stage_s'].items()}
    log('dense in memory (cuda): tracks {} frames {} fps {:.2f}, '
        'dropped registrations {}'.format(stats['tracks'], stats['frames'],
                                          stats['fps'],
                                          stats['dropped_registrations']))
    log('dense stage split cuda (ms/frame): {}'.format(json.dumps(per)))
    t0 = time.perf_counter()
    clip = make_clip(os.path.join(WORK, 'dense_clip.avi'), DENSE_FRAMES,
                     scene)
    log('dense clip written in {:.1f} s'.format(time.perf_counter() - t0))
    folder = os.path.join(WORK, 'dense_clip')
    os.makedirs(folder, exist_ok=True)
    dropped = WarningCounter('registrations dropped')
    logging.getLogger('ysmr').addHandler(dropped)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = track_bacteria(clip, settings=dict(settings), result_folder=folder)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    logging.getLogger('ysmr').removeHandler(dropped)
    if res is None:
        raise SystemExit('dense track_bacteria(path) returned None')
    df = res[0]
    tracks = int(df['TRACK_ID'].nunique())
    ref = pd.read_csv(os.path.join(REPO, 'bench_data',
                                   'dense_clip_list.csv.gz'))
    ref = ref.sort_values(['TRACK_ID', 'POSITION_T'], kind='stable')
    # id agreement: the share of the reference's (TRACK_ID, POSITION_T)
    # rows that the port emits too, and of its tracks that the port
    # reproduces frame for frame under the same id
    keys = ['TRACK_ID', 'POSITION_T']
    both = ref[keys + ['POSITION_X', 'POSITION_Y']].merge(
        df[keys + ['POSITION_X', 'POSITION_Y']], on=keys,
        suffixes=('_ref', ''))
    row_agree = both.shape[0] / ref.shape[0]
    ref_frames = ref.groupby('TRACK_ID')['POSITION_T'].apply(tuple)
    our_frames = df.groupby('TRACK_ID')['POSITION_T'].apply(tuple)
    same_tracks = int((ref_frames == our_frames.reindex(
        ref_frames.index)).sum())
    shift = np.hypot(both['POSITION_X'] - both['POSITION_X_ref'],
                     both['POSITION_Y'] - both['POSITION_Y_ref'])
    agreement = ('{:.4f} of reference rows, {} of {} tracks identical in '
                 'frames, position |diff| on shared rows median {:.2e} max '
                 '{:.2e} px'.format(row_agree, same_tracks, len(ref_frames),
                                    float(shift.median()),
                                    float(shift.max())))
    log('dense clip via track_bacteria(path) on cuda: rows {} (reference '
        '{}), tracks {} (reference {}), id agreement {}, {:.2f} fps end to '
        'end (decode included), kernel launches {}, dropped-registration '
        'warnings {}'.format(df.shape[0], ref.shape[0], tracks,
                             ref['TRACK_ID'].nunique(), agreement,
                             DENSE_FRAMES / elapsed, json.dumps(launches),
                             dropped.count))
    if not np.isfinite(df[['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                           'DEGREES_ANGLE']].to_numpy()).all():
        raise SystemExit('dense clip: non-finite values in the rows')
    if abs(tracks - DENSE_TRACKS) > 10:
        raise SystemExit('dense clip: {} tracks, outside {} +- 10'.format(
            tracks, DENSE_TRACKS))
    if dropped.count:
        raise SystemExit('dense clip: registrations were dropped')
    if min(launches.values()) <= 0:
        raise SystemExit('dense clip: a kernel was never launched: {}'.format(
            launches))
    return launches


def phase_dense_cuda_vs_cpu(frames, settings):
    """The dense scene's first batch at dense capacities through the
    stage-1 loop on cuda and on cpu."""
    first = frames[:settings['frame batch size']]
    (cres, _, cstats) = run_loop(first, settings, 'cuda', 'dense_cuda')
    t0 = time.perf_counter()
    (pres, _, pstats) = run_loop(first, settings, 'cpu', 'dense_cpu')
    cpu_s = time.perf_counter() - t0
    same, worst = compare_rows('dense first batch', cres[0], pres[0])
    log('dense first batch cuda vs cpu: {} rows, {} tracks, TRACK_ID and '
        'POSITION_T identical, {} of {} rows byte-identical, max |diff| {}; '
        'cpu loop {:.1f} s, dropped registrations cuda {} cpu {}'.format(
            cres[0].shape[0], cstats['tracks'], same, cres[0].shape[0],
            json.dumps(worst), cpu_s, cstats['dropped_registrations'],
            pstats['dropped_registrations']))


FRAMES = {'transfer mode': 'frames'}
CC_KERNELS = (cc.label_components_whole_frame, cc.binary_reconstruct)
FRAMES_KERNELS = CC_KERNELS + (hull_edge_vectors, sweep_extents,
                               row_min_argmin)


def bench_masks(scene, settings, dev, t=64):
    """Mask and markers of the bench scene's first ``t`` frames through
    the port's device preprocess (BGR upload, gray, blur, thresholds)."""
    bgr = np.stack([cv2.cvtColor(scene.frame(i), cv2.COLOR_GRAY2BGR)
                    for i in range(t)])
    cfg = detect.DetectorConfig(settings)
    blurred = detect.prepare_batch(torch.from_numpy(bgr).to(dev))
    return pp.detect_masks(blurred, cfg.mode, cfg.offset, cfg.double_delta,
                           cfg.white_on_dark)


def snake_mask(h, w):
    """One serpentine component: rows joined at alternating ends, its
    geodesic diameter about h * w / 2 steps."""
    m = np.zeros((h, w), bool)
    for y in range(0, h, 2):
        m[y, 1:w - 1] = True
        if y + 1 < h:
            m[y + 1, w - 2 if (y // 2) % 2 == 0 else 1] = True
    return m


def random_blob_masks(rng, t):
    """Seeded blob masks at 1228x922: rods and ellipses of many sizes,
    frame t - 2 all background, frame t - 1 the serpentine; markers on a
    random tenth of the blobs' pixels."""
    masks = np.zeros((t, H, W), np.uint8)
    for i in range(t - 2):
        for _ in range(int(rng.integers(50, 400))):
            c = (int(rng.integers(0, W)), int(rng.integers(0, H)))
            ax = (int(rng.integers(1, 40)), int(rng.integers(1, 12)))
            cv2.ellipse(masks[i], c, ax, float(rng.uniform(0, 180)), 0, 360,
                        1, -1)
    masks = masks > 0
    masks[t - 1] = snake_mask(H, W)
    markers = masks & (rng.random(masks.shape) < 0.1)
    return masks, markers


def scipy_min_index_labels(mask, connectivity):
    """scipy.ndimage.label as the minimum linear index of each component,
    h * w on the background."""
    from scipy import ndimage
    h, w = mask.shape
    structure = np.ones((3, 3), bool) if connectivity == 8 else None
    lab, n = ndimage.label(mask, structure=structure)
    uniq, first = np.unique(lab.reshape(-1), return_index=True)
    min_idx = np.full(n + 1, h * w, np.int32)
    min_idx[uniq] = first
    min_idx[0] = h * w
    return min_idx[lab]


def check_cc(name, mask, marker, scipy_frames=()):
    """Both cc kernels against their plain versions on the same card
    tensors: labels (4- and 8-connected) and the reconstruction bit-equal
    on every frame whose plain labeling converged; frames in
    ``scipy_frames`` also against scipy. Returns {kernel: (err, ms,
    plain_ms)} and the frames where the plain version did not converge."""
    from scipy import ndimage
    out, unconverged = {}, set()
    steps4 = None
    for conn in (4, 8):
        got = cc.label_components_whole_frame(mask, conn, MAX_ITERS)
        plain, steps = labeling.label_components(mask, conn, MAX_ITERS)
        torch.cuda.synchronize()
        conv = steps < MAX_ITERS
        unconverged |= set(torch.nonzero(~conv).flatten().tolist())
        if conn == 4:
            steps4 = steps
        if not torch.equal(got[conv], plain[conv]):
            raise SystemExit('{} {}-conn: labeling kernel != plain'.format(
                name, conn))
        for i in scipy_frames:
            if not np.array_equal(got[i].cpu().numpy(), scipy_min_index_labels(
                    mask[i].cpu().numpy(), conn)):
                raise SystemExit('{} {}-conn: frame {} != scipy'.format(
                    name, conn, i))
        ms = cuda_ms(lambda: cc.label_components_whole_frame(mask, conn,
                                                             MAX_ITERS))
        plain_ms = cuda_ms(lambda: labeling.label_components(mask, conn,
                                                             MAX_ITERS),
                           reps=3)
        out['label{}'.format(conn)] = (0.0, ms, plain_ms)
        log('kernel check {} label {}-conn: T={} bit-equal on {} of {} '
            'frames (plain steps max {}), ms kernel {:.4f} plain {:.4f}'
            .format(name, conn, mask.shape[0], int(conv.sum()),
                    mask.shape[0], int(steps.max()), ms, plain_ms))
    got = cc.binary_reconstruct(mask, marker, MAX_ITERS)
    plain = labeling.propagate_markers(mask, marker, MAX_ITERS)
    torch.cuda.synchronize()
    conv = steps4 < MAX_ITERS
    if not torch.equal(got[conv], plain[conv]):
        raise SystemExit('{}: reconstruction kernel != plain'.format(name))
    for i in scipy_frames:
        m, k = mask[i].cpu().numpy(), marker[i].cpu().numpy()
        if not np.array_equal(got[i].cpu().numpy(),
                              ndimage.binary_propagation(k & m, mask=m)):
            raise SystemExit('{}: reconstruction frame {} != scipy'.format(
                name, i))
    ms = cuda_ms(lambda: cc.binary_reconstruct(mask, marker, MAX_ITERS))
    plain_ms = cuda_ms(lambda: labeling.propagate_markers(
        mask, marker, MAX_ITERS), reps=3)
    out['reconstruct'] = (0.0, ms, plain_ms)
    log('kernel check {} reconstruct: bit-equal on {} of {} frames, kept {} '
        'of {} mask pixels, ms kernel {:.4f} plain {:.4f}'.format(
            name, int(conv.sum()), mask.shape[0], int(got.sum()),
            int(mask.sum()), ms, plain_ms))
    return out, unconverged


def phase_cc_kernels(scene, settings, dev):
    mask, marker = bench_masks(scene, settings, dev)
    log('bench batch thresholded on the card: T={} {}x{}, mask pixels {}, '
        'marker pixels {}'.format(mask.shape[0], W, H, int(mask.sum()),
                                  int(marker.sum())))
    main, unconv = check_cc('bench', mask, marker & mask)
    if unconv:
        raise SystemExit('bench batch: plain labeling did not converge on '
                         'frames {}'.format(sorted(unconv)))
    rng = np.random.default_rng(SEED)
    t = 8
    masks, markers = random_blob_masks(rng, t)
    _, unconv = check_cc('random blobs', torch.from_numpy(masks).to(dev),
                         torch.from_numpy(markers).to(dev),
                         scipy_frames=range(t))
    if len(unconv) > t // 2:
        raise SystemExit('random blobs: plain labeling did not converge on '
                         'frames {}'.format(sorted(unconv)))
    log('random blobs: every frame held to scipy; frames {} (the serpentine '
        'is frame {}, {} px in one component) did not converge in the plain '
        'version in {} steps and are held to scipy only'.format(
            sorted(unconv), t - 1, int(masks[t - 1].sum()), MAX_ITERS))
    return {'label_components_whole_frame': main['label8'],
            'binary_reconstruct': main['reconstruct']}


def reset_frames_launches():
    for k in FRAMES_KERNELS:
        k.launches = 0


def frames_launches(what):
    launches = {k.__name__: k.launches for k in FRAMES_KERNELS}
    if min(launches.values()) <= 0:
        raise SystemExit('{}: a kernel of the frames path was never '
                         'launched: {}'.format(what, launches))
    return launches


def phase_frames_path(frames, settings, dframes, dsettings):
    """Frames mode on cuda: the bench scene in memory against the
    pixels-mode device path without cv2 centers, the dense scene in memory
    (stage split), then both MJPG clips through track_bacteria(path)."""
    fsettings = {**settings, **FRAMES}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, fbytes, stats = run_loop(frames, fsettings, 'cuda', 'frames_mem')
    torch.cuda.synchronize()
    log('frames mode bench scene in memory (cuda): rows {} tracks {} frames '
        '{} fps {:.2f} ({:.1f} s)'.format(
            fbytes.count(b'\n') - 1, stats['tracks'], stats['frames'],
            stats['fps'], time.perf_counter() - t0))
    log('frames stage split cuda (ms/frame): {}'.format(json.dumps(
        {k: round(v / stats['frames'] * 1e3, 4)
         for k, v in stats['stage_s'].items()})))
    pixels = {**settings, 'cv2 exact rects': False, 'cv2 exact centers': 'off'}
    _, pbytes, pstats = run_loop(frames, pixels, 'cuda', 'pixels_mem')
    if fbytes != pbytes:
        raise SystemExit('frames mode _list.csv differs from the pixels-mode '
                         'device path without cv2 centers')
    if not np.isfinite(res[0][['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                               'DEGREES_ANGLE']].to_numpy()).all():
        raise SystemExit('frames mode: non-finite values in the rows')
    log('frames mode _list.csv byte-identical to the pixels-mode device path '
        'without cv2 centers ({} rows; pixels fps {:.2f})'.format(
            fbytes.count(b'\n') - 1, pstats['fps']))
    _, _, stats = run_loop(dframes, {**dsettings, **FRAMES}, 'cuda',
                           'frames_dense_mem')
    log('frames mode dense scene in memory (cuda): tracks {} frames {} fps '
        '{:.2f}, dropped registrations {}; stage split (ms/frame): {}'.format(
            stats['tracks'], stats['frames'], stats['fps'],
            stats['dropped_registrations'], json.dumps(
                {k: round(v / stats['frames'] * 1e3, 4)
                 for k, v in stats['stage_s'].items()})))
    out = {}
    for name, clip, sets, n_frames in (
            ('bench', 'bench_clip.avi', fsettings, N_FRAMES),
            ('dense', 'dense_clip.avi', {**dsettings, **FRAMES},
             DENSE_FRAMES)):
        folder = os.path.join(WORK, 'frames_' + name)
        os.makedirs(folder, exist_ok=True)
        dropped = WarningCounter('registrations dropped')
        logging.getLogger('ysmr').addHandler(dropped)
        torch.cuda.synchronize()
        reset_frames_launches()
        t0 = time.perf_counter()
        res = track_bacteria(os.path.join(WORK, clip), settings=dict(sets),
                             result_folder=folder)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = frames_launches('frames {} clip'.format(name))
        logging.getLogger('ysmr').removeHandler(dropped)
        if res is None:
            raise SystemExit('frames {} clip: track_bacteria(path) returned '
                             'None'.format(name))
        df = res[0]
        tracks = int(df['TRACK_ID'].nunique())
        log('frames mode {} clip via track_bacteria(path) on cuda: rows {}, '
            'tracks {}, {:.2f} fps end to end (decode included), kernel '
            'launches {}, dropped-registration warnings {}'.format(
                name, df.shape[0], tracks, n_frames / elapsed,
                json.dumps(launches), dropped.count))
        if not np.isfinite(df[['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                               'DEGREES_ANGLE']].to_numpy()).all():
            raise SystemExit('frames {} clip: non-finite values'.format(name))
        if name == 'dense':
            if abs(tracks - DENSE_TRACKS) > 10:
                raise SystemExit('frames dense clip: {} tracks, outside {} '
                                 '+- 10'.format(tracks, DENSE_TRACKS))
            if dropped.count:
                raise SystemExit('frames dense clip: registrations were '
                                 'dropped')
        out[name] = launches
    return out


def compare_rows(what, a, b):
    """TRACK_ID and POSITION_T identical, positions within POS_TOL and the
    rect columns equal; returns (byte-identical rows, max |diff| per
    column)."""
    if a.shape != b.shape:
        raise SystemExit('{}: {} rows on cuda, {} on cpu'.format(
            what, a.shape[0], b.shape[0]))
    for col in ('TRACK_ID', 'POSITION_T'):
        if not np.array_equal(a[col].to_numpy(), b[col].to_numpy()):
            raise SystemExit('{}: {} differs between cuda and cpu'.format(
                what, col))
    same = np.ones(a.shape[0], bool)
    worst = {}
    for col, tol in (('POSITION_X', POS_TOL), ('POSITION_Y', POS_TOL),
                     ('WIDTH', 0.0), ('HEIGHT', 0.0),
                     ('DEGREES_ANGLE', 0.0)):
        x, y = a[col].to_numpy(float), b[col].to_numpy(float)
        diff = np.abs(x - y)
        worst[col] = float(diff.max()) if diff.size else 0.0
        same &= x == y
        if not (diff <= tol).all():
            raise SystemExit('{}: {} differs by {} (tolerance {})'.format(
                what, col, worst[col], tol))
    return int(same.sum()), worst


#: frames of the frames-mode cuda-vs-cpu check: on the H100 machine's CPU a
#: 64-frame batch took 73.7 s (over a minute), 16 frames take a quarter
FRAMES_CPU_FRAMES = 16


def phase_frames_cuda_vs_cpu(frames, settings):
    """Frames mode on the bench scene's first 16 frames (one batch of 16)
    on cuda and on cpu."""
    fsettings = {**settings, **FRAMES, 'frame batch size': FRAMES_CPU_FRAMES}
    first = frames[:FRAMES_CPU_FRAMES]
    cres, _, cstats = run_loop(first, fsettings, 'cuda', 'frames_cuda')
    t0 = time.perf_counter()
    pres, _, _ = run_loop(first, fsettings, 'cpu', 'frames_cpu')
    cpu_s = time.perf_counter() - t0
    same, worst = compare_rows('frames first frames', cres[0], pres[0])
    log('frames mode cuda vs cpu on the first {} frames (a 64-frame batch '
        'takes over a minute on the cpu): {} rows, {} tracks, TRACK_ID and '
        'POSITION_T identical, {} of {} rows byte-identical, max |diff| {}; '
        'cpu loop {:.1f} s'.format(
            len(first), cres[0].shape[0], cstats['tracks'], same,
            cres[0].shape[0], json.dumps(worst), cpu_s))


def main():
    smi = phase_environment()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        dev = torch.device('cuda', 0)
        settings = bench_settings()
        scene = BenchScene()
        phase_build()
        err, ms, plain_ms = phase_kernel(scene, settings, dev)
        launches, frames = phase_main_path(scene, settings)
        phase_clip(settings)
        dsettings = dense_settings()
        dscene = BenchScene(seed=DENSE_SEED, n_bugs=DENSE_BUGS)
        checks = phase_dense_kernels(dscene, dsettings, dev)
        t0 = time.perf_counter()
        dframes = [dscene.frame(t) for t in range(DENSE_FRAMES)]
        log('dense scene: {} frames of {}x{}, {} rods, drawn in {:.1f} '
            's'.format(DENSE_FRAMES, W, H, DENSE_BUGS,
                       time.perf_counter() - t0))
        dense_launches = phase_dense_path(dscene, dframes, dsettings)
        phase_dense_cuda_vs_cpu(dframes, dsettings)
        cc_checks = phase_cc_kernels(scene, settings, dev)
        frames_runs = phase_frames_path(frames, settings, dframes, dsettings)
        phase_frames_cuda_vs_cpu(frames, settings)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    records = [kernel_record(
        'propagate_min_fused', 'ysmr_tpu_torch/csrc/run_prop.cu',
        'ysmr_tpu/ops/pallas_run_prop.py:189', launches, err, ms, plain_ms)]
    for name, src, rep in (
            ('hull_edge_vectors', 'hull.cu', 'pallas_hull.py:107'),
            ('sweep_extents', 'sweep.cu', 'pallas_sweep.py:63'),
            ('row_min_argmin', 'assign.cu', 'pallas_assign.py:100')):
        key = name.split('_')[0] if name != 'row_min_argmin' else 'assign'
        records.append(kernel_record(
            name, 'ysmr_tpu_torch/csrc/' + src, 'ysmr_tpu/ops/' + rep,
            dense_launches[name], *checks[key]))
    for name, line in (('label_components_whole_frame', 229),
                       ('binary_reconstruct', 295)):
        records.append(kernel_record(
            name, 'ysmr_tpu_torch/csrc/cc.cu',
            'ysmr_tpu/ops/pallas_cc.py:{}'.format(line),
            frames_runs['bench'][name], *cc_checks[name]))
    print(json.dumps({'kernels': records}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
