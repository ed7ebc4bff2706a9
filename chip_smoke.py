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
   the 8-connected labeling), those of the dense scene's first 64 frames
   (the run wire's R bucket, both propagations of the dense path) and
   seeded random graphs up to R = 131072 runs; labels must be equal,
   every frame must converge, and on a random init of the kernel's
   contract (every label names a run of its own component, random weak
   bits) the labels must be the component-wise minimum and the plain
   version's; median ms per batch of each;
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
   columns, exact ties) and on the edge cases of its row tiles and column
   slices (4097x4095, 1x1, 700x63, ties across slices, all rows or all
   columns invalid); median ms of each;
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
   POSITION_T identical, the other columns within the stated tolerance;
12. the pixel kernel (``cc_labels_at_pixels``) against its plain version
   (bit-equal where that converged), against the composition of the
   reconstruction and labeling kernels with a rasterize and a gather, and
   against scipy on every frame: the bench batch (64 x 8192, double and
   single threshold), the dense batch (64 x 131072), random blobs with
   the serpentine and lists that break the kernel's tiling (a run across
   a tile boundary, a component over five tiles, an empty frame, a full
   list, F no multiple of the tile); median ms of each and the bound;
13. the bench scene in memory with ``wire format = pixels`` and with ``run
   cc = off`` (the pixel-table branch): ``_list.csv`` byte-identical to
   the run-wire path's of phase 4;
14. luminosity on the bench MJPG clip through ``track_bacteria(path)``
   with GSFF (host rects feeding the device tracker in 3-D), its first 64
   frames without GSFF (the float64 tracker): ILLUMINATION against cv2's
   recipe on 1500 sampled rows, the GSFF rows against the same
   detections' values; the scene in memory (stage split); ``cuda`` against
   ``cpu`` on 16 frames, byte-identical;
15. luminosity on the dense clip (device rects and tracker), the
   ILLUMINATION check on the first batch's detections, the scene in
   memory (stage split), ``cuda`` against ``cpu`` on 16 frames, and the
   dense scene with the pixel wire byte-identical to the run wire's;
16. frames-mode luminosity on the bench scene in memory, and ``cuda``
   against ``cpu`` on 16 frames, byte-identical;
17. dense exact mode: the dense capacities with ``cv2 exact rects max
   detections = 4096``, so the dense scene goes through run-CC on the
   card, the host rects and the float64 tracker: in memory (stage split),
   then the MJPG dense clip through ``track_bacteria(path)``, whose rows
   must be those of ``bench_data/dense_clip_list.csv.gz`` (378,751 rows,
   2899 tracks), with the run-CC kernel launched and the device rects'
   and tracker's kernels not.

Any failure ends the script with a non-zero exit before the result line.
The last three lines are the ``kernels`` JSON record (seven kernels, each
with its bound and the library call where one exists), ``nvidia-smi``'s
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
from ysmr_tpu_torch.pipeline.detect_pixels import detect_from_pixels
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
            # every field stacked, short batches zero-padded, as
            # io.video.BatchedVideoReader does (the packed wire, or with
            # luminosity the split wire and the gray frames)
            batch = {'count': np.zeros(bs, np.int32)}
            batch['count'][:len(tabs)] = [tab['count'] for tab in tabs]
            for key in tabs[0]:
                if key != 'count':
                    first = np.asarray(tabs[0][key])
                    batch[key] = np.zeros((bs,) + first.shape, first.dtype)
                    for i, tab in enumerate(tabs):
                        batch[key][i] = tab[key]
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


def contract_init(comp, rng):
    """A random init inside the kernel's contract: every run names, mod R,
    a random run of its own component (``comp``: (T, R) component ids),
    with a random weak bit (+ R)."""
    t, r = comp.shape
    order = np.lexsort((rng.random((t, r)), comp))
    c = np.take_along_axis(comp, order, 1)
    pos = np.broadcast_to(np.arange(r), (t, r))
    start = np.maximum.accumulate(
        np.where(c != np.roll(c, 1, 1), pos, 0), axis=1)
    start[:, 0] = 0
    same_next = (c == np.roll(c, -1, 1)) & (pos < r - 1)
    # the next run of the component in the shuffled order, cyclically
    target = np.where(same_next, np.roll(order, -1, 1),
                      np.take_along_axis(order, start, 1))
    init = np.empty((t, r), np.int32)
    np.put_along_axis(init, order, target.astype(np.int32), 1)
    return init + r * (rng.random((t, r)) < 0.5).astype(np.int32)


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
    # a random init of the contract: the component-wise minimum on every
    # frame, and the plain version wherever that converged
    r = runs.shape[1]
    comp = ref % r
    rinit = torch.from_numpy(contract_init(
        comp.cpu().numpy(), np.random.default_rng(SEED + r))).to(dev)
    rlab = propagate_min_fused(rinit, win, link, max_iters=MAX_ITERS)[0]
    want = torch.full_like(rinit, 2 * r).scatter_reduce(
        1, comp.long(), rinit, 'amin')
    rref, rsteps = run_cc.propagate_min(rinit, win, link,
                                        max_iters=MAX_ITERS)
    conv = rsteps < MAX_ITERS
    if not torch.equal(rlab, torch.gather(want, 1, comp.long())) or \
            not torch.equal(rlab[conv], rref[conv]):
        raise SystemExit('{}: kernel != plain on a random init'.format(name))
    ms = cuda_ms(lambda: propagate_min_fused(init, win, link,
                                             max_iters=MAX_ITERS))
    plain_ms = cuda_ms(lambda: run_cc.propagate_min(init, win, link,
                                                    max_iters=MAX_ITERS),
                       reps=5)
    # the plain version's work, whatever implements it: per sweep and run
    # two chain neighbours, four window endpoints, a path-halving hop and
    # the compare
    ops = int((ref_steps.cpu().to(torch.int64) *
               torch.from_numpy(counts).to(torch.int64)).sum()) * 8
    bnd = bound([init, link] + [win[k] for k in ('lo_up', 'hi_up', 'lo_dn',
                                                  'hi_dn', 'ok_up', 'ok_dn')],
                [lab, steps], ops)
    log('kernel check {}: T={} R={} runs<= {} equal (and on a random init '
        'of the contract, plain converged on {} of {} frames), steps kernel '
        '{} plain {}, ms kernel {:.4f} plain {:.4f} bound {:.4f} ({})'.format(
            name, runs.shape[0], runs.shape[1], int(counts.max()),
            int(conv.sum()), runs.shape[0], k_steps, p_steps, ms, plain_ms,
            *bnd))
    return err, ms, plain_ms, bnd


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


#: the seeded random run graphs of phase 3: (T, H, W, R, density)
RANDOM_GRAPHS = ((64, 922, 1228, 8192, 0.004), (8, 700, 700, 131072, 0.3),
                 (16, 64, 64, 512, 0.5))


def random_runs(rng, t, h, w, r, dens):
    """The run wire of ``t`` seeded random frames: pixels set with
    probability ``dens``, a third of them markers, cut at ``r`` pixels."""
    packed = np.zeros((t, r), np.uint32)
    counts = np.zeros(t, np.int32)
    for i in range(t):
        yy, xx = np.nonzero(rng.random((h, w)) < dens)
        lin = (yy * w + xx).astype(np.uint32)[:r]
        mk = (rng.random(len(lin)) < 0.3).astype(np.uint32)
        packed[i, :len(lin)] = lin | (mk << 31)
        counts[i] = len(lin)
    return encode(packed, counts, w, r)


def phase_kernel(scene, settings, dscene, dsettings, dev):
    runs, rc = first_batch_runs(scene, settings)
    results = [compare_kernel('bench 4-conn', runs, rc, W, 4, dev),
               compare_kernel('bench 8-conn', runs, rc, W, 8, dev)]
    # the dense path's batch: the run wire's R bucket of the dense scene's
    # first 64 frames, both propagations of a double-threshold batch
    druns, drc = first_batch_runs(dscene, dsettings)
    for conn in (4, 8):
        results.append(compare_kernel('dense batch {}-conn'.format(conn),
                                      druns, drc, W, conn, dev))
    rng = np.random.default_rng(SEED)
    for t, h, w, r, dens in RANDOM_GRAPHS:
        runs, rc = random_runs(rng, t, h, w, r, dens)
        for conn in (4, 8):
            results.append(compare_kernel(
                'random {}x{} {}-conn'.format(h, w, conn), runs, rc, w, conn,
                dev))
    if propagate_min_fused.launches <= 0:
        raise SystemExit('the kernel was never launched')
    return (max(r[0] for r in results),) + results[0][1:]


def run_loop(scene_frames, settings, device, name):
    pre = None if settings.get('transfer mode') == 'frames' else \
        HostPreprocessor(settings, FPS,
                         max_fg=settings['max foreground pixels per frame'])
    reader = MemoryReader(scene_frames, pre, settings['frame batch size'])
    folder = os.path.join(WORK, name)
    os.makedirs(folder, exist_ok=True)
    _, list_name = save_list(
        path=os.path.join(folder, 'bench.avi'), result_folder=folder,
        first_call=True, rename_old_list=False,
        illumination=settings['include luminosity in tracking calculation'])
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
    return launches, frames, cuda_bytes


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


def hold_to_reference(what, ours, ref_name):
    """Rows against a committed reference list of bench_data/, as
    bench.py's check_row_parity holds them: the same row count, TRACK_ID
    and POSITION_T equal, the measured columns within 1e-9."""
    ref = pd.read_csv(os.path.join(REPO, 'bench_data', ref_name))
    ref = ref.sort_values(['TRACK_ID', 'POSITION_T'], kind='stable')
    if ours.shape[0] != ref.shape[0]:
        raise SystemExit('{}: {} rows, reference {}'.format(
            what, ours.shape[0], ref.shape[0]))
    for col, atol in (('TRACK_ID', 0), ('POSITION_T', 0),
                      ('POSITION_X', 1e-9), ('POSITION_Y', 1e-9),
                      ('WIDTH', 1e-9), ('HEIGHT', 1e-9),
                      ('DEGREES_ANGLE', 1e-9)):
        diff = np.abs(ours[col].to_numpy(float) - ref[col].to_numpy(float))
        if not (diff <= atol).all():
            raise SystemExit('{}: column {} differs from the reference list '
                             '(max {}, {} rows)'.format(
                                 what, col, float(diff.max()),
                                 int((diff > atol).sum())))


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
    hold_to_reference('bench clip', ours, 'bench_clip_list.csv.gz')
    log('bench clip via track_bacteria(path): {} rows, {} tracks, identical '
        'to bench_data/bench_clip_list.csv.gz; {:.2f} fps end to end '
        '(decode included)'.format(ours.shape[0],
                                   ours['TRACK_ID'].nunique(),
                                   N_FRAMES / elapsed))


#: NVIDIA's data-sheet peaks of one H100 SXM at 700 W: HBM bytes/s and
#: float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12


def bound(inputs, outputs, ops):
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the memory
    rate and its operations over the float32 rate. Returns (ms, 'bytes' or
    'operations')."""
    nbytes = sum(int(t.numel()) * t.element_size()
                 for t in list(inputs) + list(outputs))
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, float(ops) / PEAK_OPS * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else
            'operations')


def kernel_record(name, source, replaces, launches, check, library_ms=None):
    """One entry of the ``kernels`` line; ``check`` is (max_abs_err, ms,
    plain_ms, (bound_ms, bound_by)) from the kernel's phase."""
    err, ms, plain_ms, (bound_ms, bound_by) = check[:4]
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': launches, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': library_ms}


def max_abs_err(got, want):
    """Largest |kernel - plain| over a kernel's outputs (bools as 0/1)."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise SystemExit('kernel output shape or type differs')
        diff = (g.double() - w.double()).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return err


def check_equal(name, kernel, plain, args, ops, reps=10, plain_reps=5):
    """Kernel against its plain version on the same card tensors: every
    output bit-equal; median ms of each and the bound of the call
    (``ops``: its operation count)."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit('{}: kernel != plain (max |diff| {})'.format(
            name, max_abs_err(got, want)))
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: kernel(*args), reps=reps)
    plain_ms = cuda_ms(lambda: plain(*args), reps=plain_reps)
    bnd = bound(args, got, ops)
    log('kernel check {}: bit-equal, ms kernel {:.4f} plain {:.4f} bound '
        '{:.4f} ({})'.format(name, ms, plain_ms, *bnd))
    return err, ms, plain_ms, bnd


def first_batch_runs(scene, settings):
    """A scene's first 64 frames: host threshold and run wire, cut to the
    wire's R bucket."""
    return encode(*packed_batch(scene, settings), W, None)


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


def assign_edge_inputs(rng, case, k, dev):
    """Inputs that break the assign kernel's 16-row tiles and 64 column
    slices: R and C no multiple of them (4097 x 4095), R = C = 1, C below
    one slice set (700 x 63), exact ties between columns of different
    slices (columns 3 and 4000, 10 and 75), all rows or all columns
    invalid."""
    r, c = {'4097x4095': (4097, 4095), '1x1': (1, 1),
            '700x63': (700, 63)}.get(case, (4096, 4096))
    obj, ov, det, dv = (a.cpu().numpy() for a in assign_inputs(rng, r, c, k,
                                                              'cpu'))
    if case == 'ties':
        for row, (a, b) in enumerate(((3, 4000), (10, 75))):
            det[b] = det[a]
            dv[a] = dv[b] = True
            obj[row] = det[a] + np.float32(0.25)
            ov[row] = True
    elif case == 'rows invalid':
        ov[:] = False
    elif case == 'columns invalid':
        dv[:] = False
    return tuple(torch.from_numpy(a).to(dev) for a in (obj, ov, det, dv))


def hull_ops(row_valid):
    """Slope-matrix operations of the hull call: per non-empty component
    and chain, R x R pairs of two subtractions, a division and a compare."""
    d_act = int(row_valid.any(dim=1).sum())
    return d_act * row_valid.shape[1] ** 2 * 2 * 4


def sweep_ops(valid, k):
    """Projection operations of the sweep call: per non-empty component,
    K directions x P points of two products, two sums, four min/max."""
    return int(valid.any(dim=1).sum()) * k * valid.shape[1] * 8


def assign_ops(ov, dv, k):
    """Distance operations of the assign call, counted over every valid
    pair whatever the kernel skips: K differences, K products/fmas, a sqrt
    and a compare (the kernel takes the sqrt on few pairs)."""
    return int(ov.sum()) * int(dv.sum()) * (2 * k + 2)


def cdist_min_ms(args):
    """Two PyTorch calls computing the row minimum and its column of the
    assign kernel: ``torch.cdist`` then ``.min(1)``, timed on the same
    inputs with the invalid rows and columns left out. A yardstick only
    (two calls, so not the record's library_ms)."""
    obj, ov, det, dv = args
    o, d = obj[ov].contiguous(), det[dv].contiguous()
    return cuda_ms(lambda: torch.cdist(o, d).min(1))


def phase_dense_kernels(scene, settings, dev):
    runs, rc = first_batch_runs(scene, settings)
    hull_args, sweep_args = dense_tables(runs, rc, settings, dev)
    rng = np.random.default_rng(SEED)
    out = {}
    hull = [check_equal('hull dense batch', hull_edge_vectors,
                        labeling.hull_edge_vectors_plain, hull_args,
                        hull_ops(hull_args[2]), reps=20)]
    for d, r in ((4096, 48), (16384, 96)):
        args = random_row_tables(rng, d, r, dev)
        hull.append(check_equal(
            'hull random D={} R={}'.format(d, r), hull_edge_vectors,
            labeling.hull_edge_vectors_plain, args, hull_ops(args[2])))
    out['hull'] = (max(h[0] for h in hull),) + hull[0][1:]
    sweep = [check_equal('sweep dense batch', sweep_extents,
                         labeling.sweep_extents_plain, sweep_args,
                         sweep_ops(sweep_args[1], sweep_args[2].shape[1]),
                         reps=20)]
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
            labeling.sweep_extents_plain, (pts, valid, dx, dy),
            sweep_ops(valid, k)))
    out['sweep'] = (max(x[0] for x in sweep),) + sweep[0][1:]
    assign = []
    for n in (4096, 16384):
        for k in (2, 3):
            args = assign_inputs(rng, n, n, k, dev)
            assign.append(check_equal(
                'assign {}x{} K={}'.format(n, n, k), row_min_argmin,
                assignment.row_min_argmin_plain, args,
                assign_ops(args[1], args[3], k), reps=10,
                plain_reps=3 if n > 4096 else 5))
            if n == 4096:
                log('assign {}x{} K={}: torch.cdist + .min(1) (two calls) '
                    '{:.4f} ms'.format(n, n, k, cdist_min_ms(args)))
    for case in ('4097x4095', '1x1', '700x63', 'ties', 'rows invalid',
                 'columns invalid'):
        for k in (2, 3):
            args = assign_edge_inputs(rng, case, k, dev)
            assign.append(check_equal(
                'assign edge case {} K={}'.format(case, k), row_min_argmin,
                assignment.row_min_argmin_plain, args,
                assign_ops(args[1], args[3], k), reps=3, plain_reps=1))
            if case == 'ties' and \
                    row_min_argmin(*args)[1][:2].tolist() != [3, 10]:
                raise SystemExit('assign ties: the first column did not win')
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
    _, dense_bytes, stats = run_loop(frames, settings, 'cuda', 'dense_mem')
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
    return launches, dense_bytes


#: rows of bench_data/dense_clip_list.csv.gz
DENSE_ROWS = 378751
DENSE_EXACT = {'cv2 exact rects max detections': 4096}


def phase_dense_exact(frames, settings):
    """Dense exact mode: the dense capacities with the host-rect gate
    raised to them, so the dense clip goes through run-CC on the card, the
    host rects and the float64 tracker; its rows must be those of the
    committed reference list. The scene in memory first, for the stage
    split."""
    exact = {**settings, **DENSE_EXACT}
    _, _, stats = run_loop(frames, exact, 'cuda', 'dense_exact_mem')
    log('dense exact mode in memory (cuda): tracks {} frames {} fps {:.2f}; '
        'stage split (ms/frame): {}'.format(
            stats['tracks'], stats['frames'], stats['fps'],
            per_frame(stats)))
    folder = os.path.join(WORK, 'dense_exact_clip')
    os.makedirs(folder, exist_ok=True)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = track_bacteria(os.path.join(WORK, 'dense_clip.avi'),
                         settings=dict(exact), result_folder=folder)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    if res is None:
        raise SystemExit('dense exact mode: track_bacteria(path) returned '
                         'None')
    df = res[0]
    tracks = int(df['TRACK_ID'].nunique())
    if df.shape[0] != DENSE_ROWS or tracks != DENSE_TRACKS:
        raise SystemExit('dense exact mode: {} rows and {} tracks, the '
                         'reference has {} and {}'.format(
                             df.shape[0], tracks, DENSE_ROWS, DENSE_TRACKS))
    hold_to_reference('dense exact mode', df, 'dense_clip_list.csv.gz')
    if launches['propagate_min_fused'] <= 0:
        raise SystemExit('dense exact mode: run-CC kernel never launched')
    if any(v for k, v in launches.items() if k != 'propagate_min_fused'):
        raise SystemExit('dense exact mode: the device rects or tracker ran: '
                         '{}'.format(launches))
    log('dense exact mode, dense clip via track_bacteria(path) on cuda: {} '
        'rows, {} tracks, identical to bench_data/dense_clip_list.csv.gz; '
        '{:.2f} fps end to end (decode included), kernel launches {}'.format(
            df.shape[0], tracks, DENSE_FRAMES / elapsed,
            json.dumps(launches)))


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
    blurred = detect.prepare_batch(torch.from_numpy(bgr).to(dev))[1]
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
        # init, merge and compress: a few operations per pixel
        bnd = bound([mask], [got], 4 * mask.numel())
        out['label{}'.format(conn)] = (0.0, ms, plain_ms, bnd)
        log('kernel check {} label {}-conn: T={} bit-equal on {} of {} '
            'frames (plain steps max {}), ms kernel {:.4f} plain {:.4f} '
            'bound {:.4f} ({})'.format(
                name, conn, mask.shape[0], int(conv.sum()), mask.shape[0],
                int(steps.max()), ms, plain_ms, *bnd))
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
    bnd = bound([mask, marker], [got], 5 * mask.numel())
    out['reconstruct'] = (0.0, ms, plain_ms, bnd)
    log('kernel check {} reconstruct: bit-equal on {} of {} frames, kept {} '
        'of {} mask pixels, ms kernel {:.4f} plain {:.4f} bound {:.4f} ({})'
        .format(name, int(conv.sum()), mask.shape[0], int(got.sum()),
                int(mask.sum()), ms, plain_ms, *bnd))
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


# ---- the pixel-table branch and luminosity ----

LUM = {'include luminosity in tracking calculation': True}


def packed_batch(scene, settings, t=64):
    """The host threshold's packed pixel wire of the scene's first ``t``
    frames (T, max_fg) and the pixel counts."""
    pre = HostPreprocessor(settings, FPS,
                           max_fg=settings['max foreground pixels per frame'])
    packed = np.zeros((t, pre.max_fg), np.uint32)
    counts = np.zeros(t, np.int32)
    for i in range(t):
        tab = pre(scene.frame(i))
        packed[i], counts[i] = tab['px_packed'], tab['count']
    return packed, counts


def lists_from_packed(packed, counts, dev):
    """(T, F) pixel lists on the card from the packed wire (lin | marker
    << 31): int32 x and y, bool valid (the count prefix) and marker."""
    lin = (packed & 0x7FFFFFFF).astype(np.int64)
    valid = np.arange(packed.shape[1])[None, :] < counts[:, None]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        (lin % W).astype(np.int32), (lin // W).astype(np.int32), valid,
        ((packed >> 31) > 0) & valid))


def lists_from_masks(masks, markers, dev, f=None):
    """Raster-order pixel lists of (T, H, W) masks; F (by default the next
    power of two above the largest frame's pixel count) cuts longer
    frames."""
    t = masks.shape[0]
    f = f or 1 << max(int(masks.reshape(t, -1).sum(1).max()) - 1,
                      1).bit_length()
    arrs = [np.zeros((t, f), np.int32), np.zeros((t, f), np.int32),
            np.zeros((t, f), bool), np.zeros((t, f), bool)]
    for i in range(t):
        ys, xs = np.nonzero(masks[i])
        ys, xs = ys[:f], xs[:f]
        n = len(ys)
        arrs[0][i, :n], arrs[1][i, :n], arrs[2][i, :n] = xs, ys, True
        arrs[3][i, :n] = markers[i][ys, xs]
    return tuple(torch.from_numpy(a).to(dev) for a in arrs)


def scipy_pixel_labels(lists, double, frames):
    """The pixel kernel's contract from scipy, per frame: keep = valid and
    (double threshold) 4-connected within the valid pixels to a marker
    pixel; the label of a kept pixel the minimum linear index of its
    8-connected component among the kept pixels, -1 elsewhere."""
    from scipy import ndimage
    px_x, px_y, valid, marker = (a.cpu().numpy() for a in lists)
    for i in frames:
        v = valid[i]
        xs, ys, mk = px_x[i][v], px_y[i][v], marker[i][v]
        m = np.zeros((H, W), bool)
        m[ys, xs] = True
        seed = np.zeros((H, W), bool)
        seed[ys[mk], xs[mk]] = True
        kept = ndimage.binary_propagation(seed, mask=m) if double else m
        keep = np.zeros_like(v)
        keep[v] = kept[ys, xs]
        lab = np.full(v.shape, -1, np.int32)
        lab[v] = np.where(keep[v], scipy_min_index_labels(kept, 8)[ys, xs],
                          -1)
        yield i, lab, keep


def compose_5_6(lists, double):
    """The pixel kernel's function from the whole-frame kernels: rasterize
    the lists, reconstruction (kernel 5), 8-connected labels (kernel 6),
    gather at the pixels."""
    px_x, px_y, valid, marker = lists
    t, n = px_x.shape[0], H * W
    dev = px_x.device
    flat = px_y.long() * W + px_x.long() + \
        torch.arange(t, device=dev)[:, None] * n

    def raster(sel):
        img = torch.zeros(t * n + 1, dtype=torch.bool, device=dev)
        img[torch.where(sel, flat, torch.full_like(flat, t * n))] = True
        return img[:t * n].view(t, H, W)

    mask = raster(valid)
    if double:
        mask = cc.binary_reconstruct(mask, raster(valid & marker))
    lab8 = cc.label_components_whole_frame(mask, 8)
    keep = valid & mask.reshape(-1)[flat]
    return torch.where(keep, lab8.reshape(-1)[flat],
                       torch.full((), -1, dtype=torch.int32,
                                  device=dev)), keep


def pixel_ops(lists):
    """Operations of the pixel function, a fixed count per valid slot and
    pass: finding the upper neighbours among the about w + 2 slots before
    it (log2(w + 2) comparisons) and a few neighbour tests. The bound is
    the lists' bytes either way."""
    return int(lists[2].sum()) * 2 * (int(np.log2(W + 2)) + 8)


def check_pixels(name, lists, double):
    """The pixel kernel against its plain version (bit-equal on every frame
    where the plain labelings converged), against kernels 5 + 6 and
    against scipy (every frame); median ms of each and the bound. Returns
    (err, ms, plain_ms, bound, compose_ms)."""
    kw = dict(h=H, w=W, double_threshold=double, max_iters=MAX_ITERS)
    lab, keep = cc.cc_labels_at_pixels(*lists, **kw)
    p_lab, p_keep, steps = cc.cc_labels_at_pixels_plain(*lists, **kw)
    c_lab, c_keep = compose_5_6(lists, double)
    torch.cuda.synchronize()
    conv = steps < MAX_ITERS
    if not (torch.equal(lab[conv], p_lab[conv]) and
            torch.equal(keep[conv], p_keep[conv])):
        raise SystemExit('{}: pixel kernel != plain'.format(name))
    if not (torch.equal(lab, c_lab) and torch.equal(keep, c_keep)):
        raise SystemExit('{}: pixel kernel != kernels 5 + 6'.format(name))
    lab_np, keep_np = lab.cpu().numpy(), keep.cpu().numpy()
    for i, s_lab, s_keep in scipy_pixel_labels(lists, double,
                                               range(lab.shape[0])):
        if not (np.array_equal(lab_np[i], s_lab) and
                np.array_equal(keep_np[i], s_keep)):
            raise SystemExit('{}: frame {} != scipy'.format(name, i))
    err = max_abs_err((lab[conv], keep[conv]), (p_lab[conv], p_keep[conv]))
    ms = cuda_ms(lambda: cc.cc_labels_at_pixels(*lists, **kw))
    plain_ms = cuda_ms(lambda: cc.cc_labels_at_pixels_plain(*lists, **kw),
                       reps=3)
    comp_ms = cuda_ms(lambda: compose_5_6(lists, double), reps=5)
    bnd = bound(lists, (lab, keep), pixel_ops(lists))
    log('kernel check {}: T={} F={} pixels {} kept {}, equal to scipy on '
        'every frame, to kernels 5 + 6, and bit-equal to plain on {} of {} '
        'frames (plain steps max {}); ms kernel {:.4f} plain {:.4f} '
        'kernels 5+6 {:.4f} bound {:.4f} ({})'.format(
            name, lab.shape[0], lab.shape[1], int(lists[2].sum()),
            int(keep.sum()), int(conv.sum()), lab.shape[0],
            int(steps.max()), ms, plain_ms, comp_ms, *bnd))
    return err, ms, plain_ms, bnd, comp_ms


#: list slots of the edge-case batch: no multiple of the kernel's
#: 2048-slot tiles
EDGE_F = 10000


def edge_pixel_masks(rng):
    """Frames that break the pixel kernel's tiling (2048-slot tiles with
    the w + 1 slots before each as halo), one marker each where named:
    0 full rows 0-2, so row 1's run crosses the tile boundary at slot
    2048; 1 a full-width block of rows 300-307 (9824 px, five tiles) with
    one marker, beside an unmarked blob; 2 empty; 3 exactly EDGE_F pixels
    (a full list); 4 random ellipses cut at EDGE_F."""
    masks = np.zeros((5, H, W), bool)
    masks[0, :3] = True
    masks[1, 300:308] = True
    masks[1, 400:403, 100:141] = True
    masks[3, :8] = True
    masks[3, 8, :EDGE_F - 8 * W] = True
    ell = np.zeros((H, W), np.uint8)
    for _ in range(300):
        cv2.ellipse(ell, (int(rng.integers(0, W)), int(rng.integers(0, H))),
                    (int(rng.integers(1, 30)), int(rng.integers(1, 10))),
                    float(rng.uniform(0, 180)), 0, 360, 1, -1)
    masks[4] = ell > 0
    markers = masks & (rng.random(masks.shape) < 0.01)
    markers[:2] = False
    markers[0, 1, 5] = markers[1, 303, 700] = True
    return masks, markers


def phase_pixel_kernel(scene, settings, dscene, dsettings, dev):
    """Phase a: the pixel kernel on the bench batch (single and double
    threshold), on the dense batch and on random blobs with the
    serpentine."""
    lists = lists_from_packed(*packed_batch(scene, settings), dev)
    main = check_pixels('pixels bench batch double', lists, True)
    check_pixels('pixels bench batch single', lists, False)
    dlists = lists_from_packed(*packed_batch(dscene, dsettings), dev)
    check_pixels('pixels dense batch double', dlists, True)
    masks, markers = random_blob_masks(np.random.default_rng(SEED + 4), 8)
    blists = lists_from_masks(masks, markers, dev)
    check_pixels('pixels random blobs double', blists, True)
    check_pixels('pixels random blobs single', blists, False)
    masks, markers = edge_pixel_masks(np.random.default_rng(SEED + 5))
    elists = lists_from_masks(masks, markers, dev, f=EDGE_F)
    counts = elists[2].sum(1).tolist()
    if not (counts[2] == 0 and counts[3] == EDGE_F and
            counts[1] > 4 * 2048 and counts[0] > 2048):
        raise SystemExit('pixel edge lists: unexpected counts {}'.format(
            counts))
    check_pixels('pixels edge lists double', elists, True)
    check_pixels('pixels edge lists single', elists, False)
    return main


def per_frame(stats):
    return json.dumps({k: round(v / stats['frames'] * 1e3, 4)
                       for k, v in stats['stage_s'].items()})


def phase_pixel_wires(frames, settings, run_bytes):
    """Phase b: the bench scene in memory with the pixel wire, then with
    'run cc = off'; each _list.csv byte-identical to the run-wire path's."""
    for key, extra in (('pixels', {'wire format': 'pixels'}),
                       ('runcc_off', {'run cc': 'off'})):
        torch.cuda.synchronize()
        cc.cc_labels_at_pixels.launches = 0
        _, got, stats = run_loop(frames, {**settings, **extra}, 'cuda',
                                 'wire_' + key)
        torch.cuda.synchronize()
        launches = cc.cc_labels_at_pixels.launches
        if got != run_bytes:
            raise SystemExit('{}: _list.csv differs from the run-wire '
                             'path'.format(extra))
        if launches <= 0:
            raise SystemExit('{}: the pixel kernel was never launched'.format(
                extra))
        log('bench scene in memory with {} (cuda): rows {} tracks {} fps '
            '{:.2f}, byte-identical to the run-wire path; pixel kernel '
            'launches {}; stage split (ms/frame): {}'.format(
                json.dumps(extra), got.count(b'\n') - 1, stats['tracks'],
                stats['fps'], launches, per_frame(stats)))


def lum_check(what, grays, t_idx, rects, lums, n_sample, rng):
    """ILLUMINATION against cv2's recipe (boxPoints, fillPoly, mean / 100)
    on sampled rects of their own frames: within 1e-5 wherever cv2's
    integer corners equal the port's. Rects reaching past the frame are
    left out (cv2 clips the outline, the port clips by membership; a
    documented deviation), and rects whose corners differ from cv2's (a
    knife edge; OpenCV 5 computes two corners another way than OpenCV 4)
    are counted and must stay under 1%."""
    from ysmr_tpu_torch.ops.luminosity import box_points_int
    pick = np.sort(rng.choice(len(t_idx), min(n_sample, len(t_idx)),
                              replace=False))
    r32 = [np.ascontiguousarray(rects[pick, k], np.float32)
           for k in range(5)]
    ours = box_points_int(*(torch.from_numpy(a) for a in r32)).numpy()
    checked = border = corner = 0
    worst = 0.0
    for j, i in enumerate(pick):
        box = np.intp(cv2.boxPoints(((r32[0][j], r32[1][j]),
                                     (r32[2][j], r32[3][j]), r32[4][j])))
        if box.min() < 0 or (box[:, 0] >= W).any() or (box[:, 1] >= H).any():
            border += 1
            continue
        if sorted(map(tuple, box.tolist())) != \
                sorted(map(tuple, ours[j].tolist())):
            corner += 1
            continue
        mask = np.zeros((H, W), np.uint8)
        cv2.fillPoly(mask, [box], 255)
        want = cv2.mean(grays[t_idx[i]], mask)[0] / 100.0
        worst = max(worst, abs(float(lums[i]) - want))
        checked += 1
    log('{}: ILLUMINATION of {} sampled rects against cv2 {} recipe: {} '
        'checked, max |diff| {:.3e}; {} past the frame border left out; {} '
        'with other integer corners than cv2.boxPoints'.format(
            what, len(pick), cv2.__version__, checked, worst, border,
            corner))
    if worst > 1e-5 or checked < 1000 or corner > 0.01 * len(pick):
        raise SystemExit('{}: ILLUMINATION check failed'.format(what))


def rows_lum_check(what, df, grays, rng):
    """lum_check on the rows of a run with measured positions (the
    float64 tracker without GSFF); coasting rows carry no rect."""
    rows = df[(df['WIDTH'] > 0) | (df['HEIGHT'] > 0)]
    lum_check(what, grays, rows['POSITION_T'].to_numpy(),
              rows[['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                    'DEGREES_ANGLE']].to_numpy(), rows['ILLUMINATION']
              .to_numpy(), 1500, rng)


def clip_grays(path):
    """The clip's frames as cv2 decodes them, to grayscale."""
    cap = cv2.VideoCapture(path)
    grays = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        grays.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
    cap.release()
    return grays


def track_clip(name, clip, settings, kernels):
    """track_bacteria(path) on cuda with the launches of ``kernels``
    counted from 0; returns (DataFrame, launches, frames/s)."""
    folder = os.path.join(WORK, name)
    os.makedirs(folder, exist_ok=True)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = track_bacteria(clip, settings=dict(settings), result_folder=folder)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    if res is None:
        raise SystemExit('{}: track_bacteria(path) returned None'.format(
            name))
    df = res[0]
    if 'ILLUMINATION' not in df or not np.isfinite(
            df[['POSITION_X', 'POSITION_Y', 'WIDTH', 'HEIGHT',
                'DEGREES_ANGLE', 'ILLUMINATION']].to_numpy()).all():
        raise SystemExit('{}: missing or non-finite columns'.format(name))
    if min(launches.values()) <= 0:
        raise SystemExit('{}: a kernel of the path was never launched: '
                         '{}'.format(name, launches))
    n_frames = int(df['POSITION_T'].max()) + 1
    return df, launches, n_frames / elapsed


def cuda_vs_cpu(what, frames, settings, n=16):
    """The first ``n`` frames in memory through the stage-1 loop on cuda
    and on cpu: byte-identical _list.csv."""
    sets = {**settings, 'frame batch size': n}
    _, cbytes, _ = run_loop(frames[:n], sets, 'cuda', what + '_cuda')
    t0 = time.perf_counter()
    _, pbytes, _ = run_loop(frames[:n], sets, 'cpu', what + '_cpu')
    if cbytes != pbytes:
        raise SystemExit('{}: _list.csv differs between cuda and cpu'.format(
            what))
    log('{} cuda vs cpu on the first {} frames: {} rows byte-identical; cpu '
        'loop {:.1f} s'.format(what, n, cbytes.count(b'\n') - 1,
                               time.perf_counter() - t0))


def phase_lum_bench(frames, settings):
    """Phase c: the bench MJPG clip with luminosity and GSFF (host rects
    feed the device tracker), then its first 64 frames without GSFF (the
    float64 tracker in 3-D), the ILLUMINATION checks, and cuda against
    cpu."""
    lset = {**settings, **LUM}
    df, launches, fps = track_clip(
        'lum_clip', os.path.join(WORK, 'bench_clip.avi'), lset,
        (cc.cc_labels_at_pixels, row_min_argmin))
    log('bench clip with luminosity and GSFF via track_bacteria(path) on '
        'cuda: rows {} tracks {} {:.2f} fps end to end (decode included), '
        'kernel launches {}'.format(df.shape[0], df['TRACK_ID'].nunique(),
                                    fps, json.dumps(launches)))
    clip64 = make_clip(os.path.join(WORK, 'bench_clip64.avi'), 64)
    off, off_launches, off_fps = track_clip(
        'lum_clip64', clip64, {**lset, 'disable gsff': True,
                               'minimal frame count': 32},
        (cc.cc_labels_at_pixels,))
    log('its first 64 frames without GSFF (float64 tracker, dims 3): rows '
        '{} tracks {} {:.2f} fps, kernel launches {}'.format(
            off.shape[0], off['TRACK_ID'].nunique(), off_fps,
            json.dumps(off_launches)))
    rng = np.random.default_rng(SEED)
    rows_lum_check('bench clip, GSFF off', off, clip_grays(clip64), rng)
    # with GSFF the rows carry filtered positions; their ILLUMINATION is
    # the measured rect's: the GSFF-off row of the same frame and rect
    # (W, H, angle) within 3 px is the same detection, where only one is
    keys = ['POSITION_T', 'WIDTH', 'HEIGHT', 'DEGREES_ANGLE']
    on = df[(df['POSITION_T'] < 64) & (df['WIDTH'] > 0)].reset_index()
    pairs = on.merge(off[off['WIDTH'] > 0], on=keys, suffixes=('', '_off'))
    near = np.hypot(pairs['POSITION_X'] - pairs['POSITION_X_off'],
                    pairs['POSITION_Y'] - pairs['POSITION_Y_off']) < 3.0
    pairs = pairs[near].drop_duplicates('index', keep=False)
    same = int((pairs['ILLUMINATION'] == pairs['ILLUMINATION_off']).sum())
    log('bench clip, GSFF on: ILLUMINATION equal to the GSFF-off run on {} '
        'of {} rows of the same detection'.format(same, pairs.shape[0]))
    if pairs.shape[0] < 1000 or same != pairs.shape[0]:
        raise SystemExit('bench clip: GSFF-on ILLUMINATION differs')
    _, got, stats = run_loop(frames, lset, 'cuda', 'lum_mem')
    log('bench scene with luminosity and GSFF in memory (cuda): rows {} '
        'tracks {} fps {:.2f}; stage split (ms/frame): {}'.format(
            got.count(b'\n') - 1, stats['tracks'], stats['fps'],
            per_frame(stats)))
    cuda_vs_cpu('bench luminosity', frames, lset)
    return launches


def phase_lum_dense(dscene, dframes, dsettings, dense_bytes, dev):
    """Phase d: the dense clip with luminosity (device rects and tracker),
    the ILLUMINATION check on the first batch's detections, cuda against
    cpu, and the pixel wire without luminosity against the run wire."""
    lset = {**dsettings, **LUM}
    df, launches, fps = track_clip(
        'lum_dense_clip', os.path.join(WORK, 'dense_clip.avi'), lset,
        (cc.cc_labels_at_pixels, hull_edge_vectors, sweep_extents,
         row_min_argmin))
    log('dense clip with luminosity via track_bacteria(path) on cuda: rows '
        '{} tracks {} {:.2f} fps end to end (decode included), kernel '
        'launches {}'.format(df.shape[0], df['TRACK_ID'].nunique(), fps,
                             json.dumps(launches)))
    packed, counts = packed_batch(dscene, dsettings)
    t = len(counts)
    gray = torch.from_numpy(np.stack(dframes[:t])).to(dev)
    tables = detect_from_pixels(
        None, None, torch.from_numpy(counts).to(dev), None,
        torch.ones(t, dtype=torch.bool, device=dev),
        px_packed=torch.from_numpy(packed.view(np.int32)).to(dev), h=H, w=W,
        double_threshold=True, max_det=dsettings['max detections per frame'],
        max_bh=dsettings['max bounding box height'], cc_iters=MAX_ITERS,
        include_luminosity=True, gray_frames=gray, lum_win=48)
    v = tables['det_valid'].cpu().numpy()
    t_idx = np.nonzero(v)[0]
    xy = tables['det_xy'].cpu().numpy()[v]
    info = tables['det_info'].cpu().numpy()[v]
    lum_check('dense first batch detections (exact centers)', dframes,
              t_idx, np.concatenate([xy[:, :2], info], axis=1), xy[:, 2],
              1500, np.random.default_rng(SEED))
    _, got, stats = run_loop(dframes, lset, 'cuda', 'lum_dense_mem')
    log('dense scene with luminosity in memory (cuda): rows {} tracks {} fps '
        '{:.2f}; stage split (ms/frame): {}'.format(
            got.count(b'\n') - 1, stats['tracks'], stats['fps'],
            per_frame(stats)))
    cuda_vs_cpu('dense luminosity', dframes, lset)
    torch.cuda.synchronize()
    cc.cc_labels_at_pixels.launches = 0
    _, got, stats = run_loop(dframes, {**dsettings, 'wire format': 'pixels'},
                             'cuda', 'dense_wire_pixels')
    torch.cuda.synchronize()
    if got != dense_bytes:
        raise SystemExit('dense scene: the pixel wire _list.csv differs from '
                         'the run wire')
    log('dense scene in memory with the pixel wire (cuda): rows {} fps '
        '{:.2f}, byte-identical to the run-wire path; pixel kernel launches '
        '{}; stage split (ms/frame): {}'.format(
            got.count(b'\n') - 1, stats['fps'],
            cc.cc_labels_at_pixels.launches, per_frame(stats)))
    return launches


def phase_lum_frames(frames, settings):
    """Phase e: frames-mode luminosity on the bench scene in memory, and
    cuda against cpu on its first 16 frames."""
    fset = {**settings, **FRAMES, **LUM}
    torch.cuda.synchronize()
    reset_frames_launches()
    res, got, stats = run_loop(frames, fset, 'cuda', 'lum_frames')
    torch.cuda.synchronize()
    launches = frames_launches('frames mode with luminosity')
    if not np.isfinite(res[0]['ILLUMINATION'].to_numpy()).all():
        raise SystemExit('frames mode with luminosity: non-finite values')
    log('frames mode with luminosity, bench scene in memory (cuda): rows {} '
        'tracks {} fps {:.2f}, kernel launches {}; stage split (ms/frame): '
        '{}'.format(got.count(b'\n') - 1, stats['tracks'], stats['fps'],
                    json.dumps(launches), per_frame(stats)))
    cuda_vs_cpu('frames luminosity', frames, fset)


def main():
    smi = phase_environment()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        dev = torch.device('cuda', 0)
        settings = bench_settings()
        scene = BenchScene()
        phase_build()
        dsettings = dense_settings()
        dscene = BenchScene(seed=DENSE_SEED, n_bugs=DENSE_BUGS)
        run_prop_check = phase_kernel(scene, settings, dscene, dsettings,
                                      dev)
        launches, frames, run_bytes = phase_main_path(scene, settings)
        phase_clip(settings)
        checks = phase_dense_kernels(dscene, dsettings, dev)
        t0 = time.perf_counter()
        dframes = [dscene.frame(t) for t in range(DENSE_FRAMES)]
        log('dense scene: {} frames of {}x{}, {} rods, drawn in {:.1f} '
            's'.format(DENSE_FRAMES, W, H, DENSE_BUGS,
                       time.perf_counter() - t0))
        dense_launches, dense_bytes = phase_dense_path(dscene, dframes,
                                                       dsettings)
        phase_dense_cuda_vs_cpu(dframes, dsettings)
        cc_checks = phase_cc_kernels(scene, settings, dev)
        frames_runs = phase_frames_path(frames, settings, dframes, dsettings)
        phase_frames_cuda_vs_cpu(frames, settings)
        pixel_check = phase_pixel_kernel(scene, settings, dscene, dsettings,
                                         dev)
        phase_pixel_wires(frames, settings, run_bytes)
        lum_launches = phase_lum_bench(frames, settings)
        phase_lum_dense(dscene, dframes, dsettings, dense_bytes, dev)
        phase_lum_frames(frames, settings)
        phase_dense_exact(dframes, dsettings)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    records = [kernel_record(
        'propagate_min_fused', 'ysmr_tpu_torch/csrc/run_prop.cu',
        'ysmr_tpu/ops/pallas_run_prop.py:189', launches, run_prop_check)]
    for name, src, rep in (
            ('hull_edge_vectors', 'hull.cu', 'pallas_hull.py:107'),
            ('sweep_extents', 'sweep.cu', 'pallas_sweep.py:63'),
            ('row_min_argmin', 'assign.cu', 'pallas_assign.py:100')):
        key = name.split('_')[0] if name != 'row_min_argmin' else 'assign'
        records.append(kernel_record(
            name, 'ysmr_tpu_torch/csrc/' + src, 'ysmr_tpu/ops/' + rep,
            dense_launches[name], checks[key]))
    for name, line in (('label_components_whole_frame', 229),
                       ('binary_reconstruct', 295)):
        records.append(kernel_record(
            name, 'ysmr_tpu_torch/csrc/cc.cu',
            'ysmr_tpu/ops/pallas_cc.py:{}'.format(line),
            frames_runs['bench'][name], cc_checks[name]))
    records.append(kernel_record(
        'cc_labels_at_pixels', 'ysmr_tpu_torch/csrc/cc.cu',
        'ysmr_tpu/ops/pallas_cc.py:347',
        lum_launches['cc_labels_at_pixels'], pixel_check))
    print(json.dumps({'kernels': records}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
