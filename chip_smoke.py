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
   list ``bench_data/bench_clip_list.csv.gz``.

Any failure ends the script with a non-zero exit before the result line.
The last two lines are the ``kernels`` JSON record and the result JSON.
"""

import configparser
import json
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
from ysmr_tpu_torch.ops import run_cc
from ysmr_tpu_torch.ops.run_prop import propagate_min_fused
from ysmr_tpu_torch.pipeline.track_bacteria import _track_loop, track_bacteria
from ysmr_tpu_torch.utils.csv_io import save_list

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, '.smoke')
W, H, FPS = 1228, 922, 30
N_FRAMES = 630
N_BUGS = 200
SEED = 123
MAX_ITERS = 64


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
    and the background prefetch of io.video.BatchedVideoReader."""

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
        if 'registers' in line or 'spill' in line:
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
    pre = HostPreprocessor(settings, FPS,
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
    return launches


def make_clip(path, n_frames):
    """bench.py make_clip: the bench scene written as an MJPG AVI."""
    scene = BenchScene()
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
        launches = phase_main_path(scene, settings)
        phase_clip(settings)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({'kernels': [{
        'name': 'propagate_min_fused', 'route': 'cuda',
        'source': 'ysmr_tpu_torch/csrc/run_prop.cu',
        'replaces': 'ysmr_tpu/ops/pallas_run_prop.py:189',
        'launches': launches, 'max_abs_err': err, 'ms': ms,
        'plain_ms': plain_ms}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
