"""Entry points of the port's compile check and multi-device dry run.

Counterpart of the repository's ``__graft_entry__.py``: ``entry()``
returns the fused frames-mode step of the flagship pipeline (gray -> blur
-> adaptive double threshold -> marker reconstruction -> connected
components -> rotated extents, then the tracker scan with the GSFF filter
bank) and small example inputs on ``device``. ``dryrun_multichip(n)``
builds an n-entry mesh, splits a batch of videos over it, runs one
multi-video step and the row-sharded assignment on tiny shapes, and holds
each against its single-device result; then it drives the pipeline's own
entries on two tiny MJPG clips: ``track_bacteria`` with ``shard dense
assignment across devices`` and the threshold at 0, and
``track_videos_sharded`` over the mesh (20 frames a clip at batch 8).
The dense-assignment gate reads the device count, so on one GPU, or on
the CPU, it stays shut and that run is unsharded. Both run on ``cuda``
unless the caller passes ``device='cpu'`` (a mesh that lists the one CPU
device n times); with fewer than n GPUs the dry run's mesh lists the
visible ones in turn. ``python -m ysmr_tpu_torch.graft_entry`` runs one
step of ``entry()`` and ``dryrun_multichip(4)``.
"""

import os
import tempfile

import cv2
import numpy as np
import torch

from ysmr_tpu_torch.config import create_configs, get_configs
from ysmr_tpu_torch.ops import assignment as asg
from ysmr_tpu_torch.ops.gsff import GSFFParams
from ysmr_tpu_torch.parallel import sharding as shd
from ysmr_tpu_torch.pipeline import detect as det
from ysmr_tpu_torch.pipeline import tracker as trk
from ysmr_tpu_torch.parallel.multi_video import track_videos_sharded
from ysmr_tpu_torch.pipeline.track_bacteria import resolve_device, \
    track_bacteria


def _detect_kwargs(max_det=64, max_bh=32):
    return dict(mode='adaptive_double', white_on_dark=True, offset=5,
                double_delta=2.0, max_det=max_det, max_bh=max_bh,
                cc_iters=32, include_luminosity=False)


def _tracker_setup(max_slots, device, fps=30.0):
    params = GSFFParams(fps=fps, n_min=0, n_max=30, n_f=3)
    state = trk.init_tracker_state(max_slots, device, dims=2, use_gsff=True,
                                   gsff_params=params)
    kwargs = dict(max_disappeared=float(fps), use_gsff=True,
                  **trk.gsff_kwargs(params, device))
    return state, kwargs


def entry(device='cuda'):
    """(fn, example_args): ``fn(frames_bgr, tracker_state)`` runs one
    frames-mode detect + GSFF tracker step and returns ``(new_state,
    emissions)``; the example frames are ``__graft_entry__.entry()``'s
    (4 x 120 x 160 BGR, seed 0) on ``device`` ('cuda' by default; raises
    without a GPU)."""
    device = resolve_device(device)
    t, h, w = 4, 120, 160
    max_slots = 64
    dkw = _detect_kwargs()
    state, tkw = _tracker_setup(max_slots, device)

    def step(frames_bgr, tracker_state):
        n = frames_bgr.shape[0]
        frame_valid = torch.ones(n, dtype=torch.bool, device=frames_bgr.device)
        tables = det.detect_adaptive(frames_bgr, frame_valid, **dkw)
        return trk.run_tracker_scan(tracker_state, tables['det_xy'],
                                    tables['det_info'], tables['det_valid'],
                                    **tkw)

    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)).to(device)
    return step, (frames, state)


def _same_emissions(a, b, what):
    for k in a:
        if not torch.equal(a[k], b[k]):
            raise RuntimeError('dryrun_multichip: {} differs in {}'.format(
                what, k))


def dryrun_multichip(n_devices, device='cuda'):
    """Run the sharded multi-video step and the row-sharded assignment on
    an ``n_devices``-entry mesh of ``device``'s kind ('cuda' by default;
    raises without a GPU), then the pipeline's entries on two tiny clips
    (``_dryrun_pipeline_entries``, whose {clip: rows} it returns); raises
    when a result differs from the single-device one or a run yields no
    rows."""
    kind = resolve_device(device).type
    if kind == 'cuda' and shd.device_count('cuda') < n_devices:
        n_gpu = shd.device_count('cuda')
        mesh = shd.Mesh([torch.device('cuda', i % n_gpu)
                         for i in range(n_devices)], ('videos',))
    else:
        mesh = shd.make_mesh(n_devices, device=kind)
    if mesh.size != n_devices:
        raise RuntimeError('dryrun_multichip: a {}-entry mesh'.format(
            mesh.size))
    v, t, h, w = n_devices, 2, 64, 96
    max_slots = 32
    dkw = _detect_kwargs(max_det=16, max_bh=16)
    state0, tkw = _tracker_setup(max_slots, 'cpu')
    state = shd.stack_states([state0] * v)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (v, t, h, w, 3), dtype=np.uint8)
    frame_valid = np.ones((v, t), bool)

    def run(m):
        step = shd.make_multi_video_step(m, detect_kwargs=dkw,
                                         tracker_kwargs=tkw)
        _, em = step(shd.shard_videos(m, frames),
                     shd.shard_videos(m, frame_valid),
                     shd.shard_videos(m, state))
        return {k: torch.cat([b[k].cpu() for b in em]) for k in em[0]}

    em = run(mesh)
    if tuple(em['mask'].shape) != (v, t, max_slots):
        raise RuntimeError('dryrun_multichip: emissions of shape {}'.format(
            tuple(em['mask'].shape)))
    solo = run(shd.Mesh([mesh.local_devices[0]], ('videos',)))
    _same_emissions(em, solo, 'the step on one device')

    # dense-scene stretch: the row-sharded assignment
    r, c = 64 * n_devices, 48
    home = mesh.local_devices[0]
    obj_xy = torch.from_numpy(
        rng.uniform(0, 500, (r, 2)).astype(np.float32)).to(home)
    det_xy = torch.from_numpy(
        rng.uniform(0, 500, (c, 2)).astype(np.float32)).to(home)
    obj_valid = torch.ones(r, dtype=torch.bool, device=home)
    det_valid = torch.ones(c, dtype=torch.bool, device=home)
    got = shd.sharded_greedy_assign(mesh, obj_xy, obj_valid, det_xy,
                                    det_valid)
    want = asg.greedy_assign(
        asg.pairwise_distances(obj_xy.cpu(), obj_valid.cpu(), det_xy.cpu(),
                               det_valid.cpu()), obj_valid.cpu(),
        det_valid.cpu())
    _same_emissions({k: got[k].cpu() for k in want}, want,
                    'the sharded assignment')
    return _dryrun_pipeline_entries(mesh, kind)


def _write_dryrun_clip(path, n_frames=20, w=96, h=64, fps=30, seed=0,
                       n_bugs=4):
    """A tiny MJPG clip of bright drifting rods (detectable with the
    default adaptive thresholds)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(12, [w - 12, h - 12], (n_bugs, 2))
    vel = rng.uniform(-0.4, 0.4, (n_bugs, 2))
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), fps,
                             (w, h))
    if not writer.isOpened():
        raise RuntimeError('dryrun_multichip: cannot open an MJPG writer')
    for t in range(n_frames):
        frame = rng.normal(40, 4, (h, w)).clip(0, 255).astype(np.uint8)
        for i in range(n_bugs):
            p = pos[i] + vel[i] * t
            cv2.ellipse(frame, (int(round(p[0])), int(round(p[1]))),
                        (4, 2), float(30 * i), 0, 360, 200, -1)
        writer.write(cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR))
    writer.release()
    return path


def _dryrun_pipeline_entries(mesh, device):
    """The pipeline gates that the sharding settings engage, through the
    entry points a user calls: the dense-assignment gate inside
    ``track_bacteria`` (threshold 0; shut with one device of the kind)
    and ``track_videos_sharded`` on two clips over ``mesh``, with more
    than one frame batch each. Returns {clip: rows} of the second run."""
    with tempfile.TemporaryDirectory() as td:
        ini = os.path.join(td, 'tracking.ini')
        create_configs(ini, open_editor=False)
        settings = get_configs(ini)
        settings.update({
            'display video analysis': False, 'user input': False,
            'select files': False, 'save video': False, 'verbose': False,
            'log to file': False, 'collate results csv to xlsx': False,
            'minimal frame count': 10, 'minimal length in seconds': 0.2,
            'frame batch size': 8, 'max detections per frame': 32,
            'max track slots': 8 * mesh.size, 'transfer mode': 'pixels',
            'max foreground pixels per frame': 2048,
            'cv2 exact rects': False,  # the sharded matcher is device-side
        })
        clips = [_write_dryrun_clip(os.path.join(td, name), seed=seed)
                 for name, seed in (('a.avi', 1), ('b.avi', 2))]
        dense = dict(settings)
        dense.update({'shard dense assignment across devices': True,
                      'dense assignment shard threshold': 0})
        folder = os.path.join(td, 'dense')
        os.makedirs(folder)
        out = track_bacteria(clips[0], settings=dense, result_folder=folder,
                             device=device)
        if out is None or out[0].shape[0] == 0:
            raise RuntimeError('dryrun_multichip: the dense-assignment gate '
                               'run gave no rows')
        folder = os.path.join(td, 'multi')
        os.makedirs(folder)
        res = track_videos_sharded(clips, settings=dict(settings),
                                   result_folder=folder, mesh=mesh,
                                   device=device)
        rows = {os.path.basename(c): None if res.get(c) is None else
                int(res[c][0].shape[0]) for c in clips}
        if not all(rows.values()):
            raise RuntimeError('dryrun_multichip: the sharded multi-video run '
                               'gave no rows for a clip: {}'.format(rows))
        return rows


if __name__ == '__main__':
    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    print('entry ok')
    dryrun_multichip(4)
    print('dryrun ok')
