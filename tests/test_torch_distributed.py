"""A real multi-process mesh of the port: two spawned CPU processes form a
gloo group through ``parallel/sharding.init_distributed`` (the
``YSMR_DIST_*`` variables) and run their share of one sharded multi-video
detect + track step and of the row-sharded assignment. Twin of
tests/test_distributed_mesh.py.

Each child runs this file as a script: its two local shards of a global
4-entry CPU mesh, whose emissions must equal, byte for byte, the parent's
single-process step on the same videos, and ``sharded_greedy_assign``
across the two ranks (one ``all_gather``), which must equal
``greedy_assign``; ``track_videos_sharded`` under the group must refuse
its two-process default mesh before it writes anything. Exit codes: 0 equal, 3 different, other a failure.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, T, H, W = 8, 2, 16, 16
MAX_SLOTS = 16
N_SHARDS = 4
DKW = dict(mode='adaptive_double', white_on_dark=True, offset=5.0,
           double_delta=2.0, max_det=16, max_bh=8, cc_iters=8,
           include_luminosity=False, lum_win=3)
TKW = dict(max_disappeared=30.0, use_gsff=False)
EMITTED = ('mask', 'ids', 'pos', 'info', 'det_col', 'n_det', 'n_components')


def _batch():
    """(V, T, H, W, 3) uint8 frames with one bright blob per video."""
    rng = np.random.default_rng(42)
    frames = rng.integers(30, 50, (V, T, H, W, 3), dtype=np.uint8)
    for v in range(V):
        x, y = 3 + (v * 2) % 10, 4 + v % 8
        frames[v, :, y:y + 3, x:x + 3, :] = 220
    return frames, np.ones((V, T), bool)


def _assign_inputs():
    rng = np.random.default_rng(5)
    obj_xy = rng.uniform(0, 500, (64, 2)).astype(np.float32)
    det_xy = rng.uniform(0, 500, (48, 2)).astype(np.float32)
    return obj_xy, rng.random(64) < 0.9, det_xy, rng.random(48) < 0.9


def _step(mesh, frames, valid):
    """One step on ``mesh``: this process's emission blocks as numpy."""
    from ysmr_tpu_torch.parallel import sharding as shd
    from ysmr_tpu_torch.pipeline import tracker as trk
    state = shd.stack_states([trk.init_tracker_state(MAX_SLOTS, 'cpu')] * V)
    step = shd.make_multi_video_step(mesh, detect_kwargs=DKW,
                                     tracker_kwargs=TKW)
    _, em = step(shd.shard_videos(mesh, frames),
                 shd.shard_videos(mesh, valid), shd.shard_videos(mesh, state))
    return [{k: b[k].numpy() for k in EMITTED} for b in em]


def _child(ref_path):
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from ysmr_tpu_torch.parallel import sharding as shd
    if not shd.init_distributed(device='cpu'):
        raise SystemExit('no YSMR_DIST_* configuration')
    mesh = shd.make_mesh(N_SHARDS, device='cpu')
    if (mesh.world, mesh.size, len(mesh.local_shards)) != (2, N_SHARDS, 2):
        raise SystemExit('unexpected mesh {}'.format(mesh))
    ref = np.load(ref_path)
    frames, valid = _batch()
    per = V // N_SHARDS
    rc = 0
    for s, block in zip(mesh.local_shards, _step(mesh, frames, valid)):
        for k in EMITTED:
            want = ref['em_' + k][s * per:(s + 1) * per]
            if block[k].tobytes() != want.tobytes():
                print('MISMATCH', k, s, file=sys.stderr)
                rc = 3
    args = [torch.from_numpy(a) for a in _assign_inputs()]
    got = shd.sharded_greedy_assign(mesh, *args)
    for k in ('row_to_col', 'col_matched'):
        if not np.array_equal(got[k].numpy(), ref['assign_' + k]):
            print('MISMATCH assign', k, file=sys.stderr)
            rc = 3
    # stage 1 of the program is one process: under the group its default
    # mesh spans both ranks, and it refuses before reading any video
    from ysmr_tpu_torch.config import create_configs, get_configs
    from ysmr_tpu_torch.parallel.multi_video import track_videos_sharded
    folder = os.path.join(os.path.dirname(ref_path),
                          'rank{}'.format(mesh.rank))
    os.makedirs(folder)
    ini = os.path.join(folder, 'tracking.ini')
    create_configs(ini, open_editor=False)
    settings = dict(get_configs(ini), **{'log to file': False,
                                         'transfer mode': 'frames'})
    try:
        track_videos_sharded([os.path.join(folder, 'clip.avi')],
                             settings=settings, result_folder=folder,
                             device='cpu')
        print('track_videos_sharded ran over two processes', file=sys.stderr)
        rc = 3
    except ValueError as err:
        if 'one process' not in str(err):
            raise
    if os.listdir(folder) != ['tracking.ini']:
        print('track_videos_sharded wrote', os.listdir(folder),
              file=sys.stderr)
        rc = 3
    print('rank {} checked shards {}: {}'.format(
        mesh.rank, mesh.local_shards, 'MISMATCH' if rc else 'ok'),
        file=sys.stderr)
    torch.distributed.destroy_process_group()
    raise SystemExit(rc)


@pytest.mark.e2e
def test_two_process_gloo_mesh_matches_one_process(tmp_path):
    from ysmr_tpu_torch.ops import assignment as asg
    from ysmr_tpu_torch.parallel import sharding as shd
    torch.set_num_threads(1)
    frames, valid = _batch()
    blocks = _step(shd.make_mesh(N_SHARDS, device='cpu'), frames, valid)
    emissions = {k: np.concatenate([b[k] for b in blocks]) for k in EMITTED}
    assert emissions['mask'].sum() >= V * T
    args = [torch.from_numpy(a) for a in _assign_inputs()]
    want = asg.greedy_assign(asg.pairwise_distances(*args), args[1], args[3])
    ref_path = str(tmp_path / 'ref.npz')
    np.savez(ref_path, **{'em_' + k: v for k, v in emissions.items()},
             **{'assign_' + k: v.numpy() for k, v in want.items()})

    try:
        with socket.socket() as s:
            s.bind(('127.0.0.1', 0))
            port = s.getsockname()[1]
    except OSError as err:
        pytest.skip('cannot bind a localhost port here: {}'.format(err))
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO,
                   YSMR_DIST_COORDINATOR='127.0.0.1:{}'.format(port),
                   YSMR_DIST_NPROCS='2', YSMR_DIST_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), ref_path], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail('the gloo children timed out')
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, 'child rc={}:\n{}'.format(p.returncode,
                                                           err[-3000:])
        assert 'ok' in err.splitlines()[-1]


if __name__ == '__main__':
    _child(sys.argv[1])
