"""The port's device-mesh modes (ysmr_tpu_torch/parallel/sharding.py)
against the JAX package on the CPU: twins of tests/test_sharding.py.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py); the
port's meshes list the one CPU device 1, 2 or 4 times (``make_mesh(n,
device='cpu')``), which runs the same splits one after another.

- ``sharded_greedy_assign``: JAX's sharded matcher and the port's
  unsharded one, bit for bit, on 1-, 2- and 4-entry meshes and the 2-axis
  (hosts, videos) layout of JAX's ``make_mesh(4, hosts=2)`` (the port's
  ``Mesh`` over the same devices reshaped), K = 2 and 3; its gathered
  candidates (``sharded_row_min_argmin``) the unsharded ones.
- ``make_multi_video_step``: JAX's step on the same videos; mask, ids,
  det_col, n_det and n_components equal, positions equal without GSFF and
  within 1e-4 px with it (the double-single residue pinned by
  tests/test_torch_tracker.py::test_scan_matches_jax).
- ``run_tracker_scan(assign_mesh=...)`` and ``track_bacteria`` with the
  dense-assignment gate forced (device count 4, threshold 0) give the
  unsharded results.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_e2e_parity import _make_settings, make_synthetic_video
from ysmr_tpu.ops import gsff as jgsff
from ysmr_tpu.parallel import sharding as jshd
from ysmr_tpu.pipeline import tracker as jtrk
from ysmr_tpu_torch.ops import assignment as asg
from ysmr_tpu_torch.ops import frame_step as fs
from ysmr_tpu_torch.ops.gsff import GSFFParams
from ysmr_tpu_torch.parallel import sharding as shd
from ysmr_tpu_torch.pipeline import tracker as trk

torch.set_num_threads(1)

#: mesh layouts: (devices, host groups)
LAYOUTS = {'1': (1, None), '2': (2, None), '4': (4, None), '2x2': (4, 2)}


def _port_mesh(n, hosts=None):
    """The port's n-entry CPU mesh; with ``hosts`` laid out as JAX's
    ``make_mesh(n, hosts=hosts)`` lays its devices out."""
    mesh = shd.make_mesh(n, device='cpu')
    if hosts is None:
        return mesh
    return shd.Mesh(mesh.devices.reshape(hosts, -1), ('hosts', 'videos'))


def _assign_inputs(k, r=64, c=48):
    rng = np.random.default_rng(42)
    obj_xy = rng.uniform(0, 500, (r, k)).astype(np.float32)
    det_xy = rng.uniform(0, 500, (c, k)).astype(np.float32)
    # exact ties: a repeated detection and a repeated object
    det_xy[5] = det_xy[3]
    obj_xy[7] = obj_xy[2]
    obj_valid = rng.random(r) < 0.9
    det_valid = rng.random(c) < 0.9
    return obj_xy, obj_valid, det_xy, det_valid


@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_sharded_greedy_assign_matches_jax_and_unsharded(layout, k):
    n, hosts = LAYOUTS[layout]
    obj_xy, obj_valid, det_xy, det_valid = _assign_inputs(k)
    jmesh = jshd.make_mesh(n, hosts=hosts)
    ref = jshd.sharded_greedy_assign(jmesh, jshd.shard_videos(jmesh, obj_xy),
                                     obj_valid, det_xy, det_valid)
    mesh = _port_mesh(n, hosts)
    assert mesh.size == n and mesh.devices.shape == jmesh.devices.shape
    assert mesh.axis_names == jmesh.axis_names
    args = [torch.from_numpy(a) for a in (obj_xy, obj_valid, det_xy,
                                          det_valid)]
    got = shd.sharded_greedy_assign(mesh, *args)
    want = asg.greedy_assign(asg.pairwise_distances(*args), args[1], args[3])
    assert int((got['row_to_col'] >= 0).sum()) > 20
    for key in ('row_to_col', 'col_matched'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(),
                                      err_msg=key)


@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_sharded_candidates_are_the_unsharded_ones(layout, k):
    """``sharded_row_min_argmin`` gathers each row's minimum and first
    minimal column in row order, the unsharded call's bits: what the
    tracker's frame-step block takes with ``assign_mesh``."""
    args = [torch.from_numpy(a) for a in _assign_inputs(k)]
    row_min, cand = shd.sharded_row_min_argmin(_port_mesh(*LAYOUTS[layout]),
                                               *args)
    want_min, want_cand = shd.row_min_argmin(*args)
    assert row_min.dtype == torch.float32 and cand.dtype == torch.int32
    assert torch.equal(row_min.view(torch.int32),
                       want_min.view(torch.int32))
    assert torch.equal(cand, want_cand)


def test_mesh_rejects_uneven_splits_and_cuda_without_a_gpu():
    mesh = shd.make_mesh(4, device='cpu')
    with pytest.raises(ValueError, match='rows do not split'):
        shd.sharded_greedy_assign(mesh, torch.zeros(6, 2),
                                  torch.ones(6, dtype=torch.bool),
                                  torch.zeros(3, 2),
                                  torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match='videos do not split'):
        shd.shard_videos(mesh, np.zeros((3, 2)))
    with pytest.raises(ValueError, match='axis names'):
        shd.Mesh(mesh.devices.reshape(2, 2), ('videos',))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            shd.make_mesh()
    assert shd.init_distributed(coordinator='') is False


V, T, H, W = 4, 3, 64, 96
MAX_SLOTS = 16
DKW = dict(mode='adaptive_double', white_on_dark=True, offset=5,
           double_delta=2.0, max_det=16, max_bh=16, cc_iters=32,
           include_luminosity=False)


def _videos():
    """test_sharding.py's batch: one bright blob per video and frame."""
    rng = np.random.default_rng(42)
    frames = rng.integers(0, 50, (V, T, H, W, 3), dtype=np.uint8)
    for i in range(V):
        for k in range(T):
            y0, x0 = 10 + 6 * i, 20 + 4 * k
            frames[i, k, y0:y0 + 4, x0:x0 + 6] = 220
    # a second, moving blob in half of the videos
    frames[::2, :, 40:44, 60:66] = 230
    return frames, np.ones((V, T), bool)


def _jax_step(frames, valid, use_gsff):
    mesh = jshd.make_mesh(4)
    if use_gsff:
        params = jgsff.GSFFParams(fps=30.0, n_min=0, n_max=30, n_f=3)
        state0 = jtrk.init_tracker_state(MAX_SLOTS, dims=2, use_gsff=True,
                                         gsff_params=params)
        tkw = dict(max_disappeared=30.0, use_gsff=True,
                   gsff_gains=params.gains, gsff_n_i=params.n_i_arr,
                   gsff_n_f=params.n_f, gsff_n_i0=params.n_i[0])
    else:
        state0 = jtrk.init_tracker_state(MAX_SLOTS, dims=2)
        tkw = dict(max_disappeared=30.0, use_gsff=False)
    state = jax.tree_util.tree_map(lambda x: jnp.stack([x] * V), state0)
    step = jshd.make_multi_video_step(mesh, detect_kwargs=DKW,
                                      tracker_kwargs=tkw, emit_counts=True)
    _, em = step(jshd.shard_videos(mesh, frames),
                 jshd.shard_videos(mesh, valid), state)
    states = [jax.tree_util.tree_map(lambda x: np.asarray(x), state0)] * V
    return {k: np.asarray(v) for k, v in em.items()}, states


def _port_step(mesh, frames, valid, jstates, use_gsff):
    params = GSFFParams(fps=30.0, n_min=0, n_max=30, n_f=3) \
        if use_gsff else None
    states = []
    for s in jstates:
        st, tkw = trk.tracker_state_from_numpy(s, 'cpu', gsff_params=params)
        states.append(st)
    tkw = dict(max_disappeared=30.0, use_gsff=use_gsff, **tkw)
    step = shd.make_multi_video_step(mesh, detect_kwargs=DKW,
                                     tracker_kwargs=tkw)
    _, em = step(shd.shard_videos(mesh, frames),
                 shd.shard_videos(mesh, valid),
                 shd.shard_videos(mesh, shd.stack_states(states)))
    assert len(em) == len(mesh.local_shards)
    return {k: torch.cat([b[k] for b in em]).numpy() for k in em[0]}


@pytest.mark.parametrize('use_gsff', [False, True])
def test_multi_video_step_matches_jax(use_gsff):
    frames, valid = _videos()
    ref, jstates = _jax_step(frames, valid, use_gsff)
    got = _port_step(shd.make_mesh(4, device='cpu'), frames, valid, jstates,
                     use_gsff)
    assert got['mask'].shape == (V, T, MAX_SLOTS) and got['mask'].sum() > 10
    for key in ('mask', 'ids', 'det_col', 'n_det', 'n_components'):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_allclose(got['pos'], ref['pos'], rtol=0,
                               atol=1e-4 if use_gsff else 0)
    # the 2-axis (hosts, videos) layout and a 2-entry mesh: the 1-axis
    # mesh's emissions
    for mesh in (_port_mesh(4, hosts=2),
                 shd.make_mesh(2, device='cpu')):
        other = _port_step(mesh, frames, valid, jstates, use_gsff)
        for key in got:
            np.testing.assert_array_equal(other[key], got[key], err_msg=key)


@pytest.mark.parametrize('n', [1, 2, 4])
def test_multi_video_step_assigns_once_per_frame(monkeypatch, n):
    """The step runs the tracker once over each device's videos: on an
    n-entry mesh, ``row_min_argmin`` is called T times per device, each
    call over that device's V / n videos, not V / n * T times over one
    (the counterpart of jax.vmap(per_video), whose Pallas call batches the
    video axis into its grid)."""
    frames, valid = _videos()
    calls = []
    real = trk.row_min_argmin

    def counted(obj_xy, *args):
        calls.append(tuple(obj_xy.shape))
        return real(obj_xy, *args)

    monkeypatch.setattr(trk, 'row_min_argmin', counted)
    mesh = shd.make_mesh(n, device='cpu')
    _port_step(mesh, frames, valid,
               [jax.tree_util.tree_map(np.asarray,
                                       jtrk.init_tracker_state(MAX_SLOTS))]
               * V, False)
    assert calls == [(V // n, MAX_SLOTS, 2)] * (n * T)


def test_tracker_scan_sharded_assign_matches(monkeypatch):
    """run_tracker_scan(assign_mesh=...) emits exactly what the unsharded
    matcher emits on a dense stream with appearing and vanishing
    detections (test_sharding.py's scene)."""
    rng = np.random.default_rng(42)
    mesh = shd.make_mesh(4, axis='slots', device='cpu')
    t_len, c, s = 6, 96, 128
    xy = rng.uniform(0, 800, (t_len, c, 2)).astype(np.float32)
    xy[1:] = xy[:1] + np.cumsum(
        rng.normal(0, 1.0, (t_len - 1, c, 2)), axis=0).astype(np.float32)
    info = rng.uniform(1, 5, (t_len, c, 3)).astype(np.float32)
    valid = rng.random((t_len, c)) < 0.8
    args = [torch.from_numpy(a) for a in (xy, info, valid)]
    kwargs = dict(max_disappeared=3.0, use_gsff=False)
    ref_state, ref = trk.run_tracker_scan(
        trk.init_tracker_state(s, 'cpu'), *args, **kwargs)
    calls = []
    real = shd.sharded_row_min_argmin
    monkeypatch.setattr(shd, 'sharded_row_min_argmin',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    blocks = []
    block = fs._match_and_register
    monkeypatch.setattr(fs, '_match_and_register',
                        lambda *a, **k: blocks.append(1) or block(*a, **k))
    got_state, got = trk.run_tracker_scan(
        trk.init_tracker_state(s, 'cpu'), *args, assign_mesh=mesh, **kwargs)
    # the sharded candidates feed the same match-and-register block
    assert len(calls) == len(blocks) == t_len
    for key in ref:
        assert torch.equal(got[key], ref[key]), key
    for key in ref_state:
        assert torch.equal(got_state[key], ref_state[key]), key


@pytest.mark.e2e
def test_track_bacteria_sharded_assign_gate(tmp_path, monkeypatch):
    """'shard dense assignment across devices' with the device count set to
    4 and the threshold to 0: the device tracker goes through
    sharded_row_min_argmin and the rows are the unsharded run's, byte for
    byte. With one device (this host) the gate stays shut."""
    from ysmr_tpu_torch import track_bacteria
    clip = make_synthetic_video(str(tmp_path / 'dense.avi'), n_frames=32,
                                w=192, h=144, seed=5, n_bugs=10)
    base = _make_settings(tmp_path)
    base.update({'minimal length in seconds': 0.5, 'frame batch size': 8,
                 'max detections per frame': 32, 'max track slots': 64,
                 'transfer mode': 'pixels', 'cv2 exact rects': False})
    sharded = {**base, 'shard dense assignment across devices': True,
               'dense assignment shard threshold': 0}
    calls = []
    real = shd.sharded_row_min_argmin
    monkeypatch.setattr(shd, 'sharded_row_min_argmin',
                        lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    out = {}
    for name, settings in (('ref', base), ('one_device', sharded)):
        folder = str(tmp_path / name)
        os.makedirs(folder)
        res = track_bacteria(clip, settings=dict(settings),
                             result_folder=folder, device='cpu')
        assert res is not None
        out[name] = open(res[4], 'rb').read()
    assert not calls and out['one_device'] == out['ref']
    monkeypatch.setattr(shd, 'device_count', lambda kind: 4)
    for name, settings, engaged in (
            ('sharded', sharded, True),
            ('uneven', {**sharded, 'max track slots': 66}, False),
            ('small', {**sharded, 'dense assignment shard threshold':
                       64 * 32 + 1}, False)):
        calls.clear()
        folder = str(tmp_path / name)
        os.makedirs(folder)
        res = track_bacteria(clip, settings=dict(settings),
                             result_folder=folder, device='cpu')
        assert res is not None
        assert bool(calls) == engaged, name
        if engaged:
            assert {m.size for m in calls} == {4}
            assert calls[0].axis_names == ('slots',)
            assert out['ref'].count(b'\n') > 100
            assert open(res[4], 'rb').read() == out['ref']


@pytest.mark.cuda
def test_sharded_greedy_assign_on_cuda():
    """The kernel on one card listed 1, 2 and 4 times: the unsharded
    kernel's result, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    dev = torch.device('cuda', 0)
    for k in (2, 3):
        args = [torch.from_numpy(a).to(dev)
                for a in _assign_inputs(k, r=4096, c=1024)]
        want = asg.greedy_assign_from_candidates(
            *shd.row_min_argmin(*args), args[1], args[3])
        for n in (1, 2, 4):
            got = shd.sharded_greedy_assign(shd.Mesh([dev] * n, ('slots',)),
                                            *args)
            for key in want:
                assert torch.equal(got[key], want[key]), (k, n, key)
