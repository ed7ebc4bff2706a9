"""Device tracker of the PyTorch port (ysmr_tpu_torch/pipeline/tracker.py,
ops/gsff.py) against the JAX package's run_tracker_scan on the parity
scenarios of tests/test_tracker.py, plus the renumberer and
tracker_state_from_numpy.

Tolerances and why:
- frame, TRACK_ID, W/H/angle, and positions without GSFF: equal (the
  matching distances are bit-equal, and positions are copied detections);
- GSFF positions: 1e-4 px. XLA:CPU contracts the double-single filter
  arithmetic into fmas that PyTorch does not form, and the float64-rounded
  exp/log of the port differ from XLA's float32 ones by an ulp; both move
  the float32 outputs by a few ulps of the coordinates (~3e-5 px at
  400 px).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_tracker import _drifting_scene
from ysmr_tpu.ops import gsff as jgsff
from ysmr_tpu.pipeline import tracker as jtrk
from ysmr_tpu_torch.ops import gsff
from ysmr_tpu_torch.ops.assign import row_min_argmin
from ysmr_tpu_torch.pipeline import tracker as trk

torch.set_num_threads(1)


def _tables(frames, max_det=8):
    t_len = len(frames)
    det_xy = np.zeros((t_len, max_det, 2), np.float32)
    det_info = np.zeros((t_len, max_det, 3), np.float32)
    det_valid = np.zeros((t_len, max_det), bool)
    for t, dets in enumerate(frames):
        for j, (xy, whd) in enumerate(dets):
            det_xy[t, j] = xy
            det_info[t, j] = whd
            det_valid[t, j] = True
    return det_xy, det_info, det_valid


def _jax_scan(tables, fps, use_gsff, max_slots, state=None, dims=2):
    kwargs = dict(max_disappeared=float(fps), use_gsff=use_gsff)
    params = None
    if use_gsff:
        params = jgsff.GSFFParams(fps=fps, n_min=0, n_max=30, n_f=3)
        kwargs.update(gsff_gains=params.gains, gsff_n_i=params.n_i_arr,
                      gsff_n_f=params.n_f, gsff_n_i0=params.n_i[0])
    if state is None:
        state = jtrk.init_tracker_state(max_slots, dims=dims,
                                        use_gsff=use_gsff, gsff_params=params)
    state, em = jtrk.run_tracker_scan(state, *tables, **kwargs)
    return jax.tree.map(np.asarray, state), jax.tree.map(np.asarray, em)


def _port_scan(tables, fps, use_gsff, max_slots, state=None, kwargs=None,
               device='cpu', dims=2):
    params = gsff.GSFFParams(fps=fps, n_min=0, n_max=30, n_f=3) \
        if use_gsff else None
    if state is None:
        state = trk.init_tracker_state(max_slots, device, dims=dims,
                                       use_gsff=use_gsff, gsff_params=params)
        kwargs = trk.gsff_kwargs(params, device) if use_gsff else {}
    state, em = trk.run_tracker_scan(
        state, *(torch.from_numpy(a).to(device) for a in tables),
        max_disappeared=float(fps), use_gsff=use_gsff, **kwargs)
    return state, {k: v.cpu().numpy() for k, v in em.items()}


def _assert_emissions(got, ref, pos_tol):
    for key in ('mask', 'ids', 'det_col', 'n_det'):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_array_equal(got['info'], ref['info'])
    if pos_tol == 0:
        np.testing.assert_array_equal(got['pos'], ref['pos'])
    else:
        np.testing.assert_allclose(got['pos'], ref['pos'], atol=pos_tol,
                                   rtol=0)


def _rng():
    """The seed of the JAX tests' ``rng`` fixture."""
    return np.random.default_rng(42)


SCENES = {
    'drifting': lambda: (_drifting_scene(_rng()), 30.0),
    'empty_frames': lambda: (_empty_frames(), 30.0),
    'dereg_after_grace': lambda: (_dereg(), 5.0),
    'contested': lambda: (_contested(), 30.0),
    'gsff_disappearance': lambda: (_blink(), 8.0),
}


def _empty_frames():
    frames = _drifting_scene(_rng(), n_frames=20)
    frames[5] = []
    frames[6] = []
    return frames


def _dereg():
    frames = [[((10.0, 10.0), (3.0, 2.0, 0.0)),
               ((50.0, 50.0), (4.0, 2.0, 0.0))]]
    frames += [[] for _ in range(10)]
    frames += [[((12.0, 11.0), (3.0, 2.0, 0.0))]]
    return frames


def _contested():
    frames = []
    for t in range(12):
        a = (100.0 - 4.0 * t, 100.0)
        b = (140.0 - 7.0 * t, 100.0)
        frames.append([(a, (4.0, 2.0, 0.0)), (b, (4.0, 2.0, 10.0))])
    for t in range(6):
        frames.append([((52.0 + t, 100.0), (4.0, 2.0, 20.0))])
    return frames


def _blink():
    frames = []
    for t in range(40):
        dets = []
        if not (15 <= t < 20):  # object blinks out within grace
            dets.append(((100.0 + 3.0 * t, 50.0), (4.0, 2.0, 0.0)))
        dets.append(((300.0, 200.0 + 2.0 * t), (3.0, 3.0, 90.0)))
        frames.append(dets)
    return frames


@pytest.mark.parametrize('use_gsff', [False, True])
@pytest.mark.parametrize('scene', sorted(SCENES))
def test_scan_matches_jax(scene, use_gsff):
    frames, fps = SCENES[scene]()
    tables = _tables(frames)
    _, ref = _jax_scan(tables, fps, use_gsff, 32)
    _, got = _port_scan(tables, fps, use_gsff, 32)
    _assert_emissions(got, ref, 1e-4 if use_gsff else 0)


@pytest.mark.parametrize('use_gsff', [False, True])
@pytest.mark.parametrize('scene', ['drifting', 'contested',
                                   'gsff_disappearance'])
def test_scan_with_luminosity_matches_jax(scene, use_gsff):
    """dims = 3 (luminosity as the third coordinate): the matching uses
    all three (the K = 3 assign kernel's contract), GSFF filters x and y
    and carries the luminosity. Ids, W/H/angle and the luminosity column
    equal JAX's; x and y equal without GSFF and within 1e-4 px with it."""
    frames, fps = SCENES[scene]()
    det_xy, det_info, det_valid = _tables(frames)
    lum = np.random.default_rng(3).uniform(0.3, 2.5, det_valid.shape)
    tables = (np.concatenate([det_xy, lum[..., None].astype(np.float32)],
                             axis=-1), det_info, det_valid)
    _, ref = _jax_scan(tables, fps, use_gsff, 32, dims=3)
    _, got = _port_scan(tables, fps, use_gsff, 32, dims=3)
    assert got['pos'].shape[-1] == 3
    np.testing.assert_array_equal(got['pos'][..., 2], ref['pos'][..., 2])
    _assert_emissions(got, ref, 1e-4 if use_gsff else 0)


def test_slot_capacity_drops_registrations():
    """More detections than slots: the overflow is counted, not raised."""
    frames = [[((10.0 * i, 5.0), (3.0, 2.0, 0.0)) for i in range(8)]]
    tables = _tables(frames)
    jstate, ref = _jax_scan(tables, 30.0, True, 5)
    state, got = _port_scan(tables, 30.0, True, 5)
    _assert_emissions(got, ref, 1e-4)
    assert int(state['dropped_registrations']) == 3
    assert int(jstate['dropped_registrations']) == 3


def test_state_from_numpy_continues_like_jax():
    """Both trackers continue from the same mid-run JAX state (GSFF
    included): tracker_state_from_numpy carries every field over."""
    frames = _drifting_scene(_rng(), n_frames=70)
    first, second = _tables(frames[:40]), _tables(frames[40:])
    jstate, _ = _jax_scan(first, 30.0, True, 32)
    _, ref = _jax_scan(second, 30.0, True, 32,
                       state=jax.tree.map(np.asarray, jstate))
    params = gsff.GSFFParams(fps=30.0, n_min=0, n_max=30, n_f=3)
    state, kwargs = trk.tracker_state_from_numpy(jstate, 'cpu',
                                                 gsff_params=params)
    assert set(state) == set(jstate) and set(state['gsff']) == \
        set(jstate['gsff'])
    for key in ('active', 'ids', 'pos', 'disappeared', 'next_id'):
        np.testing.assert_array_equal(state[key].numpy(), jstate[key])
    _, got = _port_scan(second, 30.0, True, 32, state=state, kwargs=kwargs)
    _assert_emissions(got, ref, 1e-4)


def _random_gsff_state(rng, s, jp, width=400):
    """A random mid-run filter state of ``s`` slots at coordinates up to
    ``width`` px (the JAX package's state, as numpy arrays)."""
    st = jax.tree.map(np.asarray, jgsff.init_state(jp, s))
    base = rng.uniform(50, width, (s, 1, 2)).astype(np.float32)
    walk = np.cumsum(rng.normal(0, 1, (s, jp.buf_len, 2)), axis=1)
    st['buf'] = (base + walk).astype(np.float32)
    st['buf_lo'] = (rng.uniform(-1, 1, st['buf'].shape) * 1e-6).astype(
        np.float32)
    st['len'] = rng.integers(0, jp.buf_len + 1, s).astype(np.int32)
    # the filters whose horizon the ring has reached
    st['mode'] = (st['len'][:, None] >= np.asarray(jp.n_i)[None]).sum(
        1).astype(np.int32)
    st['log_w'] = np.where(np.arange(jp.n_f)[None] < st['mode'][:, None],
                           np.log(rng.dirichlet(np.ones(jp.n_f), s)),
                           gsff.NEG_INF).astype(np.float32)
    return st


def _jax_register_fill(jp, st, register, meas):
    """The register fill inlined in ysmr_tpu's tracker frame step
    (ysmr_tpu/pipeline/tracker.py): the ring filled with the measurement,
    the first horizon's length, no mode, no weights."""
    m = jnp.asarray(meas, jnp.float32)
    reg = jnp.asarray(register)
    return {
        'buf': jnp.where(reg[:, None, None],
                         jnp.broadcast_to(m[:, None, :], st['buf'].shape),
                         st['buf']),
        'buf_lo': jnp.where(reg[:, None, None], 0.0, st['buf_lo']),
        'len': jnp.where(reg, jnp.int32(jp.n_i[0]), st['len']),
        'mode': jnp.where(reg, 0, st['mode']),
        'log_w': jnp.where(reg[:, None], jgsff.NEG_INF, st['log_w']),
        'pred_lo': jnp.where(reg[:, None], 0.0, st['pred_lo']),
    }


def _both_steps(jp, tp, st, meas, active, mlo=None, register=None,
                coasting=None):
    """One filter step of both packages from the numpy state ``st``: with
    ``mlo`` their ``step``; with ``register`` and ``coasting`` the
    tracker's GSFF block, ysmr_tpu's inlined fill and ``_step`` against
    the port's ``register_and_step`` (a coasting slot's lo half is its
    ``pred_lo``)."""
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    if register is None:
        jst, jcor, jpred = jgsff.step(jp, st, meas, active, mlo)
        tst, tcor, tpred = gsff.step(
            tp, tp.gains_on('cpu'), tstate, torch.from_numpy(meas),
            torch.from_numpy(active), torch.from_numpy(mlo))
    else:
        jmlo = np.where(coasting[:, None], st['pred_lo'], 0.0).astype(
            np.float32)
        jst, jcor, jpred = jgsff._step(
            jp.gains, jp.n_i_arr, jp.n_f,
            _jax_register_fill(jp, st, register, meas), meas, active, jmlo)
        tst, tcor, tpred = gsff.register_and_step(
            tp.gains_on('cpu'), torch.tensor(tp.n_i, dtype=torch.int32),
            tp.n_f, tp.n_i[0], tstate, torch.from_numpy(meas),
            torch.from_numpy(active), torch.from_numpy(register),
            torch.from_numpy(coasting))
    return (jst, np.asarray(jcor), np.asarray(jpred)), \
        (tst, tcor.numpy(), tpred.numpy())


def test_gsff_step_matches_jax():
    """One filter step from a random mid-run state, coasting lo halves
    included."""
    rng = np.random.default_rng(4)
    s = 40
    jp = jgsff.GSFFParams(fps=30.0)
    tp = gsff.GSFFParams(fps=30.0)
    np.testing.assert_array_equal(tp.gains_ds, np.asarray(jp.gains))
    st = _random_gsff_state(rng, s, jp)
    meas = (st['buf'][:, -1] + rng.normal(0, 1, (s, 2))).astype(np.float32)
    mlo = (rng.uniform(-1, 1, (s, 2)) * 1e-6).astype(np.float32)
    active = rng.random(s) < 0.8
    (jst, jcor, jpred), (tst, tcor, tpred) = _both_steps(jp, tp, st, meas,
                                                         active, mlo)
    np.testing.assert_allclose(tcor, jcor, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tpred, jpred, atol=1e-4, rtol=0)
    for key in ('len', 'mode', 'buf'):
        np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]))
    np.testing.assert_allclose(tst['log_w'].numpy(), np.asarray(jst['log_w']),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('width,innovation,tol', [
    (400, 1.0, 5e-4), (1200, 1.0, 1e-3), (1200, 12.0, 5e-3)])
def test_gsff_step_residue_by_innovation(width, innovation, tol):
    """How far one filter step of the two packages can lie apart, over
    4000 slots: the modes' float32 log weights differ in their last bits
    (2e-5 at most), and the step blends modes whose estimates lie further
    apart the further the measurement lies from the track. So the residue
    grows with the coordinates (a float32 ulp) and with the innovation:
    2.2e-4 px at 400 px and 1 px, 7.4e-4 px at 1200 px and 1 px, 2.9e-3 px
    at 1200 px and 12 px. These are the sizes the dense scene shows on
    tracks that both packages match alike (tests/test_torch_dense_ids.py).
    """
    rng = np.random.default_rng(4)
    s = 4000
    jp = jgsff.GSFFParams(fps=30.0)
    tp = gsff.GSFFParams(fps=30.0)
    st = _random_gsff_state(rng, s, jp, width)
    meas = (st['buf'][:, -1] + rng.normal(0, innovation, (s, 2))).astype(
        np.float32)
    (jst, jcor, jpred), (tst, tcor, tpred) = _both_steps(
        jp, tp, st, meas, np.ones(s, bool), np.zeros((s, 2), np.float32))
    np.testing.assert_allclose(tcor, jcor, atol=tol, rtol=0)
    np.testing.assert_allclose(tpred, jpred, atol=tol, rtol=0)
    # the residue is there: a tenth of the tolerance would not hold
    assert np.abs(tpred - jpred).max() > tol / 10
    for key in ('len', 'mode', 'buf'):
        np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]))
    jw, tw = np.asarray(jst['log_w']), tst['log_w'].numpy()
    live = jw > gsff.NEG_INF / 2
    np.testing.assert_array_equal(live, tw > gsff.NEG_INF / 2)
    np.testing.assert_allclose(tw[live], jw[live], atol=2e-5, rtol=0)


@pytest.mark.parametrize('seed', [0, 1])
def test_renumberer_same_as_jax(seed):
    """The copied renumberer replays registrations as the JAX one does,
    including frames whose unmatched columns wrap CPython's set table."""
    rng = np.random.default_rng(seed)
    t_len, s = 6, 300
    mask = rng.random((t_len, s)) < 0.6
    ids = np.zeros((t_len, s), np.int32)
    det_col = np.full((t_len, s), -1, np.int32)
    nxt = 0
    for t in range(t_len):
        live = np.nonzero(mask[t])[0]
        fresh = live[rng.random(live.size) < 0.3]
        old = np.setdiff1d(live, fresh)
        ids[t, old] = rng.integers(0, max(nxt, 1), old.size)
        ids[t, fresh] = nxt + np.arange(fresh.size)
        nxt += fresh.size
        cols = rng.permutation(400)[:live.size]
        det_col[t, live] = cols
    n_det = np.full(t_len, 400, np.int32)
    fv = np.ones(t_len, bool)
    a = jtrk.ReferenceOrderRenumberer()
    b = trk.ReferenceOrderRenumberer()
    np.testing.assert_array_equal(
        b.observe_batch(mask, ids, det_col, n_det, fv),
        a.observe_batch(mask, ids, det_col, n_det, fv))


@pytest.mark.cuda
def test_scan_on_cuda_equals_cpu():
    """The whole frame step on the card (assign kernel included) against
    the CPU run: equal ids and matches, positions within the stated GSFF
    tolerance. Runs on a machine with an NVIDIA GPU (see README)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    rng = np.random.default_rng(11)
    t_len, c, s = 12, 600, 1024
    det_xy = rng.uniform(0, 1228, (t_len, c, 2)).astype(np.float32)
    det_xy[1:] = det_xy[:1] + np.cumsum(
        rng.normal(0, 1.5, (t_len - 1, c, 2)), axis=0).astype(np.float32)
    det_info = rng.uniform(1, 8, (t_len, c, 3)).astype(np.float32)
    det_valid = rng.random((t_len, c)) < 0.9
    tables = (det_xy, det_info, det_valid)
    _, cpu = _port_scan(tables, 30.0, True, s)
    before = row_min_argmin.launches
    _, gpu = _port_scan(tables, 30.0, True, s, device='cuda')
    torch.cuda.synchronize()
    assert row_min_argmin.launches == before + t_len
    _assert_emissions(gpu, cpu, 1e-4)


#: the batched scans' videos: mixed scenes, padded with empty frames to
#: one length, and a video whose frames are all invalid (a finished video
#: stepping along with the others)
BATCH_SCENES = ('drifting', 'contested', 'gsff_disappearance',
                'dereg_after_grace', None)


def _video_batch(dims):
    """(V, T, ...) tables of BATCH_SCENES at 30 fps, luminosity as the
    third coordinate with ``dims`` = 3."""
    tables = [_tables(SCENES[name]()[0]) if name else None
              for name in BATCH_SCENES]
    t_len = max(t[0].shape[0] for t in tables if t is not None)
    empty = (np.zeros((t_len, 8, 2), np.float32),
             np.zeros((t_len, 8, 3), np.float32), np.zeros((t_len, 8), bool))
    out = []
    for tab in tables:
        full = [e.copy() for e in empty]
        if tab is not None:
            for f, a in zip(full, tab):
                f[:a.shape[0]] = a
        out.append(full)
    det_xy, det_info, det_valid = (np.stack(x) for x in zip(*out))
    if dims == 3:
        lum = np.random.default_rng(3).uniform(0.3, 2.5, det_valid.shape)
        det_xy = np.concatenate([det_xy, lum[..., None].astype(np.float32)],
                                axis=-1)
    return det_xy, det_info, det_valid


def _port_setup(v, use_gsff, dims, device='cpu', max_slots=32):
    params = gsff.GSFFParams(fps=30.0, n_min=0, n_max=30, n_f=3) \
        if use_gsff else None
    state = trk.init_tracker_state(max_slots, device, dims=dims,
                                   use_gsff=use_gsff, gsff_params=params)
    kwargs = dict(max_disappeared=30.0, use_gsff=use_gsff)
    if use_gsff:
        kwargs.update(trk.gsff_kwargs(params, device))
    stacked = {k: (torch.stack([x] * v) if torch.is_tensor(x) else
                   {g: torch.stack([y] * v) for g, y in x.items()})
               for k, x in state.items()}
    return state, stacked, kwargs


def _flat_state(state):
    out = {}
    for k, x in state.items():
        if isinstance(x, dict):
            out.update({'gsff.' + g: y for g, y in x.items()})
        else:
            out[k] = x
    return out


def _batched_and_per_video(tables, use_gsff, dims, device='cpu'):
    """The batched scan over two batches of frames (the state threading
    through) and each video's own scans: (batched state, emissions),
    [(state, emissions) per video]."""
    v, t_len = tables[2].shape[:2]
    split = t_len // 2
    args = [torch.from_numpy(a).to(device) for a in tables]
    state0, stacked, kwargs = _port_setup(v, use_gsff, dims, device)
    parts = []
    for sl in (slice(0, split), slice(split, None)):
        stacked, em = trk.run_tracker_scan(stacked, *(a[:, sl] for a in args),
                                           **kwargs)
        parts.append(em)
    batched = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
    singles = []
    for i in range(v):
        st, ems = state0, []
        for sl in (slice(0, split), slice(split, None)):
            st, em = trk.run_tracker_scan(st, *(a[i, sl] for a in args),
                                          **kwargs)
            ems.append(em)
        singles.append((st, {k: torch.cat([e[k] for e in ems])
                             for k in ems[0]}))
    return (stacked, batched), singles


@pytest.mark.parametrize('dims', [2, 3])
@pytest.mark.parametrize('use_gsff', [False, True])
def test_batched_scan_equals_per_video_scans(use_gsff, dims):
    """One scan over V = 5 videos (mixed scenes, one all-invalid) equals
    the five videos' own scans bit for bit: every emission and every
    state tensor, the state carried across two batches."""
    tables = _video_batch(dims)
    (state, em), singles = _batched_and_per_video(tables, use_gsff, dims)
    v = tables[2].shape[0]
    assert em['mask'].shape == (v, tables[2].shape[1], 32)
    assert em['n_det'].shape == tables[2].shape[:2]
    assert int(em['mask'][:-1].sum()) > 100 and not em['mask'][-1].any()
    flat = _flat_state(state)
    for i, (st, one) in enumerate(singles):
        for key in one:
            assert torch.equal(em[key][i], one[key]), (i, key)
        for key, x in _flat_state(st).items():
            assert torch.equal(flat[key][i], x), (i, key)


def test_batched_scan_of_one_video_equals_the_unbatched_scan():
    """V = 1 with the video axis written out: the unbatched scan's
    emissions and state with a leading axis of 1."""
    tables = _tables(SCENES['drifting']()[0])
    state, stacked, kwargs = _port_setup(1, True, 2)
    args = [torch.from_numpy(a) for a in tables]
    st1, em1 = trk.run_tracker_scan(state, *args, **kwargs)
    stv, emv = trk.run_tracker_scan(stacked, *(a[None] for a in args),
                                    **kwargs)
    for key in em1:
        assert torch.equal(emv[key][0], em1[key]), key
    for key, x in _flat_state(st1).items():
        assert torch.equal(_flat_state(stv)[key][0], x), key


@pytest.mark.parametrize('use_gsff', [False, True])
def test_batched_scan_matches_jax_vmap(use_gsff):
    """The batched scan against ``jax.vmap(run_tracker_scan)`` of
    ``ysmr_tpu`` on the same five videos: mask, ids, det_col, n_det and
    info equal; positions equal without GSFF and within 1e-4 px with it
    (the double-single residue of ``test_scan_matches_jax``)."""
    tables = _video_batch(2)
    v = tables[2].shape[0]
    kwargs = dict(max_disappeared=30.0, use_gsff=use_gsff)
    params = None
    if use_gsff:
        params = jgsff.GSFFParams(fps=30.0, n_min=0, n_max=30, n_f=3)
        kwargs.update(gsff_gains=params.gains, gsff_n_i=params.n_i_arr,
                      gsff_n_f=params.n_f, gsff_n_i0=params.n_i[0])
    jstate = jtrk.init_tracker_state(32, dims=2, use_gsff=use_gsff,
                                     gsff_params=params)
    jstate = jax.tree.map(lambda x: np.stack([np.asarray(x)] * v), jstate)
    _, ref = jax.vmap(lambda st, a, b, c: jtrk.run_tracker_scan(
        st, a, b, c, **kwargs))(jstate, *tables)
    ref = jax.tree.map(np.asarray, ref)
    _, stacked, tkw = _port_setup(v, use_gsff, 2)
    _, got = trk.run_tracker_scan(stacked, *(torch.from_numpy(a)
                                             for a in tables), **tkw)
    got = {k: x.numpy() for k, x in got.items()}
    assert got['mask'].shape == ref['mask'].shape
    _assert_emissions(got, ref, 1e-4 if use_gsff else 0)


def test_assign_mesh_takes_one_video():
    """The row-sharded assignment is a one-video path (the JAX
    multi-video step passes no mesh): a batch of videos raises."""
    from ysmr_tpu_torch.parallel import sharding as shd
    tables = _video_batch(2)
    _, stacked, kwargs = _port_setup(tables[2].shape[0], False, 2)
    with pytest.raises(ValueError, match='one video'):
        trk.run_tracker_scan(stacked, *(torch.from_numpy(a) for a in tables),
                             assign_mesh=shd.make_mesh(2, axis='slots',
                                                       device='cpu'),
                             **kwargs)
    with pytest.raises(ValueError, match='video axis'):
        trk.run_tracker_scan(stacked, *(torch.from_numpy(a[0])
                                        for a in tables), **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize('use_gsff', [False, True])
def test_batched_scan_on_cuda_equals_per_video_scans(use_gsff):
    """The batched scan on the card (one assign launch per frame for all
    videos) against the per-video scans on the card, bit for bit. Runs on
    a machine with an NVIDIA GPU (see README)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    tables = _video_batch(3)
    t_len = tables[2].shape[1]
    before = row_min_argmin.launches
    (state, em), singles = _batched_and_per_video(tables, use_gsff, 3,
                                                  device='cuda')
    torch.cuda.synchronize()
    v = tables[2].shape[0]
    assert row_min_argmin.launches == before + t_len * (1 + v)
    flat = _flat_state(state)
    for i, (st, one) in enumerate(singles):
        for key in one:
            assert torch.equal(em[key][i], one[key]), (i, key)
        for key, x in _flat_state(st).items():
            assert torch.equal(flat[key][i], x), (i, key)
