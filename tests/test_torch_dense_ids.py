"""Track ids of the two packages on the dense scene, both on the CPU.

The dense clip of bench.py (seed 125, 3000 rods, 1228x922) at the dense
capacities (bench.py ``measure_dense_e2e``: 4096 detections, 4096 slots,
max_bh 48, 131072 foreground pixels, batch 64), through the device-tracker
path (the default gate: above 1024 detections the rects and the
double-single GSFF tracker run on the device) of ``ysmr_tpu`` and of
``ysmr_tpu_torch``, each with its ``track_bacteria(path)`` on the same MJPG
file. The two packages' track counts on this clip were only ever taken on
different hardware; here they share one backend.

Both packages' ``run_tracker_scan`` are wrapped for the run: each batch is
also replayed one frame at a time, so that for every frame there are the
detection tables that reached the tracker, the positions the tracker held
before the frame (the filter's predictions, which the matching measures
its distances from) and the detection each slot took. From these the test
finds every frame where a track takes another detection in one package
than in the other, down to the pair of tracks and detections and the
distances between them (``_divergences``), and holds:

- the detection tables of the two packages are the same bits on every
  frame, so whatever differs comes from the tracker;
- where a track is matched to the same detections by both packages in
  every frame, its rows are within the filter's residue (``RESIDUE_TOL``
  a step, and as much again for every frame it coasted within the filter's
  horizon) and its rect columns are equal;
- every divergence that is not downstream of an earlier one is a near-tie
  that the difference between the two packages' predictions can turn: the
  two distances that decided it differ by less than the bound that this
  difference sets (``_divergences``);
- such divergences are few (``MAX_PRIMARY``), rows that only one package
  has belong to diverging tracks, and on the default 64 frames the
  diverging tracks are the named ones (``DIVERGING_64``).

Marked ``slow``: it takes minutes and gigabytes at full width, so the
default test run leaves it out. Run it with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dense_ids.py -m slow -s

``YSMR_DENSE_IDS_FRAMES`` sets the number of frames (default 64, one
batch; the whole clip has 150). ``YSMR_DENSE_IDS_DUMP`` names an ``.npz``
file to write the recorded frames of both packages to (their rows go
beside it as ``.csv.gz``).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KEYS = ['TRACK_ID', 'POSITION_T']
PRE = ('pos', 'ids', 'active')
EMITTED = ('mask', 'ids', 'det_col', 'pos', 'info', 'n_det')


def _np(x):
    return (x.cpu().numpy() if hasattr(x, 'cpu') else np.asarray(x)).copy()


def _recording(orig, store):
    """``run_tracker_scan`` that also replays the batch one frame at a time
    from the same state and appends, per frame, what the tracker held
    before it, the detections and what it emitted."""
    def run(state, det_xy, det_info, det_valid, **kw):
        out_state, em = orig(state, det_xy, det_info, det_valid, **kw)
        st = state
        for t in range(det_xy.shape[0]):
            rec = {'pre_' + k: _np(st[k]) for k in PRE}
            st, one = orig(st, det_xy[t:t + 1], det_info[t:t + 1],
                           det_valid[t:t + 1], **kw)
            rec.update({k: _np(one[k])[0] for k in EMITTED})
            rec['det_xy'] = _np(det_xy[t])
            rec['det_valid'] = _np(det_valid[t])
            # the replay has to be the scan's own bits to stand for it
            rec['replay_is_scan'] = all(
                np.array_equal(_np(one[k])[0], _np(em[k])[t])
                for k in EMITTED)
            store.append(rec)
        return out_state, em
    return run


@pytest.fixture(scope='module')
def dense_runs(tmp_path_factory):
    """Both packages over the dense clip: name -> (rows, recorded frames)."""
    import bench
    from ysmr_tpu.pipeline import tracker as jtrk
    from ysmr_tpu.pipeline.track_bacteria import track_bacteria as jtrack
    from ysmr_tpu_torch import track_bacteria
    from ysmr_tpu_torch.pipeline import tracker as trk
    from ysmr_tpu_torch.pipeline.track_bacteria import use_host_rects

    tmp_path = tmp_path_factory.mktemp('dense_ids')
    n_frames = int(os.environ.get('YSMR_DENSE_IDS_FRAMES', 64))
    clip = bench.make_clip(str(tmp_path / 'dense_clip.avi'), n_frames,
                           seed=bench.SEED + 2, n_bugs=bench.DENSE_CLIP_BUGS)
    settings = bench.bench_settings({
        'minimal frame count': min(32, n_frames // 2),
        'max detections per frame': 4096, 'max track slots': 4096,
        'max bounding box height': 48,
        'max foreground pixels per frame': 131072, 'frame batch size': 64})
    assert not use_host_rects(settings)
    out = {'n_frames': n_frames}
    for name, fn, mod, extra, kw in (
            ('jax', jtrack, jtrk, {'run cc': 'on'}, {}),
            ('torch', track_bacteria, trk, {}, {'device': 'cpu'})):
        folder = str(tmp_path / name)
        os.makedirs(folder)
        frames = []
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(mod, 'run_tracker_scan',
                          _recording(mod.run_tracker_scan, frames))
            res = fn(clip, settings={**settings, **extra},
                     result_folder=folder, **kw)
        assert res is not None, name
        out[name] = (res[0], frames[:n_frames])
    dump = os.environ.get('YSMR_DENSE_IDS_DUMP')
    if dump:
        np.savez_compressed(dump, **{
            '{}_{}'.format(name, k): np.stack([f[k] for f in out[name][1]])
            for name in ('jax', 'torch') for k in out[name][1][0]})
        for name in ('jax', 'torch'):
            out[name][0].to_csv(dump + '.' + name + '.csv.gz', index=False)
    return out


def _by_id(rec):
    """Device id -> detection column (-1 while coasting) of one frame's
    live slots, and device id -> slot before the frame."""
    live = np.nonzero(rec['mask'])[0]
    now = {int(rec['ids'][s]): int(rec['det_col'][s]) for s in live}
    before = {int(rec['pre_ids'][s]): int(s)
              for s in np.nonzero(rec['pre_active'])[0]}
    return now, before


def _row(rec, slot):
    """Float64 distances from the position a slot held before the frame
    (the filter's prediction) to every detection; invalid ones at inf."""
    diff = rec['det_xy'][:, :2].astype(np.float64) - \
        rec['pre_pos'][slot, :2].astype(np.float64)
    return np.where(rec['det_valid'], np.hypot(diff[:, 0], diff[:, 1]),
                    np.inf)


def _divergences(jax_frames, torch_frames):
    """Every frame and track where the two packages' trackers took
    different detections, each with the readings that decided it.

    The matcher gives every track its nearest detection, and a detection
    that several tracks claim to the nearest of them; the others coast. So
    a track diverges in one of two ways, and the predictions of the two
    packages (apart by ``shift``) can turn either only within a bound (a
    distance moves by at most the shift of its prediction):

    - ``detections``: its nearest detection is another one in each package;
      then its distances to the two differ by at most 2 * shift in both;
    - ``rival``: both packages give it the same nearest detection, which it
      wins in one package and loses to a rival track in the other; then the
      two tracks' distances to it differ by at most the sum of their
      shifts.

    A divergence is ``explained`` if its margin is within that bound, and
    ``downstream`` if the track, or its rival, diverged in an earlier frame
    (their states then differ by more than a residue).

    :return: list of dicts ``frame``, ``id`` (device id), ``kind``,
        ``margin`` and ``bound`` (px; None where the track or its rival was
        not held before the frame), ``shift`` (px), ``downstream``,
        ``explained``, ``text``
    """
    tainted, events = set(), []
    for t, (jr, tr) in enumerate(zip(jax_frames, torch_frames)):
        recs = {'jax': jr, 'torch': tr}
        now, before = {}, {}
        for k, r in recs.items():
            now[k], before[k] = _by_id(r)
        differ = sorted(i for i in set(now['jax']) | set(now['torch'])
                        if now['jax'].get(i) != now['torch'].get(i))

        def shift(i):
            return float(np.hypot(*(
                jr['pre_pos'][before['jax'][i], :2].astype(np.float64) -
                tr['pre_pos'][before['torch'][i], :2])))

        frame_events = []
        for i in differ:
            ev = {'frame': t, 'id': i, 'kind': 'unheld', 'margin': None,
                  'bound': None, 'shift': None, 'downstream': i in tainted}
            took = {k: now[k].get(i) for k in recs}
            if all(i in before[k] for k in recs):
                rows = {k: _row(r, before[k][i]) for k, r in recs.items()}
                near = {k: int(np.argmin(rows[k])) for k in recs}
                ev['shift'] = shift(i)
                text = ['{} predicted at ({:.5f}, {:.5f}), took {}'.format(
                    k, *recs[k]['pre_pos'][before[k][i], :2], took[k])
                    for k in recs]
                if near['jax'] != near['torch']:
                    ev['kind'] = 'detections'
                    ev['margin'] = max(abs(
                        rows[k][near['jax']] - rows[k][near['torch']])
                        for k in recs)
                    ev['bound'] = 2 * ev['shift']
                    text += ['{}: detection {} at {:.6f} px, detection {} at '
                             '{:.6f} px'.format(
                                 k, near['jax'], rows[k][near['jax']],
                                 near['torch'], rows[k][near['torch']])
                             for k in recs]
                else:
                    c = near['jax']
                    ev['kind'] = 'rival'
                    rivals = {j for k in recs for j, col in now[k].items()
                              if col == c and j != i}
                    text.append('both nearest to detection {}, rivals '
                                '{}'.format(c, sorted(rivals)))
                    ev['downstream'] |= bool(rivals & tainted)
                    held = [j for j in rivals
                            if all(j in before[k] for k in recs)]
                    if len(rivals) == 1 and held:
                        j = held[0]
                        there = {k: _row(r, before[k][j])[c]
                                 for k, r in recs.items()}
                        ev['margin'] = max(abs(rows[k][c] - there[k])
                                           for k in recs)
                        ev['bound'] = ev['shift'] + shift(j)
                        text += ['{}: {:.6f} px from it, rival {} {:.6f} '
                                 'px'.format(k, rows[k][c], j, there[k])
                                 for k in recs]
                ev['text'] = '; '.join(text)
            else:
                ev['text'] = 'held before the frame by {}'.format(
                    [k for k in recs if i in before[k]])
            ev['explained'] = ev['margin'] is not None and \
                ev['margin'] <= ev['bound']
            frame_events.append(ev)
        events += frame_events
        tainted |= {ev['id'] for ev in frame_events}
    return events


def _residues(jax_frames, torch_frames, diverging):
    """Rows of the tracks that both packages match alike: (frame, device
    id, px between the two emitted positions, frames of the last
    ``HORIZON`` in which the track coasted)."""
    coasted, rows = {}, []
    for t, (jr, tr) in enumerate(zip(jax_frames, torch_frames)):
        slots = [{int(r['ids'][s]): s for s in np.nonzero(r['mask'])[0]}
                 for r in (jr, tr)]
        for i in slots[0].keys() & slots[1].keys():
            if i in diverging:
                continue
            sj, st = slots[0][i], slots[1][i]
            assert jr['det_col'][sj] == tr['det_col'][st]
            hist = coasted.setdefault(i, [])
            hist.append(jr['det_col'][sj] < 0)
            gap = jr['pos'][sj, :2].astype(np.float64) - tr['pos'][st, :2]
            rows.append((t, i, float(np.hypot(*gap)), sum(hist[-HORIZON:])))
    return rows


def _renumbered(frames, renumberer):
    """Per frame, device id -> TRACK_ID as the readback numbers it."""
    maps = []
    for rec in frames:
        ids = renumberer.observe_batch(
            rec['mask'][None], rec['ids'][None], rec['det_col'][None],
            rec['n_det'][None], np.ones(1, bool))[0]
        maps.append({int(d): int(i) for d, i, m in
                     zip(rec['ids'], ids, rec['mask']) if m})
    return maps


#: px; what one filter step of the two packages may differ by on a track
#: that both match to the same detections in every frame. The steps differ
#: in the last bits of the modes' float32 log weights, which moves the
#: blend of modes that lie pixels apart: by 6e-5 px on the small clips, by
#: up to 2.7e-3 px here, where coordinates pass 1024 px and a match can lie
#: 40 px from the prediction
#: (test_torch_tracker.py::test_gsff_step_residue_by_innovation shows these
#: sizes on one step from one state). A coasting track feeds the step's own
#: prediction back as its measurement, so every coasting frame within the
#: filter's horizon may add as much again (3.2e-2 px after 30 of them).
RESIDUE_TOL = 5e-3
#: frames a filter looks back (the settings' 'maximum horizon size')
HORIZON = 30
#: divergences per 64 frames that nothing upstream explains (each has to be
#: a near-tie within its bound)
MAX_PRIMARY = 2
#: TRACK_ID -> frame of its first divergence on the first 64 frames (XLA:CPU
#: and PyTorch on one x86-64 CPU). One near-tie, the rest downstream of it:
#: track 1837 is matched about 9 px from its filtered position at frame 19
#: (a residue of 3.8e-4 px), coasts to frame 33 (2.8e-3 px by then) and finds
#: detections 1787 and 1783 at 4.556061 and 4.557181 px in one package, at
#: 4.556896 and 4.554646 px in the other; from then on it contests the
#: detections of 1859, 2025 and 1998 with another state in each package.
DIVERGING_64 = {1837: 33, 1859: 35, 2025: 58, 1998: 63}


@pytest.mark.slow
def test_dense_device_tracker_ids_match_jax(dense_runs):
    from ysmr_tpu.pipeline import tracker as jtrk

    n_frames = dense_runs['n_frames']
    (jdf, jframes), (tdf, tframes) = dense_runs['jax'], dense_runs['torch']
    assert len(jframes) == len(tframes) == n_frames
    assert all(f['replay_is_scan'] for f in jframes + tframes)

    # 1. the same detections reach both trackers
    det_diff = [t for t, (a, b) in enumerate(zip(jframes, tframes))
                if not (np.array_equal(a['det_valid'], b['det_valid']) and
                        np.array_equal(a['det_xy'][a['det_valid']],
                                       b['det_xy'][b['det_valid']]))]
    print('\nframes whose detection tables differ: {}'.format(det_diff))

    # 2. every divergence, with its readings
    events = _divergences(jframes, tframes)
    names = [{**a, **b} for a, b in zip(
        _renumbered(tframes, jtrk.ReferenceOrderRenumberer()),
        _renumbered(jframes, jtrk.ReferenceOrderRenumberer()))]
    first = {}
    for ev in events:
        ev['track'] = names[ev['frame']][ev['id']]
        if ev['track'] not in first:
            first[ev['track']] = ev['frame']
            print('frame {} track {} (device id {}): {}{}, margin {} px '
                  'within {} px: {}; {}'.format(
                      ev['frame'], ev['track'], ev['id'], ev['kind'],
                      ' downstream' if ev['downstream'] else '',
                      ev['margin'], ev['bound'], ev['explained'],
                      ev['text']))
    primary = [ev for ev in events if not ev['downstream']]
    diverging = sorted(first)
    residues = _residues(jframes, tframes, {ev['id'] for ev in events})
    late = [r for r in residues if r[2] > RESIDUE_TOL * (1 + r[3])]
    print('tracks matched alike: {} rows, largest residue {:.3e} px without '
          'a coasting frame in the horizon, {:.3e} px with; {} rows past '
          'the bound'.format(
              len(residues), max(r[2] for r in residues if not r[3]),
              max(r[2] for r in residues if r[3]), len(late)))

    # 3. the rows
    both = jdf.merge(tdf, on=KEYS, how='outer', suffixes=('_jax', '_torch'),
                     indicator=True)
    only_jax = both[both['_merge'] == 'left_only']
    only_torch = both[both['_merge'] == 'right_only']
    shared = both[both['_merge'] == 'both']
    shift = np.hypot(shared['POSITION_X_jax'] - shared['POSITION_X_torch'],
                     shared['POSITION_Y_jax'] - shared['POSITION_Y_torch'])
    clean = ~shared['TRACK_ID'].isin(diverging).to_numpy()
    ladder = {tol: (int((shift > tol).sum()), int((shift[clean] > tol).sum()))
              for tol in (1e-4, 2.5e-4, 1e-3, 1e-2, 1e-1, 1.0)}
    report = (
        '{} frames: jax {} rows, {} tracks; torch {} rows, {} tracks; shared '
        'rows {}; only jax {} rows (tracks {}); only torch {} rows (tracks '
        '{}); {} diverging tracks, first at {}, {} of them not downstream of '
        'another; position |diff| on shared rows max {:.3e} px, outside the '
        'diverging tracks {:.3e} px; rows above each tolerance (all, outside '
        'the diverging tracks) {}'.format(
            n_frames, jdf.shape[0], jdf['TRACK_ID'].nunique(), tdf.shape[0],
            tdf['TRACK_ID'].nunique(), shared.shape[0], only_jax.shape[0],
            sorted(only_jax['TRACK_ID'].unique())[:20], only_torch.shape[0],
            sorted(only_torch['TRACK_ID'].unique())[:20], len(diverging),
            first, len(primary),
            float(shift.max()) if len(shift) else 0.0,
            float(shift[clean].max()) if clean.any() else 0.0, ladder))
    print(report)

    assert not det_diff, report
    assert jdf['TRACK_ID'].nunique() == tdf['TRACK_ID'].nunique(), report
    for ev in primary:
        assert ev['explained'], (ev, report)
    assert len(primary) <= MAX_PRIMARY * -(-n_frames // 64), report
    if n_frames == 64:
        assert first == DIVERGING_64, report
    unshared = set(only_jax['TRACK_ID']) | set(only_torch['TRACK_ID'])
    assert unshared <= set(diverging), report
    assert float(shift[clean].max()) <= RESIDUE_TOL * (1 + HORIZON), report
    assert not late, (late[:20], report)
    rows = shared[clean]
    for col in ('WIDTH', 'HEIGHT', 'DEGREES_ANGLE'):
        np.testing.assert_array_equal(rows[col + '_jax'].to_numpy(),
                                      rows[col + '_torch'].to_numpy(),
                                      err_msg=col)
