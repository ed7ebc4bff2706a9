"""The tracker frame step's match-and-register block of the PyTorch port
(ysmr_tpu_torch/ops/frame_step.py: on a CUDA tensor csrc/frame_step.cu)
against ysmr_tpu's jitted frame update, an emulation of the kernel's
design, and the wrapper's routes and refusals.

Tolerance: none. The block is integer and selection logic with one float
comparison (the aged count, rounded to float32, against
``max_disappeared``): ``match_and_register_plain`` fed slot-order
candidates gives every state and emission tensor of ysmr_tpu's
``_tracker_frame_update`` (GSFF off) bit for bit, the emulation and the
kernel give the plain version's. GSFF positions are held to ysmr_tpu by
tests/test_torch_tracker.py within its stated 1e-4 px; here the GSFF
frame update is held to the plain blocks it composes, bit for bit.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from frame_step_cases import KEY_EDGES, NAN_BITS, key_edges
from test_torch_tracker import _random_gsff_state
from ysmr_tpu.ops import gsff as jgsff
from ysmr_tpu.pipeline import tracker as jtrk
from ysmr_tpu_torch.ops import frame_step as fs
from ysmr_tpu_torch.ops import gsff
from ysmr_tpu_torch.ops.assignment import row_min_argmin_plain
from ysmr_tpu_torch.pipeline import tracker as trk

torch.set_num_threads(1)

INT_MAX = 2 ** 31 - 1

#: the seeded states: stale ids in free slots, quantised positions (ties
#: in the row minima), an empty frame, more and fewer detections than
#: tracks, a full table that drops registrations, and two active slots
#: that share an id
CASES = ('stale_ids', 'ties', 'empty', 'more_dets', 'fewer_dets', 'full',
         'shared_id')
#: (V, S, C, K)
SHAPES = ((1, 16, 24, 2), (3, 48, 40, 3), (3, 96, 64, 2), (1, 64, 96, 3))
MAX_DISAPPEARED = 5.0


def _video(rng, case, s, c, k):
    """One video's slot table and frame (numpy, ysmr_tpu's layout)."""
    live = {'full': 0.75, 'fewer_dets': 0.8}.get(case, 0.5)
    active = rng.random(s) < live
    n_obj = int(active.sum())
    next_id = int(rng.integers(3 * s, 5 * s + 2))
    ids = rng.integers(0, next_id, s).astype(np.int32)      # stale if free
    ids[active] = rng.choice(next_id, n_obj, replace=False)
    if case == 'shared_id' and n_obj >= 2:
        on = np.nonzero(active)[0]
        ids[on[1]] = ids[on[0]]
    quant = case == 'ties'
    pos = rng.uniform(0, 60, (s, k))
    pos = np.round(pos / 4) * 4 if quant else pos
    info = rng.uniform(1, 8, (s, 3)).astype(np.float32)
    disappeared = np.where(active, rng.integers(0, 8, s), 0).astype(np.int32)
    n_det = {'more_dets': min(c, n_obj + 1 + s // 4),
             'fewer_dets': max(0, n_obj - 1 - s // 4),
             'full': c, 'empty': 0}.get(case, int(rng.integers(0, c + 1)))
    det_xy = rng.uniform(0, 60, (c, k))
    # half of the detections near a tracked position
    near = rng.random(c) < 0.5
    if n_obj:
        src = pos[rng.choice(np.nonzero(active)[0], c)]
        det_xy = np.where(near[:, None], src + rng.normal(0, 1.5, (c, k)),
                          det_xy)
    det_xy = np.round(det_xy / 4) * 4 if quant else det_xy
    det_valid = np.zeros(c, bool)
    det_valid[rng.choice(c, n_det, replace=False)] = True
    det_info = rng.uniform(1, 8, (c, 3)).astype(np.float32)
    state = {'active': active, 'ids': ids, 'pos': pos.astype(np.float32),
             'info': info, 'disappeared': disappeared,
             'next_id': np.int32(next_id),
             'dropped_registrations': np.int32(rng.integers(0, 4))}
    return state, (det_xy.astype(np.float32), det_info, det_valid)


def _case(case, shape, seed=0):
    """V videos of ``case``: [(state, frame)] as numpy."""
    v, s, c, k = shape
    rng = np.random.default_rng([seed, CASES.index(case), v, s, c, k])
    return [_video(rng, case, s, c, k) for _ in range(v)]


def _torch_inputs(videos, device='cpu'):
    """The stacked state, the frame's (V, C, ...) tables and the
    slot-order candidates on ``device``."""
    def put(arrays):
        return torch.from_numpy(np.ascontiguousarray(np.stack(arrays))).to(
            device)

    state = {key: put([st[key] for st, _ in videos]) for key in fs.STATE_KEYS}
    frame = [put([f[i] for _, f in videos]) for i in range(3)]
    row_min, cand = row_min_argmin_plain(state['pos'].cpu(),
                                         state['active'].cpu(),
                                         frame[0].cpu(), frame[2].cpu())
    return state, frame, row_min.to(device), cand.to(device)


@partial(jax.jit, static_argnames=('max_disappeared',))
def _jax_update(state, det_xy, det_info, det_valid, max_disappeared):
    return jtrk._tracker_frame_update(
        state, det_xy, det_info, det_valid, max_disappeared=max_disappeared,
        use_gsff=False, gsff_gains=None, gsff_n_i=None, gsff_n_f=3,
        gsff_n_i0=10)


def _jax_reference(videos, max_disappeared=MAX_DISAPPEARED):
    """ysmr_tpu's frame update of each video, stacked: (state, emission)
    as numpy."""
    out = [jax.tree.map(np.asarray, _jax_update(
        st, *frame, max_disappeared=max_disappeared))
        for st, frame in videos]
    return tuple({key: np.stack([o[i][key] for o in out]) for key in out[0][i]}
                 for i in range(2))


def _numpy(result):
    """A result's state (without a GSFF sub-state), emission and masks as
    numpy."""
    new_state, emission = result[:2]
    return ({k: x.cpu().numpy() for k, x in new_state.items()
             if torch.is_tensor(x)},
            {k: x.cpu().numpy() for k, x in emission.items()},
            [x.cpu().numpy() for x in result[2:]])


def _assert_same(got, want):
    for part, gpart, wpart in zip(('state', 'emission'), got, want):
        assert set(gpart) == set(wpart), part
        for key in wpart:
            g, w = np.asarray(gpart[key]), np.asarray(wpart[key])
            assert g.dtype == w.dtype, (part, key, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg='{} {}'.format(
                part, key))


@pytest.mark.parametrize('shape', SHAPES, ids=lambda x: 'x'.join(map(str, x)))
@pytest.mark.parametrize('case', CASES)
def test_plain_matches_jax_frame_update(case, shape):
    """``match_and_register_plain`` fed slot-order candidates gives every
    state and emission tensor of ysmr_tpu's jitted frame update (GSFF off)
    on each video of the seeded states."""
    videos = _case(case, shape)
    state, frame, row_min, cand = _torch_inputs(videos)
    got = _numpy(fs.match_and_register_plain(
        state, row_min, cand, *frame, max_disappeared=MAX_DISAPPEARED))
    _assert_same(got, _jax_reference(videos))
    if case == 'full' and shape[2] > shape[1]:
        # more detections than slots: the table drops registrations
        assert (got[0]['dropped_registrations'] >
                state['dropped_registrations'].numpy()).all()
    if case == 'empty':
        assert not got[1]['det_col'].max(initial=-1) >= 0


def test_max_disappeared_is_compared_in_float32():
    """The aged count is rounded to float32 and compared with
    ``max_disappeared`` as a float32, as torch and ysmr_tpu compare a
    float32 tensor with a Python scalar: 2^24 - 1 aged to 2^24 is not
    above 16777215.9 (float32 2^24), though it is in float64."""
    videos = _case('empty', (1, 16, 24, 2))
    st = videos[0][0]
    st['active'][:] = True
    st['disappeared'][:] = 2 ** 24 - 1
    state, frame, row_min, cand = _torch_inputs(videos)
    md = 16777215.9
    got = _numpy(fs.match_and_register_plain(state, row_min, cand, *frame,
                                             max_disappeared=md))
    assert got[0]['active'].all() and (got[0]['disappeared'] == 2 ** 24).all()
    _assert_same(got, _jax_reference(videos, md))
    _assert_same(got[:2], _emulate_kernel(state, row_min, cand, *frame, md))


FREE_KEY = np.uint64(2 ** 64 - 1)

#: the kernel's partition (csrc/frame_step.cu: rank tiles of 64 slots, 8
#: key ranges a cluster, 1024 keys staged, 8 warps; update clusters of up
#: to 8 blocks of up to 512 threads) and small ones whose tiles, stages,
#: warps, blocks and threads split every seeded table, so that counts and
#: prefix sums carry across each boundary; keyed by the staging chunk
PARTITIONS = {
    1024: dict(tile=64, split=8, stage=1024, warps=8, cluster=8,
               threads=512),
    7: dict(tile=6, split=3, stage=7, warps=2, cluster=3, threads=4),
    5: dict(tile=4, split=2, stage=5, warps=3, cluster=5, threads=1),
}


def _sort_keys(row_min, ids, active):
    """The rank launch's uint64 keys: the float32 row minimum mapped to an
    order-preserving uint32 (-0 as +0, every NaN as 0xff800001, above
    +inf) over the id with its sign bit flipped; a free slot all ones."""
    u = np.ascontiguousarray(row_min, np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    m = np.where(u & 0x80000000, ~u, u | np.uint32(0x80000000))
    m = np.where(np.isnan(row_min), np.uint32(0xff800001), m)
    low = np.ascontiguousarray(ids, np.int32).view(np.uint32) ^ \
        np.uint32(0x80000000)
    key = (m.astype(np.uint64) << np.uint64(32)) | low.astype(np.uint64)
    return np.where(active, key, FREE_KEY)


def _share(n, parts, part):
    """[lo, hi) of n items split into ``parts`` parts (csrc's ``share``)."""
    per = -(-n // parts)
    lo = min(n, part * per)
    return lo, min(n, lo + per)


def _emulate_rank(key, tile, split, stage, warps):
    """Launch A: for each tile of slots and each of the cluster's key
    ranges, the staged chunks split between warps; a warp wholly before
    its slots counts keys < key + 1, wholly after keys < key, a diagonal
    one picks per key; the partial counts summed."""
    s = len(key)
    with np.errstate(over='ignore'):
        le = key + np.uint64(1)     # a free slot's wraps to 0: counts none
    rank = np.zeros(s, np.int64)
    for t0 in range(0, s, tile):
        mine = np.arange(t0, min(s, t0 + tile))
        for part in range(split):
            jlo, jhi = _share(s, split, part)
            for j0 in range(jlo, jhi, stage):
                n = min(stage, jhi - j0)
                per_warp = -(-n // warps)
                for w in range(warps):
                    qa = min(n, w * per_warp)
                    qb = min(n, qa + per_warp)
                    j = np.arange(j0 + qa, j0 + qb)
                    kj = key[j][None, :]
                    if j0 + qb <= t0:
                        hit = kj < le[mine][:, None]
                    elif j0 + qa >= t0 + tile:
                        hit = kj < key[mine][:, None]
                    else:
                        thr = np.where(j[None, :] < mine[:, None],
                                       le[mine][:, None], key[mine][:, None])
                        hit = kj < thr
                    rank[mine] += hit.sum(1)
    return rank


def _runs(lo, hi, threads):
    """Each thread's contiguous run of the block's items [lo, hi)."""
    return [tuple(lo + x for x in _share(hi - lo, threads, t))
            for t in range(threads)]


def _wrap(x):
    """int32 wraparound of an integer array."""
    return np.asarray(x, np.int64).astype(np.uint32).astype(np.int32)


def _emulate_kernel(state, row_min, cand, det_xy, det_info, det_valid,
                    max_disappeared, chunk=1024):
    """csrc/frame_step.cu's design per video, with the partition
    ``PARTITIONS[chunk]``: the ranks from the packed keys counted tile by
    tile (``_emulate_rank``); then the update cluster's blocks, each an
    equal share of the slots and columns, a thread a contiguous run of
    each: the counts added over the blocks, each column's winner the
    smallest claiming rank, the registrations' and free slots' offsets as
    the blocks' and threads' totals before them plus a running count,
    and the writes of the last phase. Returns (new_state, emission) as
    numpy."""
    part = PARTITIONS[chunk]
    st = {k: x.numpy() for k, x in state.items()}
    rm, cd = row_min.numpy(), cand.numpy()
    dxy, dinf, dv = det_xy.numpy(), det_info.numpy(), det_valid.numpy()
    v, s = st['active'].shape
    c = dv.shape[1]
    md = np.float32(max_disappeared)
    new = {k: np.array(x, copy=True) for k, x in st.items()}
    em = {'mask': np.zeros((v, s), bool), 'ids': np.zeros((v, s), np.int32),
          'pos': np.zeros_like(st['pos']), 'info': np.zeros_like(st['info']),
          'det_col': np.zeros((v, s), np.int32),
          'n_det': np.zeros(v, np.int32)}
    # the cluster and its block size as the launch picks them (or fixed)
    most = max(s, c)
    if chunk == 1024:
        cb = min(part['cluster'], max(1, -(-most // part['threads'])))
        nt = min(part['threads'], max(32, -(-(-(-most // cb)) // 32) * 32))
    else:
        cb, nt = part['cluster'], part['threads']
    for vi in range(v):
        act, ids = st['active'][vi], st['ids'][vi]
        rank = _emulate_rank(_sort_keys(rm[vi], ids, act), part['tile'],
                             part['split'], part['stage'], part['warps'])
        valid, col = dv[vi], cd[vi]
        blocks = [(_share(s, cb, b), _share(c, cb, b)) for b in range(cb)]
        # 1.-2. the counts over the blocks; the claims
        n_obj = sum(int(act[lo:hi].sum()) for (lo, hi), _ in blocks)
        n_det = sum(int(valid[lo:hi].sum()) for _, (lo, hi) in blocks)
        claim = act & (col >= 0) & (col < c) & valid[np.clip(col, 0, c - 1)]
        winner = np.full(c, INT_MAX, np.int64)
        for i in np.nonzero(claim)[0]:
            winner[col[i]] = min(winner[col[i]], rank[i])
        has_det = n_det > 0
        do_reg = has_det and n_det > n_obj
        matched = claim & (winner[np.clip(col, 0, c - 1)] == rank)
        age = (act & ~matched & (n_obj >= n_det)) if has_det else act
        dis = np.where(matched, 0, st['disappeared'][vi])
        dis = np.where(age, _wrap(dis.astype(np.int64) + 1), dis)
        alive = act & ~(age & (dis.astype(np.float32) > md))
        flag = valid & (winner == INT_MAX) & do_reg
        # 3.-4. the blocks' and threads' totals before each run
        n_new = int(flag.sum())
        col_of_rank = np.full(c, -7, np.int64)
        free_rank = np.zeros(s, np.int64)
        at_new = at_free = 0
        for (slo, shi), (clo, chi) in blocks:
            for (ilo, ihi), (jlo, jhi) in zip(_runs(slo, shi, nt),
                                              _runs(clo, chi, nt)):
                for j in range(jlo, jhi):
                    if flag[j]:
                        col_of_rank[at_new] = j
                        at_new += 1
                for i in range(ilo, ihi):
                    free_rank[i] = at_free
                    at_free += not alive[i]
        n_free = at_free
        assert at_new == n_new
        # 5. the writes
        reg = ~alive & (free_rank < n_new)
        reg_col = np.where(reg, col_of_rank[np.clip(free_rank, 0, c - 1)],
                           -1)
        on = alive | reg
        new_ids = np.where(reg, _wrap(st['next_id'][vi] + free_rank), ids)
        src = np.where(reg, reg_col, np.where(matched, col, -1))
        pos = np.where(src[:, None] >= 0, dxy[vi][np.clip(src, 0, c - 1)],
                       st['pos'][vi])
        info = np.where(src[:, None] >= 0, dinf[vi][np.clip(src, 0, c - 1)],
                        st['info'][vi])
        info = np.where((~reg & age)[:, None], np.float32(0), info)
        new['active'][vi] = on
        new['ids'][vi] = new_ids
        new['pos'][vi] = pos
        new['info'][vi] = info
        new['disappeared'][vi] = np.where(reg, 0, dis)
        new['next_id'][vi] = _wrap(st['next_id'][vi] + n_new)
        new['dropped_registrations'][vi] = _wrap(
            st['dropped_registrations'][vi] + n_new - min(n_new, n_free))
        em['mask'][vi] = on
        em['ids'][vi] = np.where(on, new_ids, 0)
        em['pos'][vi] = pos
        em['info'][vi] = info
        em['det_col'][vi] = np.where(matched, col, reg_col)
        em['n_det'][vi] = n_det
    return new, em


@pytest.mark.parametrize('chunk', [1024, 7, 5])
@pytest.mark.parametrize('shape', SHAPES, ids=lambda x: 'x'.join(map(str, x)))
@pytest.mark.parametrize('case', CASES)
def test_kernel_design_matches_plain(case, shape, chunk):
    """The kernel's design, emulated on the CPU (ranks counted over the
    packed keys tile by tile, the columns' smallest claiming rank, the
    cluster's counts and prefix sums over blocks and threads' runs), gives
    the plain version's bits: at the kernel's partition and, so that
    counts and sums carry across tiles, stages, warps, blocks and
    threads, at two small ones."""
    state, frame, row_min, cand = _torch_inputs(_case(case, shape, seed=1))
    want = _numpy(fs.match_and_register_plain(
        state, row_min, cand, *frame, max_disappeared=MAX_DISAPPEARED))
    got = _emulate_kernel(state, row_min, cand, *frame, MAX_DISAPPEARED,
                          chunk)
    _assert_same(got, want[:2])


def test_kernel_design_orders_nan_row_minima_last():
    """A NaN row minimum ranks after every number (the stable sort's
    order), and the emulation still gives the plain version's bits."""
    state, frame, row_min, cand = _torch_inputs(_case('ties', (1, 48, 40, 2)))
    on = torch.nonzero(state['active'][0]).flatten()
    row_min[0, on[::3]] = float('nan')
    want = _numpy(fs.match_and_register_plain(
        state, row_min, cand, *frame, max_disappeared=MAX_DISAPPEARED))
    _assert_same(_emulate_kernel(state, row_min, cand, *frame,
                                 MAX_DISAPPEARED), want[:2])


@pytest.mark.parametrize('chunk', [1024, 7, 5])
@pytest.mark.parametrize('edge', KEY_EDGES)
def test_kernel_design_key_edges(edge, chunk):
    """The packed keys at their edges (signed zeros, NaN payloads, the
    int32 limits of the ids, keys equal but for the slot) rank as the
    plain version's stable sorts order them: the emulation gives its
    bits."""
    state, frame, row_min, cand = _torch_inputs(_case('more_dets',
                                                      (1, 96, 64, 2), seed=3))
    key_edges(edge, state, row_min, cand)
    want = _numpy(fs.match_and_register_plain(
        state, row_min, cand, *frame, max_disappeared=MAX_DISAPPEARED))
    _assert_same(_emulate_kernel(state, row_min, cand, *frame,
                                 MAX_DISAPPEARED, chunk), want[:2])


def test_sort_keys_order():
    """The packed keys' unsigned order is the (row minimum, id) order of
    the stable sorts: numbers ascending with -0 equal to +0, every NaN one
    key after +inf, ids signed; a free slot's key above every live one
    and its + 1 wrapping to 0."""
    f = np.array([-np.inf, -1.5, -0.0, 0.0, 1e-45, 2.0, np.inf], np.float32)
    nan = np.array(NAN_BITS, np.uint32).view(np.float32)
    ids = np.zeros(len(f), np.int32)
    keys = _sort_keys(f, ids, np.ones(len(f), bool))
    assert (np.diff(keys.astype(np.float64)) >= 0).all()
    assert keys[2] == keys[3] and (np.diff(keys[3:]) > 0).all()
    nk = _sort_keys(nan, np.zeros(4, np.int32), np.ones(4, bool))
    assert (nk == nk[0]).all() and nk[0] > keys[-1]
    assert nk[0] >> np.uint64(32) == 0xff800001
    lim = _sort_keys(np.zeros(3, np.float32),
                     np.array([-2 ** 31, 0, INT_MAX], np.int32),
                     np.ones(3, bool))
    assert lim[0] < lim[1] < lim[2] < nk[0] < FREE_KEY
    assert _sort_keys(np.zeros(1, np.float32), np.zeros(1, np.int32),
                      np.zeros(1, bool))[0] == FREE_KEY


def test_wrapper_takes_the_plain_route_on_the_cpu():
    """A CPU call is the plain version's, launches nothing and leaves its
    inputs as they were."""
    state, frame, row_min, cand = _torch_inputs(_case('stale_ids',
                                                      (3, 48, 40, 3)))
    before = {k: x.clone() for k, x in state.items()}
    fs.match_and_register.launches = 0
    want = fs.match_and_register_plain(state, row_min, cand, *frame,
                                       max_disappeared=MAX_DISAPPEARED)
    got = fs.match_and_register(state, row_min, cand, *frame,
                                max_disappeared=MAX_DISAPPEARED)
    assert fs.match_and_register.launches == 0
    _assert_same(_numpy(got), _numpy(want))
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a.cpu(), b.cpu())
    for k, x in before.items():
        assert torch.equal(state[k], x)


def _broken(case, state, frame, row_min, cand):
    state = dict(state)
    det_xy, det_info, det_valid = frame
    if case == 'pos_float64':
        state['pos'] = state['pos'].double()
    elif case == 'ids_int64':
        state['ids'] = state['ids'].long()
    elif case == 'next_id_scalar':
        state['next_id'] = state['next_id'][0]
    elif case == 'cand_rows':
        cand = cand[:, 1:]
    elif case == 'row_min_int':
        row_min = row_min.to(torch.int32)
    elif case == 'det_xy_k':
        det_xy = det_xy[..., :2]
    elif case == 'det_valid_uint8':
        det_valid = det_valid.to(torch.uint8)
    elif case == 'no_video_axis':
        state = {k: x[0] for k, x in state.items()}
        det_xy, det_info, det_valid = det_xy[0], det_info[0], det_valid[0]
        row_min, cand = row_min[0], cand[0]
    elif case == 'no_columns':
        det_xy, det_info, det_valid = (x[:, :0] for x in frame)
    elif case == 'meta':
        state = {k: x.to('meta') for k, x in state.items()}
        det_xy, det_info, det_valid, row_min, cand = (
            x.to('meta') for x in (det_xy, det_info, det_valid, row_min,
                                   cand))
    elif case == 'mixed_devices':
        row_min = row_min.to('meta')
    return state, (det_xy, det_info, det_valid), row_min, cand


@pytest.mark.parametrize('case', [
    'pos_float64', 'ids_int64', 'next_id_scalar', 'cand_rows', 'row_min_int',
    'det_xy_k', 'det_valid_uint8', 'no_video_axis', 'no_columns', 'meta',
    'mixed_devices'])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """A wrong shape, type or device raises, on the CPU too; so do a frame
    without detection columns (the plain version cannot clamp into them)
    and a device that is neither the CPU nor CUDA."""
    args = _broken(case, *_torch_inputs(_case('stale_ids', (3, 48, 40, 3))))
    state, frame, row_min, cand = args
    with pytest.raises(ValueError):
        fs.match_and_register(state, row_min, cand, *frame,
                              max_disappeared=MAX_DISAPPEARED)


def _gsff_setup(videos):
    """The GSFF bank, its keyword arguments and a random mid-run filter
    state of the videos' slots (flattened, as in the scan)."""
    jp = jgsff.GSFFParams(fps=30.0)
    params = gsff.GSFFParams(fps=30.0)
    v, s = len(videos), videos[0][0]['active'].shape[0]
    st = _random_gsff_state(np.random.default_rng(5), v * s, jp, width=60)
    st['pred_lo'] = (np.random.default_rng(6).uniform(-1, 1, (v * s, 2)) *
                     1e-6).astype(np.float32)
    gstate = {k: torch.from_numpy(np.array(x)) for k, x in st.items()}
    return params, gstate, trk.gsff_kwargs(params, 'cpu')


@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('use_gsff', [False, True])
def test_frame_update_composes_the_plain_blocks(use_gsff, k):
    """The tracker's frame update on the CPU is the slot-order candidates,
    ``match_and_register_plain`` and, with GSFF, ``register_and_step``
    and the former merge (``where(live, cat([corrected, pos[..., 2:]]),
    pos)`` emitted, the prediction stored), bit for bit."""
    videos = _case('more_dets', (3, 48, 40, k))
    state, frame, row_min, cand = _torch_inputs(videos)
    kwargs = dict(max_disappeared=MAX_DISAPPEARED, use_gsff=use_gsff,
                  gsff_gains=None, gsff_n_i=None, gsff_n_f=3, gsff_n_i0=10)
    want_state, want_em, _, reg, coast = fs.match_and_register_plain(
        state, row_min, cand, *frame, max_disappeared=MAX_DISAPPEARED)
    if use_gsff:
        _, gstate, gkw = _gsff_setup(videos)
        kwargs.update(gkw)
        state = dict(state, gsff=gstate)
        pos = want_state['pos']
        live = want_state['active']
        g, corr, pred = gsff.register_and_step_plain(
            gkw['gsff_gains'], gkw['gsff_n_i'], gkw['gsff_n_f'],
            gkw['gsff_n_i0'], gstate, pos[..., :2].flatten(0, 1), live.flatten(),
            reg.flatten(), coast.flatten())
        on = live[..., None]
        want_em = dict(want_em, pos=torch.where(
            on, torch.cat([corr.view(3, -1, 2), pos[..., 2:]], 2), pos))
        want_state = dict(want_state, pos=torch.where(
            on, torch.cat([pred.view(3, -1, 2), pos[..., 2:]], 2), pos),
            gsff=g)
    got_state, got_em = trk._tracker_frame_update(
        state, *frame, out=fs.allocate(state, 40), frame=0, **kwargs)
    _assert_same(_numpy((got_state, got_em)),
                 _numpy((want_state, want_em)))
    if use_gsff:
        for key in gsff.STATE_KEYS:
            assert torch.equal(got_state['gsff'][key], want_state['gsff'][key])


def _gsff_step_case(v, k, device='cpu', seed=8):
    """The scan's GSFF entry's arguments at V videos of 40 slots and K
    coordinates: a random mid-run filter state, the new state's (V S, K)
    positions, matched, coasting, newly registered and free slots, and a
    (V, 4, S, K) emission buffer whose frame 2 the step writes."""
    rng = np.random.default_rng(seed)
    s = 40
    jp = jgsff.GSFFParams(fps=30.0)
    st = _random_gsff_state(rng, v * s, jp, width=60)
    st['pred_lo'] = (rng.uniform(-1, 1, (v * s, 2)) * 1e-6).astype(
        np.float32)
    kind = rng.integers(0, 4, v * s)   # matched, coasting, registered, free
    masks = [kind != 3, kind == 2, kind == 1]
    pos = rng.uniform(0, 60, (v, s, k)).astype(np.float32)
    buf = rng.normal(size=(v, 4, s, k)).astype(np.float32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    gkw = trk.gsff_kwargs(gsff.GSFFParams(fps=30.0), device)
    return (gkw, {key: put(x) for key, x in st.items()}, put(pos),
            [put(m) for m in masks], put(buf))


def _gsff_step_reference(gkw, gstate, pos, masks, buf):
    """What the tracker's step wrote before the fold: the plain GSFF step
    on the positions' first two columns, then ``where(live, ...)`` of the
    corrected positions over the emitted ones (frame 2 of ``buf``) and of
    the predicted ones over the new state's."""
    v, s, _ = pos.shape
    got, corr, pred = gsff.register_and_step_plain(
        gkw['gsff_gains'], gkw['gsff_n_i'], gkw['gsff_n_f'],
        gkw['gsff_n_i0'], gstate, pos.flatten(0, 1)[:, :2], *masks)
    on = masks[0].view(v, s, 1)
    want_pos, want_buf = pos.clone(), buf.clone()
    want_pos[..., :2] = torch.where(on, pred.view(v, s, 2), pos[..., :2])
    want_buf[:, 2, :, :2] = torch.where(on, corr.view(v, s, 2),
                                        buf[:, 2, :, :2])
    return got, corr, pred, want_pos, want_buf


def _check_gsff_destinations(v, k, device):
    on_card = torch.device(device).type == 'cuda'
    gkw, gstate, pos, masks, buf = _gsff_step_case(v, k, device)
    got_st, corr, pred, want_pos, want_buf = _gsff_step_reference(
        gkw, gstate, pos, masks, buf)
    live = masks[0]
    assert live.any() and masks[1].any() and masks[2].any()
    assert (~live).any()
    n = gsff.register_and_step.launches
    new_state, got_corr, got_pred = gsff._register_and_step(
        gkw['gsff_gains'], gkw['gsff_n_i'], gkw['gsff_n_f'],
        gkw['gsff_n_i0'], gstate, pos.view(v * pos.shape[1], k), *masks,
        out=gsff.allocate(gstate), frame=0, emit_pos=buf[:, 2])
    if on_card:
        torch.cuda.synchronize()
    assert gsff.register_and_step.launches == n + on_card
    assert torch.equal(pos, want_pos)
    assert torch.equal(buf, want_buf)
    assert torch.equal(got_corr, corr) and torch.equal(got_pred, pred)
    for key in gsff.STATE_KEYS:
        assert torch.equal(new_state[key], got_st[key]), key


@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('v', [1, 4])
def test_gsff_step_writes_the_live_positions(v, k):
    """The scan's GSFF entry with the frame's emitted positions writes
    what the tracker's former merge wrote: on the live slots (matched,
    coasting and newly registered) the corrected position over the first
    two emitted coordinates and the prediction over the new state's, the
    free slots and the other coordinates and frames untouched; its state
    and (N, 2) outputs are the plain step's."""
    _check_gsff_destinations(v, k, 'cpu')


def test_gsff_step_without_destinations_leaves_the_positions():
    """The public ``register_and_step`` returns new (N, 2) corrected and
    predicted positions and writes none of its inputs, and the scan's
    entry without ``emit_pos`` leaves the positions it reads as they
    are."""
    gkw, gstate, pos, masks, _ = _gsff_step_case(4, 3, seed=9)
    bank = (gkw['gsff_gains'], gkw['gsff_n_i'], gkw['gsff_n_f'],
            gkw['gsff_n_i0'])
    m = pos.flatten(0, 1)[:, :2].contiguous()
    before = [m.clone()] + [x.clone() for x in gstate.values()]
    got, corr, pred = gsff.register_and_step(*bank, gstate, m, *masks)
    want, wcorr, wpred = gsff.register_and_step_plain(*bank, gstate, m,
                                                      *masks)
    assert corr.shape == pred.shape == (m.shape[0], 2)
    assert torch.equal(corr, wcorr) and torch.equal(pred, wpred)
    for key in gsff.STATE_KEYS:
        assert torch.equal(got[key], want[key])
    after = [m] + list(gstate.values())
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    flat = pos.flatten(0, 1)
    old = flat.clone()
    _, corr2, pred2 = gsff._register_and_step(
        *bank, gstate, flat, *masks, out=gsff.allocate(gstate), frame=0)
    assert torch.equal(flat, old)
    assert torch.equal(corr2, wcorr) and torch.equal(pred2, wpred)


def test_scan_checks_once_and_returns_fresh_buffers(monkeypatch):
    """``run_tracker_scan`` checks its tables once per call, writes one
    allocation of emissions, and returns a state that aliases neither the
    caller's state nor another call's."""
    videos = _case('more_dets', (3, 48, 40, 2))
    state, _, _, _ = _torch_inputs(videos)
    rng = np.random.default_rng(9)
    tables = (torch.from_numpy(rng.uniform(0, 60, (3, 5, 40, 2)).astype(
        np.float32)), torch.from_numpy(rng.uniform(1, 8, (3, 5, 40, 3)).astype(
            np.float32)), torch.from_numpy(rng.random((3, 5, 40)) < 0.7))
    calls = []
    check = fs.check
    monkeypatch.setattr(fs, 'check', lambda *a, **kw: calls.append(1) or
                        check(*a, **kw))
    frames = []
    block = fs._match_and_register
    monkeypatch.setattr(fs, '_match_and_register', lambda *a, **kw:
                        frames.append((kw['out'], kw['frame'])) or
                        block(*a, **kw))
    kwargs = dict(max_disappeared=MAX_DISAPPEARED)
    new, em = trk.run_tracker_scan(state, *tables, **kwargs)
    assert len(calls) == 1
    # one allocation for the call; the frames' states alternate between
    # two buffers, the last of which is returned
    out = frames[0][0]
    assert [f for _, f in frames] == list(range(5))
    assert all(o is out for o, _ in frames) and len(out['states']) == 2
    for key in fs.STATE_KEYS:
        assert new[key].data_ptr() == out['states'][4 % 2][key].data_ptr()
    again, _ = trk.run_tracker_scan(state, *tables, **kwargs)
    ptrs = {x.data_ptr() for x in state.values()}
    for key in fs.STATE_KEYS:
        assert new[key].data_ptr() not in ptrs
        assert again[key].data_ptr() != new[key].data_ptr()
        assert torch.equal(again[key], new[key])
    base = em['mask'].untyped_storage().data_ptr()
    assert em['mask'].shape == (3, 5, 48) and em['n_det'].shape == (3, 5)
    assert em['mask'].data_ptr() == base
    # the frames one at a time through the plain block
    st = state
    for t in range(5):
        row_min, cand = row_min_argmin_plain(st['pos'], st['active'],
                                             tables[0][:, t],
                                             tables[2][:, t])
        st, one = fs.match_and_register_plain(
            st, row_min, cand, *(x[:, t] for x in tables),
            max_disappeared=MAX_DISAPPEARED)[:2]
        for key in fs.EMISSION_KEYS:
            assert torch.equal(em[key][:, t], one[key]), (t, key)
    for key in fs.STATE_KEYS:
        assert torch.equal(new[key], st[key])


def test_scan_checks_gsff_once_and_returns_fresh_buffers(monkeypatch):
    """With GSFF the scan checks the filter's tables once per call (with
    the block's), writes every frame's GSFF step into one allocation (two
    alternating states, the corrected and predicted positions) through
    the private entry, reading the measurement from the (V S, K) positions
    at stride K, and returns a GSFF state that aliases neither the
    caller's nor another call's; frame by frame it equals the public
    entries' steps (``match_and_register_plain``, ``register_and_step``
    on a contiguous copy of the measurement, the former merge's
    ``where``)."""
    v, s, c, k, t_len = 3, 48, 40, 3, 5
    videos = _case('more_dets', (v, s, c, k))
    state, _, _, _ = _torch_inputs(videos)
    _, gstate, gkw = _gsff_setup(videos)
    state = dict(state, gsff={key: x.unflatten(0, (v, s))
                              for key, x in gstate.items()})
    rng = np.random.default_rng(10)
    tables = (torch.from_numpy(rng.uniform(0, 60, (v, t_len, c, k)).astype(
        np.float32)), torch.from_numpy(rng.uniform(
            1, 8, (v, t_len, c, 3)).astype(np.float32)),
        torch.from_numpy(rng.random((v, t_len, c)) < 0.7))
    checks, frames = [], []
    check = gsff.check
    monkeypatch.setattr(gsff, 'check', lambda *a, **kw: checks.append(1) or
                        check(*a, **kw))
    step = gsff._register_and_step
    monkeypatch.setattr(gsff, '_register_and_step', lambda *a, **kw:
                        frames.append((a[5], kw['out'], kw['frame'])) or
                        step(*a, **kw))
    kwargs = dict(max_disappeared=MAX_DISAPPEARED, use_gsff=True, **gkw)
    new, em = trk.run_tracker_scan(state, *tables, **kwargs)
    assert len(checks) == 1
    out = frames[0][1]
    assert [f for _, _, f in frames] == list(range(t_len))
    assert all(o is out for _, o, _ in frames) and len(out['states']) == 2
    # the measurement: the new state's positions, all K of them
    assert all(pos.shape == (v * s, k) for pos, _, _ in frames)
    for key in gsff.STATE_KEYS:
        assert new['gsff'][key].data_ptr() == \
            out['states'][(t_len - 1) % 2][key].data_ptr()
    again, _ = trk.run_tracker_scan(state, *tables, **kwargs)
    ptrs = {x.data_ptr() for x in state['gsff'].values()}
    for key in gsff.STATE_KEYS:
        assert new['gsff'][key].data_ptr() not in ptrs
        assert again['gsff'][key].data_ptr() != new['gsff'][key].data_ptr()
        assert torch.equal(again['gsff'][key], new['gsff'][key])
    # the frames one at a time through the public entries
    st = dict(state, gsff=gstate)
    for t in range(t_len):
        frame = [x[:, t] for x in tables]
        row_min, cand = row_min_argmin_plain(st['pos'], st['active'],
                                             frame[0], frame[2])
        nxt, one, _, reg, coast = fs.match_and_register_plain(
            st, row_min, cand, *frame, max_disappeared=MAX_DISAPPEARED)
        pos, live = nxt['pos'], nxt['active']
        g, corr, pred = gsff.register_and_step(
            gkw['gsff_gains'], gkw['gsff_n_i'], gkw['gsff_n_f'],
            gkw['gsff_n_i0'], st['gsff'],
            pos[..., :2].flatten(0, 1).contiguous(), live.flatten(),
            reg.flatten(), coast.flatten())
        on = live[..., None]
        one = dict(one, pos=torch.where(
            on, torch.cat([corr.view(v, s, 2), pos[..., 2:]], 2), pos))
        st = dict(nxt, pos=torch.where(
            on, torch.cat([pred.view(v, s, 2), pos[..., 2:]], 2), pos),
            gsff=g)
        for key in fs.EMISSION_KEYS:
            assert torch.equal(em[key][:, t], one[key]), (t, key)
    for key in fs.STATE_KEYS:
        assert torch.equal(new[key], st[key])
    for key in gsff.STATE_KEYS:
        assert torch.equal(new['gsff'][key].flatten(0, 1), st['gsff'][key])


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


def _kernel_against_plain(state, frame, row_min, cand,
                          max_disappeared=MAX_DISAPPEARED, plain_on=None):
    """The kernel against the plain version on the same tensors (with
    ``plain_on``, the plain version on copies on that device)."""
    before = {k: x.clone() for k, x in state.items()}
    n = fs.match_and_register.launches
    got = fs.match_and_register(state, row_min, cand, *frame,
                                max_disappeared=max_disappeared)
    if plain_on is None:
        want = fs.match_and_register_plain(state, row_min, cand, *frame,
                                           max_disappeared=max_disappeared)
    else:
        want = fs.match_and_register_plain(
            {k: x.to(plain_on) for k, x in state.items()},
            row_min.to(plain_on), cand.to(plain_on),
            *(x.to(plain_on) for x in frame),
            max_disappeared=max_disappeared)
    torch.cuda.synchronize()
    assert fs.match_and_register.launches == n + 1
    _assert_same(_numpy(got), _numpy(want))
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a.cpu(), b.cpu())
    for k, x in before.items():
        assert torch.equal(state[k], x)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', SHAPES, ids=lambda x: 'x'.join(map(str, x)))
@pytest.mark.parametrize('case', CASES)
def test_kernel_bit_equal_to_plain_on_cuda(case, shape):
    """The kernel against the plain version on the card, on the cases of
    the CPU tests: every output bit-equal, one call counted, the inputs
    untouched. Runs on a machine with an NVIDIA GPU (see README)."""
    dev = _cuda()
    _kernel_against_plain(*_torch_inputs(_case(case, shape), dev))


@pytest.mark.cuda
def test_kernel_edges_on_cuda():
    """NaN row minima, the float32 comparison of ``max_disappeared``, and
    a table of no slots, on the card."""
    dev = _cuda()
    state, frame, row_min, cand = _torch_inputs(_case('ties', (1, 48, 40, 2)),
                                                dev)
    on = torch.nonzero(state['active'][0]).flatten()
    row_min[0, on[::3]] = float('nan')
    _kernel_against_plain(state, frame, row_min, cand)
    videos = _case('empty', (1, 16, 24, 2))
    videos[0][0]['active'][:] = True
    videos[0][0]['disappeared'][:] = 2 ** 24 - 1
    _kernel_against_plain(*_torch_inputs(videos, dev),
                          max_disappeared=16777215.9)
    _kernel_against_plain(*_torch_inputs(_case('more_dets', (3, 0, 40, 2)),
                                         dev))


@pytest.mark.cuda
@pytest.mark.parametrize('edge', KEY_EDGES)
def test_kernel_key_edges_on_cuda(edge):
    """The packed keys' edges (``frame_step_cases.key_edges``) on the
    card, and shapes that split the rank tiles and the update cluster
    unevenly: bit-equal to the plain version. NaN payloads against the
    plain version on the CPU: torch's CUDA stable sort orders NaNs by
    their bits (a negative NaN first), its CPU sort, ysmr_tpu's and the
    kernel's put every NaN after +inf, equal."""
    dev = _cuda()
    state, frame, row_min, cand = _torch_inputs(
        _case('more_dets', (1, 96, 64, 2), seed=3), dev)
    key_edges(edge, state, row_min, cand)
    _kernel_against_plain(state, frame, row_min, cand, plain_on='cpu'
                          if edge == 'nan_payloads' else None)
    for shape in ((2, 4095, 4097, 2), (1, 1, 1, 3), (4, 1500, 1700, 3)):
        _kernel_against_plain(*_torch_inputs(_case('stale_ids', shape), dev))


@pytest.mark.cuda
def test_kernel_at_the_dense_size_on_cuda():
    """S = C = 4096 with 3000 live tracks and 3000 detections near them,
    V = 1 and 3. Runs on a machine with an NVIDIA GPU (see README)."""
    dev = _cuda()
    rng = np.random.default_rng(12)
    for v in (1, 3):
        videos = []
        for _ in range(v):
            st, (det_xy, det_info, det_valid) = _video(rng, 'stale_ids', 4096,
                                                       4096, 2)
            st['active'][:] = False
            st['active'][rng.choice(4096, 3000, replace=False)] = True
            st['ids'][st['active']] = rng.choice(20000, 3000, replace=False)
            st['pos'] = rng.uniform(0, 1228, (4096, 2)).astype(np.float32)
            det_xy = (st['pos'][rng.permutation(4096)] + rng.normal(
                0, 1, (4096, 2))).astype(np.float32)
            det_valid[:] = False
            det_valid[:3000] = True
            videos.append((st, (det_xy, det_info, det_valid)))
        _kernel_against_plain(*_torch_inputs(videos, dev))


@pytest.mark.cuda
@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('use_gsff', [False, True])
def test_frame_update_on_cuda_equals_plain(use_gsff, k):
    """The tracker's frame update on the card (assign, frame-step and
    GSFF kernels, the last writing the live positions) against the same
    update with the plain blocks on the card, bit for bit."""
    dev = _cuda()
    videos = _case('more_dets', (3, 48, 40, k))
    state, frame, _, _ = _torch_inputs(videos, dev)
    kwargs = dict(max_disappeared=MAX_DISAPPEARED, use_gsff=use_gsff,
                  gsff_gains=None, gsff_n_i=None, gsff_n_f=3, gsff_n_i0=10)
    if use_gsff:
        _, gstate, gkw = _gsff_setup(videos)
        kwargs.update({k: x.to(dev) if torch.is_tensor(x) else x
                       for k, x in gkw.items()})
        state = dict(state, gsff={k: x.to(dev) for k, x in gstate.items()})
    kwargs.update(frame=0)
    n = fs.match_and_register.launches, gsff.register_and_step.launches
    got = trk._tracker_frame_update(state, *frame, out=fs.allocate(state, 40),
                                    **kwargs)
    assert (fs.match_and_register.launches,
            gsff.register_and_step.launches) == (n[0] + 1, n[1] + use_gsff)
    plain = fs._match_and_register, gsff._register_and_step

    def plain_block(st, row_min, cand, *tables, max_disappeared, out, frame):
        return fs.write_plain(out, frame, fs.match_and_register_plain(
            st, row_min, cand, *tables, max_disappeared=max_disappeared))

    try:
        fs._match_and_register = plain_block
        gsff._register_and_step = gsff._register_and_step_plain
        want = trk._tracker_frame_update(
            state, *frame, out=fs.allocate(state, 40), **kwargs)
    finally:
        fs._match_and_register, gsff._register_and_step = plain
    torch.cuda.synchronize()
    _assert_same(_numpy(got), _numpy(want))


@pytest.mark.cuda
@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('v', [1, 4])
def test_gsff_step_writes_the_live_positions_on_cuda(v, k):
    """The GSFF kernel with the frame's emitted positions: one launch
    writes the live slots' corrected and predicted positions where the
    former merge did, bit-equal to the plain step and ``where``."""
    _check_gsff_destinations(v, k, _cuda())
