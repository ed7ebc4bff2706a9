"""The sparse table CC of ``use table cc`` in the PyTorch port against the
JAX package, bit for bit: ``ops/labeling.py``'s ``label_components_table``
and ``compact_labels_table`` on tables whose valid entries are a raster
prefix, shuffled, or spread among invalid slots, with both
connectivities and where the iteration cap binds (a long staircase);
``ops/cc.py::cc_labels_table`` (its plain version is ``ysmr_tpu``'s table
route of the pixel-table branch) and the design of its kernel
(``csrc/table_cc.cu``) emulated in numpy; ``detect_from_pixels(use_table=
True)`` on every branch and wire; and ``track_bacteria`` with ``use table
cc = True`` on the synthetic clips, ``_list.csv`` byte-identical to
``ysmr_tpu``'s with the same setting. The kernel itself runs on the card
only (``-m cuda``)."""

import numpy as np
import pytest
import torch

import jax
import table_cc_cases as tcc_cases
from test_torch_detect_pixels import KW, _wire_args, _wires
from test_torch_track_bacteria import FRAMES, _run_both
from ysmr_tpu.ops import labeling as jlb
from ysmr_tpu.pipeline.detect_pixels import detect_from_pixels as jdetect
from ysmr_tpu.pipeline.track_bacteria import track_bacteria as jtrack
from ysmr_tpu_torch import track_bacteria
from ysmr_tpu_torch.ops import cc
from ysmr_tpu_torch.ops import labeling as lb
from ysmr_tpu_torch.pipeline.detect_pixels import detect_from_pixels

torch.set_num_threads(1)

BIG = 1 << 30
LAYOUTS = ('prefix', 'shuffled', 'gapped')


def _tables(rng, t, f, h, w, layout, density=0.3, marker_rate=0.05):
    """(T, F) int32 lin, bool valid and marker: random masks' pixels as a
    raster prefix, at random slots in random order (``shuffled``) or in
    raster order among invalid slots (``gapped``); the invalid slots hold
    random lins, some of them in the frame."""
    lin = rng.integers(-3, h * w + 5, (t, f)).astype(np.int32)
    valid = np.zeros((t, f), bool)
    for i in range(t):
        ys, xs = np.nonzero(rng.random((h, w)) < density)
        n = min(len(xs), f)
        if layout == 'prefix':
            slots = np.arange(n)
        else:
            slots = rng.permutation(f)[:n]
            if layout == 'gapped':
                slots = np.sort(slots)
        lin[i, slots] = (ys * w + xs)[:n]
        valid[i, slots] = True
    marker = rng.random((t, f)) < marker_rate
    return lin, valid, marker


def _staircase(h, w):
    """The lins of a 4-connected staircase from the top right to the bottom
    left: a chain of 2 h - 1 pixels whose minimum lin sits at its far
    end, so that each table step moves a label a few pixels along it."""
    pix = []
    for y in range(h):
        x = w - 1 - y
        pix.append(y * w + x)
        if y + 1 < h:
            pix.append((y + 1) * w + x)
    return np.array(sorted(pix), np.int32)


def _jax_labels(lin, valid, w, connectivity, max_iters):
    return np.stack([np.asarray(jlb.label_components_table(
        lin[i], valid[i], w=w, connectivity=connectivity,
        max_iters=max_iters)) for i in range(lin.shape[0])])


def _check_compact(labels, valid, lin):
    """Both packages' compaction of the same labels, both orders."""
    lin_t = np.where(valid, lin, BIG).astype(np.int32)
    for reverse in (True, False):
        got, n_got = lb.compact_labels_table(
            torch.from_numpy(labels), torch.from_numpy(valid),
            torch.from_numpy(lin_t), reverse=reverse)
        for i in range(lin.shape[0]):
            ref, n_ref = jlb.compact_labels_table(labels[i], valid[i],
                                                  lin_t[i], reverse=reverse)
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))
            assert int(n_got[i]) == int(n_ref)


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('connectivity', [4, 8])
def test_label_and_compact_table_match_jax(connectivity, layout):
    """The batched port against the JAX function frame by frame: labels
    (2^30 at invalid entries) and the compaction in both orders."""
    rng = np.random.default_rng(11 + connectivity)
    h, w, t, f = 24, 37, 4, 500
    lin, valid, _ = _tables(rng, t, f, h, w, layout)
    valid[-1] = False
    got, steps = lb.label_components_table(
        torch.from_numpy(lin), torch.from_numpy(valid), w=w,
        connectivity=connectivity, max_iters=64)
    ref = _jax_labels(lin, valid, w, connectivity, 64)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (steps.numpy() < 64).all() and int(steps[-1]) == 0
    assert (got.numpy()[~valid] == BIG).all()
    _check_compact(ref, valid, lin)


@pytest.mark.parametrize('max_iters', [1, 2, 3])
@pytest.mark.parametrize('connectivity', [4, 8])
def test_cap_binds_on_a_long_chain(connectivity, max_iters):
    """A staircase of 127 pixels (and the same table shuffled, beside a
    short frame that converges): after 1-3 steps the labels are still
    moving, and the port's are JAX's, the compaction of the unconverged
    labels too."""
    h = w = 64
    chain = _staircase(h, w)
    f = 160
    rng = np.random.default_rng(3)
    lin = np.zeros((3, f), np.int32)
    valid = np.zeros((3, f), bool)
    lin[0, :len(chain)] = chain
    valid[0, :len(chain)] = True
    slots = rng.permutation(f)[:len(chain)]
    lin[1, slots] = chain
    valid[1, slots] = True
    lin[2, :4] = [0, 1, w, w + 1]
    valid[2, :4] = True
    got, steps = lb.label_components_table(
        torch.from_numpy(lin), torch.from_numpy(valid), w=w,
        connectivity=connectivity, max_iters=max_iters)
    ref = _jax_labels(lin, valid, w, connectivity, max_iters)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert steps[:2].tolist() == [max_iters, max_iters]
    # not converged: more than one label on the chain
    assert len(np.unique(ref[0][valid[0]])) > 1
    _check_compact(ref, valid, lin)
    full, _ = lb.label_components_table(torch.from_numpy(lin),
                                        torch.from_numpy(valid), w=w,
                                        connectivity=connectivity,
                                        max_iters=64)
    assert (full.numpy()[0][valid[0]] == chain.min()).all()


def _jax_route(lin, valid, marker, w, double, max_iters):
    """``ysmr_tpu``'s table route of the pixel-table branch
    (``detect_pixels.py:300-323``), composed of its jitted functions, up
    to the labels and keep."""
    import jax.numpy as jnp
    from functools import partial
    f = lin.shape[1]
    lin_t = jnp.where(valid, lin, jnp.int32(BIG))
    cc_t = partial(jlb.label_components_table, w=w, max_iters=max_iters)
    if double:
        lab4 = jax.vmap(partial(cc_t, connectivity=4))(lin_t, valid)
        comp4, _ = jax.vmap(partial(jlb.compact_labels_table,
                                    reverse=False))(lab4, valid, lin_t)
        marked = jax.vmap(lambda mk, c: jax.ops.segment_max(
            mk.astype(jnp.int32), jnp.minimum(c, f), num_segments=f + 1))(
                jnp.asarray(marker & valid), comp4)
        keep = valid & np.asarray(jnp.take_along_axis(
            marked, jnp.minimum(comp4, f), axis=1) > 0)
    else:
        keep = valid
    lab8 = jax.vmap(partial(cc_t, connectivity=8))(
        jnp.where(keep, lin, jnp.int32(BIG)), keep)
    return np.where(keep, np.asarray(lab8), -1), np.asarray(keep)


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('double', [True, False])
def test_cc_labels_table_is_jax_route(double, layout):
    """``cc_labels_table`` on the CPU (its plain version) gives the labels
    and keep of ``ysmr_tpu``'s table route, and, on the raster prefix,
    those of ``cc_labels_at_pixels``' plain version; ``raster_prefix``
    changes nothing on the CPU."""
    rng = np.random.default_rng(21)
    h, w, t, f = 30, 41, 3, 600
    lin, valid, marker = _tables(rng, t, f, h, w, layout, density=0.35)
    ref_lab, ref_keep = _jax_route(lin, valid, marker, w, double, 64)
    args = [torch.from_numpy(a) for a in (lin, valid, marker)]
    kw = dict(h=h, w=w, double_threshold=double, max_iters=64)
    lab, keep, steps = cc.cc_labels_table_plain(*args, **kw)
    assert (steps.numpy() < 64).all()
    np.testing.assert_array_equal(lab.numpy(), ref_lab)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert 0 < ref_keep.sum() < valid.sum() if double else True
    for prefix in (False, True):
        got = cc.cc_labels_table(*args, raster_prefix=prefix, **kw)
        assert torch.equal(got[0], lab) and torch.equal(got[1], keep)
    if layout == 'prefix':
        px = torch.from_numpy(lin % w), torch.from_numpy(lin // w)
        p_lab, p_keep, _ = cc.cc_labels_at_pixels_plain(*px, *args[1:], **kw)
        assert torch.equal(p_lab, lab) and torch.equal(p_keep, keep)


KDIST = 0x7FFFFFFF
KMARK = -(1 << 31)
FAR = -(1 << 30)
GARBAGE = 10 ** 9


def _warp_lower_bound(keys, ok, lo, hi, v, lanes=32):
    """``csrc/table_cc.cu``'s warp_lower_bound: 32 probes a round, an
    invalid slot past every key."""
    while lo < hi:
        step = (hi - lo + lanes - 1) // lanes
        c = sum(1 for lane in range(lanes)
                if lo + step * (lane + 1) - 1 < hi and
                ok[lo + step * (lane + 1) - 1] and
                keys[lo + step * (lane + 1) - 1] < v)
        lo, hi = min(lo + step * c, hi), min(hi, lo + step * (c + 1) - 1)
    return lo


def _bisect(key, lo, hi, pred):
    """The first slot in [lo, hi) where pred(key(slot), slot) holds (hi if
    none), by the kernel's binary search."""
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if pred(key(mid), mid) else (mid + 1, hi)
    return lo


def _segments(key, start, end, width, w):
    """(first slot, last slot, whether the first continues a run) of the
    warp segments over slots [start, end): warps of ``width`` slots from
    ``start``, the lanes of one run, members a prefix of the valid
    slots."""
    segs = []
    for wi in range(start, end, width):
        if key(wi) >= BIG:
            break
        for i in range(wi, min(wi + width, end)):
            lin = key(i)
            if lin >= BIG:
                break
            left = lin % w > 0 and key(i - 1) == lin - 1
            if i == wi or not left:
                segs.append([i, i, left])
            else:
                segs[-1][1] = i
    return segs


def _run_records(key, i_s, i_e, left_s, run_end, lo_slot, w, conn, record):
    """A segment's first upper candidate p4 (the first slot >= lo_slot of
    key >= its first lin - w; with 8-connectivity or at a run's first slot
    the up-left lin first) and, where ``record``, its up-left record (at a
    run's first slot) and up-right record (at a run's last slot): -1, the
    partner slot, or None where the segment writes none."""
    lin_s, lin_e = key(i_s), key(i_e)
    x_s, x_e = lin_s % w, lin_e % w
    up_left = x_s > 0 and (conn == 8 or (record and not left_s))
    p = 0
    if lin_s >= w:
        lo_lin = lin_s - w - (1 if up_left else 0)
        p = _bisect(key, max(i_s - w - 1, lo_slot), i_s,
                    lambda k, _: k >= lo_lin)
    p4, ul = p, -1
    if conn == 4 and up_left and lin_s >= w and p < i_s and \
            key(p) == lin_s - w - 1:
        p4 = p + 1
        if not (p4 < i_s and key(p4) == lin_s - w):
            ul = p
    ur = None
    if record and run_end:
        ur = -1
        if lin_s >= w and x_e < w - 1:
            want = lin_e - w + 1
            q = _bisect(key, p4, i_s, lambda k, _: k >= want)
            if q < i_s and key(q) == want and (q == 0 or
                                               key(q - 1) != want - 1):
                ur = q
    return p4, (ul if record and not left_s else None), ur


def _walk(key, i_s, i_e, p4, stop, w, conn, past=None):
    """The candidates a segment's lanes unite it with: from p4 below
    ``stop``, lane by lane, the first and each run's first slot; in
    ``past`` (a list) the slot a lane's walk stops at past the
    candidates."""
    lin_s, lin_e = key(i_s), key(i_e)
    if lin_s < w:
        return []
    hi = lin_e - w + (1 if conn == 8 and lin_e % w < w - 1 else 0)
    step = i_e - i_s + 1
    out = []
    for j0 in range(p4, p4 + step):
        for j in range(j0, stop, step):
            kj = key(j)
            if kj > hi:
                if past is not None:
                    past.append(j)
                break
            if j == p4 or not (j > 0 and kj % w > 0 and
                               key(j - 1) == kj - 1):
                out.append(j)
    return out


def _emulate_kernel(lin, valid, marker, w, double, prefix, rng,
                    tile=cc.TABLE_TILE, window=cc.TABLE_WINDOW, warp=32):
    """``csrc/table_cc.cu`` in numpy: per frame the sorted keys (or the
    raster prefix itself) and the distance forest over the sorted slots
    (the mark bit in the sign of a root's entry). tcc_local: tiles of
    ``tile`` slots past none of the valid prefix, each with its keys (and
    the slots just before and
    after), its runs (the tile's first slot starts one) and a forest over
    the runs' first slots in shared memory; a run at a time in a random
    order finds its first upper candidate in the tile (a binary search),
    unites its first slot with that of the candidate's run and of each
    run after it that starts in the candidates' range (the unions in a
    random order, each find pointing its slot at the root), and, where its
    row above is in the tile, records its diagonal partners (the up-right
    one the first slot past the candidate runs); then every valid slot
    points at its tile root, the roots of tile components with a marker
    are marked and each slot's flag byte written (tile root, marked,
    records).
    tcc_cross: per tile the window from the two 32-way searches (staged
    where at most ``window`` slots, else read from global memory), the
    cross slots' segments united with their candidates before the tile and
    their records, the tile's first slot united with the slot before where
    a run crosses; its unions in a random order. With the double threshold
    the merge is 4-connected; tcc_compress_mark points each tile root at
    its root and marks the root where the tile component was marked;
    tcc_diagonals unites each slot with a record, where kept, with its
    kept partner in the same forest; tcc_final walks every slot to its
    root and writes the root's lin (and its mark) at the table index.
    Launches run their work in a random order. The records, flags and the
    forest start as garbage, so a slot read before it is written
    fails."""
    t, f = lin.shape
    labels = np.full((t, f), GARBAGE, np.int64)
    keep = np.zeros((t, f), bool)
    conn = 4 if double else 8
    for fr in range(t):
        if prefix:
            keys, order = lin[fr].astype(np.int64), np.arange(f)
            ok = valid[fr].copy()
        else:
            lv = np.where(valid[fr], lin[fr], BIG).astype(np.int64)
            order = np.argsort(lv, kind='stable')
            keys = lv[order]
            ok = keys < BIG
        keys, ok = keys.tolist(), ok.tolist()
        d = [GARBAGE] * f
        flags = [GARBAGE] * f             # the keep output's plane
        rec = {'ul': [GARBAGE] * f, 'ur': [GARBAGE] * f}

        def gkey(j):
            if j < 0:
                return FAR
            return keys[j] if j < f and ok[j] else BIG

        def root(x, par=d):
            v = par[x]
            while v & KDIST:
                x -= v & KDIST
                v = par[x]
            return x, v

        def unite(a, b, par=d):
            def find(x):
                r, _ = root(x, par)
                if r != x and par[x] & KDIST != x - r:
                    par[x] = max(par[x], x - r)
                return r
            while True:
                a, b = find(a), find(b)
                if a == b:
                    return
                a, b = max(a, b), min(a, b)
                old = par[a]
                par[a] = max(old, a - b)
                if old & KDIST == 0:
                    return
                a -= old

        def is_end(key, i):
            kn = key(i + 1) if i + 1 < f else BIG
            return not (kn == key(i) + 1 and kn % w)

        tiles = [t0 for t0 in range(0, f, tile) if ok[t0]]
        # tcc_local
        for t0 in tiles:
            t1 = min(t0 + tile, f)
            kt = keys[t0]

            def key(j):
                return gkey(j) if t0 - 1 <= j <= t1 and j < f else (
                    BIG if j == t1 else None)
            nv = sum(1 for j in range(t0, t1) if ok[j])
            # the runs' first slots (the tile's first slot starts one)
            runs = [i for i in range(t0, t0 + nv)
                    if i == t0 or key(i) % w == 0 or
                    key(i - 1) != key(i) - 1]
            runs.append(t0 + nv)
            rid = {}
            for r in range(len(runs) - 1):
                for j in range(runs[r], runs[r + 1]):
                    rid[j] = r
            par = [0] * (t1 - t0)
            bits = [0] * (t1 - t0)
            unions = []
            for r in rng.permutation(len(runs) - 1):
                i_s, i_e = runs[r], runs[r + 1] - 1
                lin_s, lin_e = key(i_s), key(i_e)
                if lin_s < w:
                    continue
                x_s = lin_s % w
                x_e = x_s + lin_e - lin_s
                run_start = not (r == 0 and x_s > 0 and
                                 key(i_s - 1) == lin_s - 1)
                up_left = x_s > 0 and (conn == 8 or (double and run_start))
                lo_lin = lin_s - w - (1 if up_left else 0)
                p = _bisect(key, max(i_s - w - 1, t0), i_s,
                            lambda k, _: k >= lo_lin)
                if conn == 4 and up_left and p < i_s and \
                        key(p) == lin_s - w - 1:
                    if double and run_start and lin_s - w - 1 >= kt and \
                            not (p + 1 < i_s and key(p + 1) == lin_s - w):
                        rec['ul'][i_s] = p
                        bits[i_s - t0] |= 4
                    p += 1
                hi = lin_e - w + (1 if conn == 8 and x_e < w - 1 else 0)
                q = p
                if p < i_s and key(p) <= hi:
                    rr = rid[p]
                    unions.append((runs[rr], i_s))
                    while runs[rr + 1] < i_s and key(runs[rr + 1]) <= hi:
                        rr += 1
                        unions.append((runs[rr], i_s))
                    nxt = runs[rr + 1]
                    q = i_s if key(nxt - 1) > hi else nxt
                if double and x_e < w - 1 and lin_e - w - 1 >= kt and \
                        key(i_e + 1) != lin_e + 1 and q < i_s and \
                        key(q) == lin_e - w + 1 and key(q - 1) != lin_e - w:
                    rec['ur'][i_e] = q
                    bits[i_e - t0] |= 8
            for n in rng.permutation(len(unions)):
                a, b = unions[n]
                unite(a - t0, b - t0, par)
            roots = {}
            for j in rng.permutation(nv):
                roots[j] = root(runs[rid[t0 + j]] - t0, par)[0]
                if double and marker[fr, order[t0 + j]]:
                    bits[roots[j]] |= 2
            for j in range(t1 - t0):
                flags[t0 + j] = 0
                if j < nv:
                    d[t0 + j] = j - roots[j]
                    flags[t0 + j] = (bits[j] & 12) | (
                        1 | (bits[j] & 2) if roots[j] == j else 0)
        # tcc_cross
        unions = []
        for t0 in tiles:
            t1 = min(t0 + tile, f)
            kt = keys[t0]
            ws = _warp_lower_bound(keys, ok, max(t0 - 2 * w, 0), t0,
                                   kt - 2 * w)
            te = _warp_lower_bound(keys, ok, t0, min(t0 + w + 1, t1),
                                   kt + w + 1)
            staged = te - ws <= window
            if not staged:
                ws = te

            def key(j):
                if ws <= j < te or not (j < ws and staged):
                    return gkey(j)
                return FAR
            floor = ws if staged else 0
            if t0 > 0 and kt % w and keys[t0 - 1] == kt - 1:
                unions.append((t0, t0 - 1))
            for i_s, i_e, left_s in _segments(key, t0, te, warp, w):
                p4, ul, ur = _run_records(
                    key, i_s, i_e, left_s, is_end(key, i_e), floor, w, conn,
                    double)
                if ul is not None and ul >= 0:
                    rec['ul'][i_s] = ul
                    flags[i_s] |= 4
                if ur is not None and ur >= 0:
                    rec['ur'][i_e] = ur
                    flags[i_e] |= 8
                unions += [(i_s, j) for j in _walk(key, i_s, i_e, p4,
                                                   min(i_s, t0), w, conn)]
        for n in rng.permutation(len(unions)):
            unite(*unions[n])
        # the slots of the tiles tcc_local wrote
        slots = [i for i in range(f) if ok[i - i % tile]]
        if double:
            for n in rng.permutation(len(slots)):
                i = slots[n]
                if flags[i] & 1:
                    r, raw = root(i)
                    if r != i:
                        d[i] = i - r
                    if flags[i] & 2 and raw >= 0:
                        d[r] |= KMARK
            for n in rng.permutation(len(slots)):
                i = slots[n]
                if not flags[i] & 12 or root(i)[1] >= 0:
                    continue
                for bit, side in ((4, 'ul'), (8, 'ur')):
                    if flags[i] & bit:
                        r, raw = root(rec[side][i])
                        if raw < 0:
                            unite(i, r)
        for i in rng.permutation(f):
            k, lab = False, -1
            if ok[i]:
                r, raw = root(i)
                k = not double or raw < 0
                lab = keys[r] if k else -1
            labels[fr, order[i]] = lab
            keep[fr, order[i]] = k
    return labels, keep


def test_warp_lower_bound_design():
    """The 32-way searches of the cross launch's window are lower bounds:
    every range length up to 2500, targets below, inside and past the
    keys, and ranges that reach past the valid prefix."""
    rng = np.random.default_rng(2)
    keys = np.cumsum(rng.integers(1, 5, 3000)).tolist()
    for n in list(range(0, 70)) + [1023, 1024, 1025, 2456, 2500]:
        lo = int(rng.integers(0, 400))
        for n_ok in (lo + n, lo + n // 3):
            ok = [i < n_ok for i in range(len(keys))]
            for v in (-5, keys[lo], keys[lo + n // 2] + 1 if n else 0,
                      keys[lo + n] if n else 10 ** 6, 10 ** 6):
                want = lo + int(np.searchsorted(keys[lo:min(lo + n, n_ok)],
                                                v))
                assert _warp_lower_bound(keys, ok, lo, lo + n, v) == want


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('double', [True, False])
def test_table_kernel_design_matches_plain(double, layout):
    """The kernel's design, emulated, gives the plain version's bits: both
    routes (sorted, and the raster prefix where the table is one), random
    thread orders, a frame of one column and one of one row; at the
    kernel's tiling and at tiles of 64 slots with a window of at most 40
    staged slots and warps of 8 (runs across tiles and warps, windows read
    from global memory)."""
    rng = np.random.default_rng(5)
    for h, w, t, f in ((20, 33, 3, 400), (40, 1, 2, 50), (1, 90, 2, 120)):
        lin, valid, marker = _tables(rng, t, f, h, w, layout, density=0.5,
                                     marker_rate=0.1)
        args = [torch.from_numpy(a) for a in (lin, valid, marker)]
        p_lab, p_keep, steps = cc.cc_labels_table_plain(
            *args, h=h, w=w, double_threshold=double, max_iters=1000)
        assert (steps.numpy() < 1000).all()
        for prefix in ((False, True) if layout == 'prefix' else (False,)):
            for tiling in ({}, dict(tile=64, window=40, warp=8)):
                lab, keep = _emulate_kernel(lin, valid, marker, w, double,
                                            prefix, rng, **tiling)
                np.testing.assert_array_equal(lab, p_lab.numpy())
                np.testing.assert_array_equal(keep, p_keep.numpy())


def _edge_case(name, tile, window):
    lin, valid, marker, h, w = tcc_cases.table_case(name, tile, window)
    return [torch.from_numpy(a) for a in (lin, valid, marker)], h, w


@pytest.mark.parametrize('double', [True, False])
@pytest.mark.parametrize('name', tcc_cases.TABLE_CASES)
def test_table_kernel_design_on_edge_cases(name, double):
    """The design against the plain version on the edge cases cut to tiles
    of 64 slots and a window of 48 (warps of 32): a run across a tile's and
    a warp's edge, a window wider than that (read from global memory),
    a checkerboard (single-pixel runs joined by diagonals only), a valid
    prefix ending mid-tile, a full frame, a component of many marker runs;
    both routes (the sorted one on the table with its rows shuffled)."""
    rng = np.random.default_rng(9)
    (lin, valid, marker), h, w = _edge_case(name, 64, 48)
    perm = np.stack([rng.permutation(lin.shape[1])
                     for _ in range(lin.shape[0])])
    kw = dict(h=h, w=w, double_threshold=double, max_iters=10 ** 4)
    for prefix in (True, False):
        args = [a.numpy() if prefix else np.take_along_axis(a.numpy(), perm,
                                                            1)
                for a in (lin, valid, marker)]
        p_lab, p_keep, steps = cc.cc_labels_table_plain(
            *[torch.from_numpy(a) for a in args], **kw)
        assert bool((steps < 10 ** 4).all())
        if double:
            assert int(p_keep.sum()) > 0
        lab, keep = _emulate_kernel(*args, w, double, prefix, rng, tile=64,
                                    window=48)
        np.testing.assert_array_equal(lab, p_lab.numpy())
        np.testing.assert_array_equal(keep, p_keep.numpy())


@pytest.mark.parametrize('kwargs', [
    {}, {'use_run_cc': False}, {'include_luminosity': True},
    {'skip_rect': False}])
def test_detect_use_table_matches_jax(kwargs):
    """``detect_from_pixels(use_table=True)`` against ``ysmr_tpu``'s on
    the run wire, every output: on the run-CC branch (``{}``,
    ``skip_rect=False``) both ignore the flag; with ``use_run_cc=False``
    and with luminosity the pixel-table branch takes the table CC."""
    packed, counts, runs, rcnt, split, fv, gray = _wires()
    h, w, f = 120, 160, 2048
    args = dict(KW, use_table=True, h=h, w=w, max_det=24,
                double_threshold=True)
    args.update(kwargs)
    if not args['skip_rect']:
        args['cv2_centers'] = True
    ref = jdetect(None, None, counts, None, fv, px_runs=runs,
                  run_counts=rcnt, expanded_f=f, use_pallas=False, **args)
    got = detect_from_pixels(
        None, None, torch.from_numpy(counts), None, torch.from_numpy(fv),
        px_runs=torch.from_numpy(runs.view(np.int32)),
        run_counts=torch.from_numpy(rcnt), expanded_f=f, **args)
    assert set(got) == set(ref) | {'cc_steps'}
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert int(got['det_valid'].sum()) > 20


@pytest.mark.parametrize('skip_rect', [True, False])
@pytest.mark.parametrize('wire', ['runs', 'packed', 'split'])
def test_pixel_table_branch_use_table_matches_jax(wire, skip_rect):
    """The pixel-table branch with ``use_table`` on each wire, single and
    double threshold, every output, against ``ysmr_tpu``'s table route;
    and equal to the port's branch without the flag."""
    packed, counts, runs, rcnt, split, fv, gray = _wires()
    h, w, f = 120, 160, 2048
    jargs, jkw, targs, tkw = _wire_args(wire, packed, counts, runs, rcnt,
                                        split, fv, f)
    for dt in (True, False):
        kw = dict(h=h, w=w, double_threshold=dt, max_det=24, max_bh=16,
                  cc_iters=64, return_det_px=skip_rect, skip_rect=skip_rect,
                  cv2_centers=not skip_rect)
        ref = jdetect(*jargs, use_pallas=False, use_table=True, **jkw, **kw)
        got = detect_from_pixels(*targs, **tkw, use_table=True, **kw)
        plain = detect_from_pixels(*targs, **tkw, **kw)
        assert set(got) == set(ref) | {'cc_steps'}
        for key in ref:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(ref[key]),
                                          err_msg='{} {}'.format(key, dt))
            assert torch.equal(got[key], plain[key])


@pytest.mark.parametrize('setting', ['default wire', 'run cc off',
                                     'frames mode'])
def test_track_bacteria_use_table_matches_jax(tmp_path, setting):
    """``use table cc = True`` through both packages' ``track_bacteria`` on
    a synthetic clip: ``_list.csv`` byte-identical. On the default wire
    the port takes run-CC, which ignores the flag, and ``ysmr_tpu`` on the
    CPU the table route; with ``run cc = off`` both take the table route;
    frames mode (without GSFF) ignores the flag in both."""
    extra = {'use table cc': True}
    if setting == 'run cc off':
        extra['run cc'] = 'off'
    elif setting == 'frames mode':
        # without GSFF: with it the two frames modes differ in positions
        # by the tracker's double-single residue
        # (test_torch_track_bacteria.py::test_frames_mode_rows_match_jax)
        extra.update(FRAMES, **{'disable gsff': True})
    out = _run_both(tmp_path, 'adaptive_double', runs=(
        ('jax', jtrack, extra), ('torch', track_bacteria, extra)))
    (jres, jbytes), (tres, tbytes) = out['jax'], out['torch']
    assert jbytes.count(b'\n') > 100
    assert tbytes == jbytes
    assert tres[1:4] == jres[1:4]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('double', [True, False])
def test_table_kernel_matches_plain_on_cuda(double, layout):
    """The kernel against its plain version on the card, bit for bit, one
    launch a call, both routes; a frame wider than ``ysmr_cc_pixels``
    takes (its first rows' windows wider than the shared memory holds);
    the edge cases at the kernel's tiling (``table_cc_cases.py``: a run
    across a tile's and a warp's edge, a window read from global memory, a
    checkerboard, a prefix ending mid-tile, a full frame, a component of
    many marker runs; the sorted route on the rows shuffled); the
    fixpoint where the plain version's cap binds; the refusals."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    cases = [(60, 97, 4, 3000), (3, cc.PIXEL_MAX_WIDTH + 7000, 2, 20000),
             (50, 1, 2, 64), (1, 300, 2, 256)]
    tables = []
    for h, w, t, f in cases:
        tables.append((_tables(rng, t, f, h, w, layout,
                               density=0.4 if w > 1000 else 0.5), h, w,
                       layout == 'prefix'))
    if layout != 'gapped':
        for name in tcc_cases.TABLE_CASES:
            lin, valid, marker, h, w = tcc_cases.table_case(
                name, cc.TABLE_TILE, cc.TABLE_WINDOW)
            if layout == 'shuffled':
                perm = np.stack([rng.permutation(lin.shape[1])
                                 for _ in range(lin.shape[0])])
                lin, valid, marker = (np.take_along_axis(a, perm, 1)
                                      for a in (lin, valid, marker))
            tables.append(((lin, valid, marker), h, w, layout == 'prefix'))
    for arrays, h, w, is_prefix in tables:
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        kw = dict(h=h, w=w, double_threshold=double, max_iters=10 ** 4)
        p_lab, p_keep, steps = cc.cc_labels_table_plain(*args, **kw)
        assert bool((steps < 10 ** 4).all())
        for prefix in ((False, True) if is_prefix else (False,)):
            cc.cc_labels_table.launches = 0
            lab, keep = cc.cc_labels_table(*args, raster_prefix=prefix, **kw)
            torch.cuda.synchronize()
            assert cc.cc_labels_table.launches == 1
            assert torch.equal(lab, p_lab) and torch.equal(keep, p_keep), \
                (h, w, prefix)
    # where ysmr_tpu's cap binds the kernel reaches the fixpoint
    # (ROADMAP's "Differences from ysmr_tpu")
    chain = _staircase(64, 64)
    lin = torch.from_numpy(np.pad(chain, (0, 33))[None]).to(dev)
    ok = torch.arange(lin.shape[1], device=dev)[None] < len(chain)
    kw = dict(h=64, w=64, double_threshold=double, max_iters=1)
    lab, keep = cc.cc_labels_table(lin, ok, ok, **kw)
    p_lab, p_keep, steps = cc.cc_labels_table_plain(lin, ok, ok, **kw)
    assert int(steps.max()) == 1 and torch.equal(keep, p_keep)
    assert bool((lab[ok] == int(chain.min())).all())
    assert not torch.equal(lab, p_lab)
    with pytest.raises(ValueError, match='2\\^30'):
        cc.cc_labels_table(*args, h=1 << 15, w=1 << 15,
                           double_threshold=double)
    with pytest.raises(ValueError, match='contiguous'):
        cc.cc_labels_table(args[0].to(torch.int64), *args[1:], h=1, w=300,
                           double_threshold=double)
