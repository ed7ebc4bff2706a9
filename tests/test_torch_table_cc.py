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


def _emulate_kernel(lin, valid, marker, w, double, prefix, rng):
    """``csrc/table_cc.cu`` in numpy: per frame the sorted keys (or the
    raster prefix itself) and the distance forests over the sorted slots;
    tcc_merge's warps of 32 slots split into segments (the lanes of one
    run), each lane hooked under its segment's first slot (the first
    under its left slot where the run goes on before the warp), the
    segment's upper candidates found by its first lane's lower bound among
    the w + 1 slots before it, shared out over its lanes, and the first
    candidate of each run above united with the lane's slot; the unions of
    a launch in a random order, each find pointing its slot at the root.
    With the double threshold that merge is 4-connected; tcc_compress_mark
    points each slot at its root in both forests and marks the roots;
    tcc_diagonals unites each kept run end with its kept diagonal above
    (up-left of a run's first pixel, up-right of its last) in the
    8-connected forest. tcc_final writes the root's lin at the slot's
    table index."""
    t, f = lin.shape
    labels = np.full((t, f), 12345, np.int32)
    keep = np.zeros((t, f), bool)
    for fr in range(t):
        if prefix:
            keys, order = lin[fr].astype(np.int64), np.arange(f)
            ok = valid[fr].copy()
        else:
            lv = np.where(valid[fr], lin[fr], BIG).astype(np.int64)
            order = np.argsort(lv, kind='stable')
            keys = lv[order]
            ok = keys < BIG
        d4 = np.zeros(f, np.int64)
        d8 = np.zeros(f, np.int64)
        mark = np.zeros(f, bool)

        def root(d, x):
            while d[x]:
                x -= d[x]
            return x

        def find(d, x):
            r = root(d, x)
            d[x] = max(d[x], x - r)
            return r

        def unite(d, a, b):
            while True:
                a, b = find(d, a), find(d, b)
                if a == b:
                    return
                a, b = max(a, b), min(a, b)
                old = d[a]
                d[a] = max(old, a - b)
                if old == 0:
                    return
                a -= old

        def kept(j):
            return mark[j - d4[j]]

        def lower_bound(i, want):
            first = max(i - w - 1, 0)
            return first + int(np.searchsorted(keys[first:i], want))

        def merge(conn, d):
            unions = []
            for w0 in range(0, f, 32):
                lanes = range(w0, min(w0 + 32, f))
                left = {i: bool(ok[i]) and keys[i] % w > 0 and i > 0 and
                        keys[i - 1] == keys[i] - 1 for i in lanes}
                for i in lanes:
                    if not ok[i]:
                        continue
                    s = i
                    while s > w0 and left[s]:
                        s -= 1
                    e = i
                    while e + 1 in left and left[e + 1]:
                        e += 1
                    if i > s:
                        unions.append((i, s))
                    elif left[i]:
                        unions.append((i, i - 1))
                    lin_s, lin_e = int(keys[s]), int(keys[e])
                    if lin_s < w:
                        continue
                    lo = lin_s - w - (1 if conn == 8 and lin_s % w else 0)
                    hi = lin_e - w + (1 if conn == 8 and
                                      lin_e % w < w - 1 else 0)
                    p0 = lower_bound(s, lo)
                    j = p0 + (i - s)
                    while j < s and keys[j] <= hi:
                        if j == p0 or keys[j - 1] != keys[j] - 1:
                            unions.append((i, j))
                        j += e - s + 1
            for n in rng.permutation(len(unions)):
                unite(d, *unions[n])

        if double:
            merge(4, d4)
            for i in rng.permutation(f):
                if ok[i]:
                    r = root(d4, i)
                    d4[i] = d8[i] = i - r
                    if marker[fr, order[i]]:
                        mark[r] = True
            unions = []
            for i in range(f):
                lin_i = int(keys[i])
                if not ok[i] or lin_i < w:
                    continue
                x = lin_i % w
                up_left = x > 0 and not (i > 0 and keys[i - 1] == lin_i - 1)
                up_right = x < w - 1 and not (
                    i + 1 < f and ok[i + 1] and keys[i + 1] == lin_i + 1)
                if not (up_left or up_right) or not kept(i):
                    continue
                for side, want in ((up_left, lin_i - w - 1),
                                   (up_right, lin_i - w + 1)):
                    j = lower_bound(i, want)
                    if side and j < i and keys[j] == want and kept(j):
                        unions.append((i, j))
            for n in rng.permutation(len(unions)):
                unite(d8, *unions[n])
        else:
            merge(8, d8)
        for i in rng.permutation(f):
            k = bool(ok[i]) and (not double or kept(i))
            labels[fr, order[i]] = keys[root(d8, i)] if k else -1
            keep[fr, order[i]] = k
    return labels, keep


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('double', [True, False])
def test_table_kernel_design_matches_plain(double, layout):
    """The kernel's design, emulated, gives the plain version's bits: both
    routes (sorted, and the raster prefix where the table is one), random
    thread orders, a frame of one column and one of one row."""
    rng = np.random.default_rng(5)
    for h, w, t, f in ((20, 33, 3, 400), (40, 1, 2, 50), (1, 90, 2, 120)):
        lin, valid, marker = _tables(rng, t, f, h, w, layout, density=0.5,
                                     marker_rate=0.1)
        args = [torch.from_numpy(a) for a in (lin, valid, marker)]
        p_lab, p_keep, steps = cc.cc_labels_table_plain(
            *args, h=h, w=w, double_threshold=double, max_iters=1000)
        assert (steps.numpy() < 1000).all()
        for prefix in ((False, True) if layout == 'prefix' else (False,)):
            lab, keep = _emulate_kernel(lin, valid, marker, w, double,
                                        prefix, rng)
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
    takes; the fixpoint where the plain version's cap binds; the
    refusals."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    cases = [(60, 97, 4, 3000), (3, cc.PIXEL_MAX_WIDTH + 7000, 2, 20000),
             (50, 1, 2, 64), (1, 300, 2, 256)]
    for h, w, t, f in cases:
        lin, valid, marker = _tables(rng, t, f, h, w, layout,
                                     density=0.4 if w > 1000 else 0.5)
        args = [torch.from_numpy(a).to(dev) for a in (lin, valid, marker)]
        kw = dict(h=h, w=w, double_threshold=double, max_iters=1000)
        p_lab, p_keep, steps = cc.cc_labels_table_plain(*args, **kw)
        assert bool((steps < 1000).all())
        for prefix in ((False, True) if layout == 'prefix' else (False,)):
            cc.cc_labels_table.launches = 0
            lab, keep = cc.cc_labels_table(*args, raster_prefix=prefix, **kw)
            torch.cuda.synchronize()
            assert cc.cc_labels_table.launches == 1
            assert torch.equal(lab, p_lab) and torch.equal(keep, p_keep)
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
