"""Mean-threshold mode of the port's frames path (ysmr_tpu_torch/ops/
preprocess.py::mean_prepare_from_bgr and ::mean_masks, the kernels
``ysmr_mean_prepare`` and ``ysmr_mean_masks`` of csrc/adaptive_mean.cu,
and pipeline/detect.py::detect_mean) against ysmr_tpu on the same seeded
frames.

Tolerance: bit equality everywhere. The plain versions against JAX's
jitted ``prepare_batch(needs_sums=True)`` and ``detect_masks(..., 'mean')``
with ``& frame_valid`` (the blurred frames, the sums [total, hi, lo], the
gray frames, the masks); numpy models of the kernels' designs
(``mean_mode_cases.py``: the warp tiles' row sums, the row table and the
atomics in shuffled order, the hi/lo split of each whole row sum by the
frame's last tile, the lanes' gray words, neighbour columns and blur in
16-bit lanes, the masks kernel's head, 16-byte body and tail of each
frame) against the plain versions; ``detect_batch`` in mean mode
against JAX's over two batches, the second one short. The kernels
themselves are held to the plain versions on the card by
``tests/test_torch_mean_mode_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mean_mode_cases as mmc
from test_torch_detect import T, seeded_frames
from ysmr_tpu.ops import preprocess as jpp
from ysmr_tpu.pipeline import detect as jdet
from ysmr_tpu_torch.ops import preprocess as pp
from ysmr_tpu_torch.pipeline import detect as det

torch.set_num_threads(1)


def _jax_prepare(bgr):
    gray, blurred, total, hi, lo = jax.jit(
        jdet.prepare_batch, static_argnames=('needs_sums',))(
            bgr, needs_sums=True)
    sums = np.stack([np.asarray(total), np.asarray(hi), np.asarray(lo)], 1)
    return np.asarray(blurred), sums, np.asarray(gray)


def _jax_masks(blurred, thresholds, valid, white):
    mask, markers = jax.jit(jpp.detect_masks, static_argnums=(1, 2, 3, 4))(
        blurred, 'mean', 5, -1.0, white, global_thresholds=thresholds)
    assert markers is None
    return np.asarray(mask) & valid[:, None, None]


@pytest.mark.parametrize('shape', mmc.SHAPES + mmc.EDGE_SHAPES)
def test_mean_prepare_plain_matches_jitted_jax(rng, shape):
    """Blurred frames (uint8), the sums and the gray frames of the plain
    prepare, bit for bit against JAX's jitted prepare_batch(needs_sums=
    True)."""
    bgr = mmc.bgr_frames(rng, shape)
    blurred, sums, gray = pp.mean_prepare_from_bgr_plain(
        torch.from_numpy(bgr), want_gray=True)
    want_blurred, want_sums, want_gray = _jax_prepare(bgr)
    assert blurred.dtype == torch.uint8 and sums.dtype == torch.int32
    assert tuple(sums.shape) == (shape[0], 3) and gray.dtype == torch.int32
    np.testing.assert_array_equal(blurred.numpy(), want_blurred)
    np.testing.assert_array_equal(sums.numpy(), want_sums)
    np.testing.assert_array_equal(gray.numpy(), want_gray)
    assert pp.mean_prepare_from_bgr_plain(torch.from_numpy(bgr))[2] is None


def test_mean_prepare_row_sum_wraps_as_in_jax():
    """A 1 x 40,000 frame of 255s: each row's sum of squares passes 2^31
    and wraps in int32, so hi is negative; the plain version and the
    kernel's design give JAX's bits."""
    bgr = mmc.wrap_frames()
    _, sums, gray = pp.mean_prepare_from_bgr_plain(torch.from_numpy(bgr),
                                                   want_gray=True)
    want = _jax_prepare(bgr)[1]
    np.testing.assert_array_equal(sums.numpy(), want)
    assert want[0, 1] < 0
    np.testing.assert_array_equal(
        mmc.prepare_sums_design(gray.numpy(), np.random.default_rng(1)),
        want)


@pytest.mark.parametrize('white', [True, False])
@pytest.mark.parametrize('shape', mmc.SHAPES + mmc.EDGE_SHAPES)
def test_mean_masks_plain_matches_jitted_jax(rng, shape, white):
    """The plain masks against JAX's jitted detect_masks(..., 'mean') &
    frame_valid, bit for bit: thresholds of 0, 255 and beyond the uint8
    range, padding frames."""
    blurred = _jax_prepare(mmc.bgr_frames(rng, shape))[0]
    thr = mmc.frame_thresholds(rng, shape[0])
    valid = mmc.padded_valid(shape[0])
    got = pp.mean_masks_plain(torch.from_numpy(blurred.astype(np.uint8)),
                              torch.from_numpy(thr), torch.from_numpy(valid),
                              white)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_masks(blurred, thr, valid, white))


@pytest.mark.parametrize('shape', mmc.SHAPES + mmc.EDGE_SHAPES)
def test_prepare_sums_design_matches_plain(rng, shape):
    """The prepare kernel's sums as its design forms them (warp tiles of
    30 rows and 128 columns, lane partials, each row's warp sum, the row
    table and totals by atomics as the tiles finish in shuffled order, the
    hi/lo split of each whole row by the frame's last tile) equal the plain
    version's, also on gray values near 255 where row sums are large (over
    274 strips of 2 x 3 x 35000 they wrap in int32)."""
    for bgr in (mmc.bgr_frames(rng, shape),
                np.full(tuple(shape) + (3,), 250, np.uint8)):
        _, sums, gray = pp.mean_prepare_from_bgr_plain(
            torch.from_numpy(bgr), want_gray=True)
        np.testing.assert_array_equal(
            mmc.prepare_sums_design(gray.numpy(), rng), sums.numpy())


def test_blur_window_bytes_design(rng):
    """The prepare kernel's gray and blur as its design forms them (lanes
    of 4 columns, the neighbour columns from the next lanes or, at a
    warp's edges, from one more BGR word dotted with that word's layout,
    reflect-101 at the frame's edges, [1 2 1] in 16-bit lanes, a word of 4
    blurred bytes a lane) equal the plain blur of the plain gray: frames of
    random, ramp, white and black pixels, over several strips (the bench
    width), W % 4 != 0, 4 columns, one row, one column."""
    sizes = ((5, 261), (4, 260), (3, 1228), (1, 130), (3, 1), (33, 4),
             (2, 8), (6, 23))
    for kind in ('random', 'ramp', 'white', 'black'):
        for h, w in sizes:
            if kind == 'random':
                bgr = mmc.bgr_frames(rng, (1, h, w))[0]
            else:
                fill = {'ramp': np.arange(h * w * 3) % 256, 'white': 255,
                        'black': 0}[kind]
                bgr = np.broadcast_to(fill, (h * w * 3,)).astype(
                    np.uint8).reshape(h, w, 3)
            want = pp.mean_prepare_from_bgr_plain(
                torch.from_numpy(np.ascontiguousarray(bgr[None])))[0][0]
            np.testing.assert_array_equal(mmc.blur_design(bgr),
                                          want.numpy(), err_msg=(kind, h, w))


@pytest.mark.parametrize('shape', mmc.SHAPES + mmc.EDGE_SHAPES)
def test_masks_design_matches_plain(rng, shape):
    """The masks kernel's design (a block row a frame; the frame's head
    and tail bytes alone, its 16-byte body a word at a time, or every byte
    alone where the blurred frames and the mask differ in alignment)
    equals the plain version in both polarities, with padding frames at
    the end and between valid ones, out-of-range thresholds and the batch
    at each offset mod 16 (frame starts 8 mod 16 and 1 mod 16 among them)."""
    blurred = rng.integers(0, 256, shape).astype(np.uint8)
    thr = mmc.frame_thresholds(rng, shape[0])
    for valid in (mmc.padded_valid(shape[0]), mmc.gapped_valid(shape[0])):
        for white in (True, False):
            want = pp.mean_masks_plain(torch.from_numpy(blurred),
                                       torch.from_numpy(thr),
                                       torch.from_numpy(valid), white)
            for base, vec in ((0, True), (8, True), (1, True), (0, False)):
                np.testing.assert_array_equal(
                    mmc.masks_design(blurred, thr, valid, white, base, vec),
                    want.numpy(), err_msg=(base, vec))


def test_wrappers_route_to_plain_on_cpu_and_refuse(rng):
    """A CPU tensor goes to the plain versions and launches nothing; what
    the kernels do not take raises ValueError (meta tensors, wrong dtypes
    and shapes, non-contiguous inputs, a frame_valid or thresholds vector
    that does not match the frames)."""
    bgr = torch.from_numpy(mmc.bgr_frames(rng, (3, 40, 70)))
    pp.mean_prepare_from_bgr.launches = 0
    pp.mean_masks.launches = 0
    for want_gray in (False, True):
        got = pp.mean_prepare_from_bgr(bgr, want_gray)
        want = pp.mean_prepare_from_bgr_plain(bgr, want_gray)
        assert (got[2] is None) != want_gray
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)
    blurred = got[0]
    thr = torch.from_numpy(mmc.frame_thresholds(rng, 3))
    valid = torch.tensor([True, False, True])
    for white in (True, False):
        assert torch.equal(pp.mean_masks(blurred, thr, valid, white),
                           pp.mean_masks_plain(blurred, thr, valid, white))
    assert (pp.mean_prepare_from_bgr.launches, pp.mean_masks.launches) == \
        (0, 0)
    meta = torch.empty((1, 4, 4, 3), dtype=torch.uint8, device='meta')
    for frames in (meta, bgr.to(torch.int32), bgr[..., :2].contiguous(),
                   bgr[0], bgr.transpose(1, 2)):
        with pytest.raises(ValueError):
            pp.mean_prepare_from_bgr(frames)
    meta_b = torch.empty((1, 4, 4), dtype=torch.uint8, device='meta')
    meta_1 = torch.empty(1, dtype=torch.int32, device='meta')
    bad = [
        (meta_b, meta_1, meta_1.to(torch.bool)),
        (meta_b, thr[:1], valid[:1]),
        (blurred.to(torch.int32), thr, valid),
        (blurred.transpose(1, 2), thr, valid),
        (blurred[0], thr, valid),
        (blurred, thr.to(torch.int64), valid),
        (blurred, thr[:2], valid),
        (blurred, thr, valid.to(torch.uint8)),
        (blurred, thr, valid[:2]),
        (blurred, thr, torch.ones(6, dtype=torch.bool)[::2]),
        (blurred, torch.zeros(6, dtype=torch.int32)[::2], valid)]
    for args in bad:
        with pytest.raises(ValueError):
            pp.mean_masks(*args, True)
    assert (pp.mean_prepare_from_bgr.launches, pp.mean_masks.launches) == \
        (0, 0)


SETTINGS = {
    'adaptive double threshold': -1.0,
    'threshold offset for detection': 5,
    'white bacteria on dark background': True,
    'max detections per frame': 24,
    'max bounding box height': 16,
    'connected components max iterations': 64,
    'include luminosity in tracking calculation': False,
    'luminosity window size': 48,
}

CASES = {
    'white': {},
    'dark': {'white bacteria on dark background': False,
             'threshold offset for detection': 10},
    'luminosity': {'include luminosity in tracking calculation': True},
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_detect_batch_mean_matches_jax(case, monkeypatch):
    """detect_batch in mean mode against JAX's over two batches (the
    second short, its padding frames detect nothing; the 5 s window
    carries over): the tables bit for bit and the same thresholds. It
    calls mean_prepare_from_bgr and mean_masks once a batch, neither
    prepare_batch nor detect_from_blurred, and copies to the host once."""
    settings = {**SETTINGS, **CASES[case]}
    cfg = det.DetectorConfig(settings)
    jcfg = jdet.DetectorConfig(settings, 30)
    assert cfg.mode == 'mean'
    state = pp.MovingAverageThreshold(1, cfg.offset, cfg.white_on_dark)
    jstate = jpp.MovingAverageThreshold(1, cfg.offset, cfg.white_on_dark)
    calls = {'prepare': 0, 'masks': 0, 'cpu': 0}

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    def refuse(*args, **kwargs):
        raise AssertionError('mean mode ran the separate passes')

    monkeypatch.setattr(pp, 'mean_prepare_from_bgr',
                        count('prepare', pp.mean_prepare_from_bgr))
    monkeypatch.setattr(pp, 'mean_masks', count('masks', pp.mean_masks))
    monkeypatch.setattr(det, 'prepare_batch', refuse)
    monkeypatch.setattr(det, 'detect_from_blurred', refuse)
    monkeypatch.setattr(torch.Tensor, 'cpu', count('cpu', torch.Tensor.cpu))
    for batch, count_ in ((0, T), (1, T - 1)):
        frames = seeded_frames(batch + 3, dark=case == 'dark')
        valid = np.arange(T) < count_
        before = dict(calls)
        ours = det.detect_batch(torch.from_numpy(frames),
                                torch.from_numpy(valid), cfg,
                                threshold_state=state)
        assert {k: calls[k] - before[k] for k in calls} == \
            {'prepare': 1, 'masks': 1, 'cpu': 1}
        ref = jdet.detect_batch(jnp.asarray(frames), jnp.asarray(valid),
                                jcfg, threshold_state=jstate,
                                use_pallas=False)
        for key in ('det_xy', 'det_info', 'det_valid', 'n_components'):
            np.testing.assert_array_equal(ours[key].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
        assert ours['det_valid'][:count_].sum(dim=1).min() > 0
        assert not ours['det_valid'][count_:].any()
    assert state.window == jstate.window and len(state.window) > T
