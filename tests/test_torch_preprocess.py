"""Device preprocessing of the PyTorch port (ysmr_tpu_torch/ops/preprocess.py)
against the jitted JAX functions and OpenCV, on the shapes of
tests/test_preprocess.py.

Every output is compared bit for bit. The float32 adaptive mean is held to
the jitted JAX function (XLA:CPU contracts its taps into fmas; the port
forms the same fmas exactly) on the shapes that make edges of the CUDA
kernel's tiles and of the plain version's chunks, and, through the
threshold, to cv2.adaptiveThreshold, including a 922x1228 frame. Frames
mode's single pass (``adaptive_masks_from_bgr``) is held to the jitted JAX
chain (``prepare_batch``, ``detect_masks``, ``& frame_valid``), and both
kernels' tile designs are emulated here; the ``cuda``-marked tests hold
the kernels to the plain versions on the card.
"""

import cv2
import jax
import numpy as np
import pytest
import torch

from ysmr_tpu.ops import preprocess as jpp
from ysmr_tpu.pipeline import detect as jdet
from ysmr_tpu_torch.ops import preprocess as pp

torch.set_num_threads(1)


@pytest.fixture
def frames(rng):
    return rng.integers(0, 256, (3, 61, 83, 3), dtype=np.uint8)


def _np(t):
    return t.numpy()


def test_bgr_to_gray_matches_jax_and_cv2(frames):
    ours = _np(pp.bgr_to_gray(torch.from_numpy(frames)))
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(
        ours, np.asarray(jax.jit(jpp.bgr_to_gray)(frames)))
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(ours[i].astype(np.uint8),
                                      cv2.cvtColor(f, cv2.COLOR_BGR2GRAY))


def test_blur3_matches_jax_and_cv2(frames):
    gray = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames])
    ours = _np(pp.blur3(torch.from_numpy(gray.astype(np.int32))))
    np.testing.assert_array_equal(
        ours, np.asarray(jax.jit(jpp.blur3)(gray.astype(np.int32))))
    for i in range(len(frames)):
        np.testing.assert_array_equal(ours[i].astype(np.uint8),
                                      cv2.GaussianBlur(gray[i], (3, 3), 0))


def test_gaussian_kernel_matches_jax():
    np.testing.assert_array_equal(pp._K11_F32, jpp._K11_F32)


#: the adaptive mean's edge shapes: one pixel, H and W under the 11 taps,
#: a partial 16-frame chunk of the plain version with W past the kernel's
#: 64-column tile, and partial 32 x 64 tiles at full size
EDGE_MEAN_SHAPES = [(1, 1, 1), (3, 7, 5), (17, 33, 129), (2, 921, 1227)]
#: values outside 0-255, as the kernel and the plain version take them
WIDE = (-70000, 70001)


@pytest.mark.parametrize('shape', [(3, 61, 83), (2, 922, 1228)] +
                         EDGE_MEAN_SHAPES)
def test_adaptive_mean_matches_jitted_jax(rng, shape):
    img = rng.integers(0, 256, shape).astype(np.int32)
    ours = _np(pp.adaptive_gaussian_mean(torch.from_numpy(img)))
    np.testing.assert_array_equal(
        ours, np.asarray(jax.jit(jpp.adaptive_gaussian_mean)(img)))


@pytest.mark.parametrize('shape', [(3, 61, 83), (17, 33, 129)])
def test_adaptive_mean_wide_values_match_jitted_jax(rng, shape):
    """Values in +-70,000: float32 sums far from the 0-255 range, still
    exact integers on input."""
    img = rng.integers(*WIDE, shape).astype(np.int32)
    ours = _np(pp.adaptive_gaussian_mean(torch.from_numpy(img)))
    np.testing.assert_array_equal(
        ours, np.asarray(jax.jit(jpp.adaptive_gaussian_mean)(img)))


#: csrc/adaptive_mean.cu's tile: output rows and columns, the rows of a
#: thread's strip in the mean
TILE_H, TILE_W, STRIP = 64, 128, 16


def _strip_means(win, k):
    """The mean's phase of a tile: each 16-row strip's chains over its 26
    window rows (the horizontal chain of each row, then the vertical chain
    over 11 of them: the register ring), the strips stacked."""
    out = []
    for s in range(0, win.shape[-2] - 10, STRIP):
        rows = win[..., s:s + STRIP + 10, :]
        out.append(pp._taps11(pp._taps11(rows, -1, k), -2, k))
    return torch.cat(out, dim=-2)


def _tiled_mean(img):
    """csrc/adaptive_mean.cu's ysmr_adaptive_mean, tile by tile: the
    float32 input at the clamped (TILE_H + 10) x (TILE_W + 10) window
    positions, the strips' chains, the ragged edge cut off."""
    t, h, w = img.shape
    k = [torch.tensor(v, dtype=torch.float32) for v in pp._K11_F32]
    out = torch.empty_like(img)
    for y0 in range(0, h, TILE_H):
        for x0 in range(0, w, TILE_W):
            ys = torch.arange(y0 - 5, y0 + TILE_H + 5).clamp(0, h - 1)
            xs = torch.arange(x0 - 5, x0 + TILE_W + 5).clamp(0, w - 1)
            win = img[:, ys][:, :, xs].to(torch.float32)
            cut = torch.floor(_strip_means(win, k) + 0.5).to(torch.int32)
            out[:, y0:y0 + TILE_H, x0:x0 + TILE_W] = \
                cut[:, :min(TILE_H, h - y0), :min(TILE_W, w - x0)]
    return out


def _reflect101_clamped(v, n):
    """The kernel's map of a window position to a pixel: reflect-101, then
    clamped (positions past the blur's one-pixel halo feed no output)."""
    v = np.where(v < 0, -v, np.where(v >= n, 2 * n - 2 - v, v))
    return np.clip(v, 0, n - 1)


#: csrc/adaptive_mean.cu's fused pass: a warp's output columns (lanes 2-29
#: of 4 columns), the halo columns left of them (lanes 0 and 1), the output
#: rows of a band at most
STRIP_W, STRIP_HALO, BAND_MAX = 112, 8, 64


def _lane_gray(gray, rows, x0, w, words):
    """The gray of frame rows ``rows`` (mapped by reflect-101) as a warp's
    lanes form it: lane l's 4 columns x0 + 4 l .. + 3 (the word path reads
    the groups inside the frame and has zeros elsewhere; the byte path
    reads every column at its reflect-101 column), then columns x - 1 and
    x + 4 from lanes l - 1 and l + 1 (``__shfl_up`` / ``__shfl_down``:
    lanes 0 and 31 get their own word), on the word path column 1 for x =
    0 and column w - 2 for x + 4 = w. Returns (n, rows, 32, 6): each
    lane's columns x - 1 .. x + 4."""
    cols = x0 + np.arange(4 * 32)
    g = gray[:, rows]
    if words:
        inside = (cols >= 0) & (cols < w)
        g = np.where(inside, g[:, :, np.clip(cols, 0, w - 1)], 0)
    else:
        g = g[:, :, _reflect101_clamped(cols, w)]
    g = g.reshape(g.shape[:2] + (32, 4))
    lw = np.concatenate([g[:, :, :1, 3], g[:, :, :-1, 3]], axis=2)
    rw = np.concatenate([g[:, :, 1:, 0], g[:, :, -1:, 0]], axis=2)
    if words:
        x = x0 + 4 * np.arange(32)
        lw = np.where(x == 0, g[..., 1], lw)
        rw = np.where(x + 4 == w, g[..., 2], rw)
    return np.concatenate([lw[..., None], g, rw[..., None]], axis=-1)


def _tiled_masks(bgr, valid, mode, c_offset, double_delta, white,
                 words=None):
    """csrc/adaptive_mean.cu's ysmr_adaptive_masks, warp by warp, in numpy
    and the plain version's float32 chains (``ds.fma_f32``). A warp takes
    a band of output rows (the frame's rows in ceil(H / 64) bands of equal
    height, the last shorter) of a 112-column strip whose lanes hold the
    columns from 8 left of it: the window rows y0 - 5 .. y0 + rows + 4,
    each the blurred row clamp(y), from gray rows reflect-101(b - 1), b,
    reflect-101(b + 1) formed as the lanes form them (``_lane_gray``), the
    [1 2 1] sums by lane, (S + 8) >> 4; columns left of the frame take
    column 0 and columns from W on column W - 1 (the edge strips'
    ``__shfl``); the horizontal chains of lanes 2-29 over columns x - 5 ..
    x + 8, the vertical chains over the band's window rows; the rules in
    16-bit lanes, bit 15 of blur + 0x8100 - T - mean with T = 257 + bound
    clamped to 0 .. 512 and mean = floor(acc + 0.5) as the low byte of
    (acc + 0.5) + 2^23 rounded down, != dark (white keeps blur - mean >
    bound), zeros for an invalid frame; the gray as the lanes formed it.
    ``words``: the word path (default W % 4 == 0), else the byte path."""
    n, h, w, _ = bgr.shape
    words = w % 4 == 0 if words is None else words
    k = [torch.tensor(v, dtype=torch.float32) for v in pp._K11_F32]
    dark = not white
    bounds = [pp._rule_bound(-c_offset, white)]
    if mode == 'adaptive_double':
        bounds.append(pp._rule_bound(-(c_offset + double_delta), white))
    outs = [np.zeros((n, h, w), bool) for _ in bounds]
    gray_out = np.zeros((n, h, w), np.int32)
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    gray = (b * 3735 + g * 19235 + r * 9798 + 16384) >> 15
    bands = -(-h // BAND_MAX)
    band = -(-h // bands)
    for y0 in range(0, h, band):
        rows = min(band, h - y0)
        for s0 in range(0, w, STRIP_W):
            x0 = s0 - STRIP_HALO
            # gray rows b - 1 .. b + 1 of every blurred row b of the window
            first = max(y0 - 5, 0)
            last = min(y0 + rows + 4, h - 1)
            gi = np.arange(first - 1, last + 2)
            ext = _lane_gray(gray, _reflect101_clamped(gi, h), x0, w, words)
            hs = (ext[..., :4] + 2 * ext[..., 1:5] + ext[..., 2:6]).reshape(
                n, len(gi), 4 * 32)
            blur_rows = (hs[:, :-2] + 2 * hs[:, 1:-1] + hs[:, 2:] + 8) >> 4
            ys = np.clip(np.arange(y0 - 5, y0 + rows + 5), 0, h - 1)
            win = blur_rows[:, ys - first]           # (n, rows + 10, 128)
            v = win.copy()
            if x0 < 0:
                v[..., :-x0] = v[..., -x0:1 - x0]
            if x0 + 4 * 32 > w:
                v[..., w - x0:] = v[..., w - 1 - x0:w - x0]
            acc = pp._taps11(pp._taps11(
                torch.from_numpy(v.astype(np.float32)), -1, k), -2, k)
            cols = slice(STRIP_HALO - 5, STRIP_HALO - 5 + STRIP_W)
            half = acc[..., cols].numpy() + np.float32(0.5)
            # the low byte of half + 2^23 rounded down (to the float32 grid
            # of spacing 1 there)
            mean = np.floor(half.astype(np.float64) + 2 ** 23).astype(
                np.int64) - 2 ** 23
            blur = win[:, 5:rows + 5, STRIP_HALO:STRIP_HALO + STRIP_W]
            tw = min(STRIP_W, w - s0)
            for out, bound in zip(outs, bounds):
                # a 16-bit lane of blur + rule - mean: bit 15 set where
                # blur - mean > bound
                lane = blur + (0x8100 - min(max(257 + bound, 0), 512)) - mean
                assert lane.min() >= 0x7E01 and lane.max() <= 0x81FF
                keep = (((lane >> 15) & 1) == 1) != dark
                out[:, y0:y0 + rows, s0:s0 + tw] = \
                    (keep & valid[:, None, None])[:, :, :tw]
            lanes = ext[:, y0 - first + 1:y0 - first + 1 + rows, :, 1:5]
            gray_out[:, y0:y0 + rows, s0:s0 + tw] = lanes.reshape(
                n, rows, 4 * 32)[:, :, STRIP_HALO:STRIP_HALO + tw]
    return outs[0], outs[1] if len(outs) > 1 else None, gray_out


@pytest.mark.parametrize('shape', [(1, 1, 1), (3, 7, 5), (2, 70, 150)])
def test_adaptive_mean_tiled_design_matches_plain(rng, shape):
    """The kernel's tiles and clamped halo give the plain version's bits
    (in- and wide-range values)."""
    for span in ((0, 256), WIDE):
        img = torch.from_numpy(rng.integers(*span, shape).astype(np.int32))
        assert torch.equal(_tiled_mean(img),
                           pp.adaptive_gaussian_mean_plain(img))


def test_adaptive_mean_wrapper_on_cpu(rng):
    """A CPU tensor goes to the plain version and launches nothing; what the
    kernel does not take raises ValueError on any device."""
    img = torch.from_numpy(rng.integers(0, 256, (3, 40, 70)).astype(np.int32))
    pp.adaptive_gaussian_mean.launches = 0
    assert torch.equal(pp.adaptive_gaussian_mean(img),
                       pp.adaptive_gaussian_mean_plain(img))
    assert pp.adaptive_gaussian_mean.launches == 0
    for bad in (img.to(torch.int64), img.transpose(1, 2), img[0]):
        with pytest.raises(ValueError):
            pp.adaptive_gaussian_mean(bad)
    assert pp.adaptive_gaussian_mean.launches == 0


@pytest.mark.cuda
def test_adaptive_mean_kernel_matches_plain_on_cuda(rng):
    """The kernel of csrc/adaptive_mean.cu against the plain version on the
    card, bit for bit, on the edge shapes, on values in +-70,000 and on a
    seeded 64 x 922 x 1228 batch; one launch counted per call. Runs on a
    machine with an NVIDIA GPU (see README)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    dev = torch.device('cuda')
    cases = [(s, (0, 256)) for s in EDGE_MEAN_SHAPES + [(64, 922, 1228)]]
    cases += [(s, WIDE) for s in EDGE_MEAN_SHAPES]
    for shape, span in cases:
        img = torch.from_numpy(
            rng.integers(*span, shape).astype(np.int32)).to(dev)
        pp.adaptive_gaussian_mean.launches = 0
        got = pp.adaptive_gaussian_mean(img)
        assert pp.adaptive_gaussian_mean.launches == 1
        want = pp.adaptive_gaussian_mean_plain(img)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == img.shape
        assert torch.equal(got, want), (shape, span)


#: frames of the fused pass: crossing the kernel's bands and strips, 2
#: rows, 2 columns, one row, one column, one pixel, W % 4 != 0 (its
#: byte-wise loads and stores); one row past a band (BAND_MAX + 1) with a
#: strip and one 4-column lane group (the word path), two bands and a row
#: with one column past a strip (the byte path at the strip's edge), one
#: band of two strips and 2 columns
MASK_SHAPES = [(3, 70, 133), (3, 2, 130), (3, 67, 2), (2, 130, 260),
               (3, 1, 130), (3, 67, 1), (3, 1, 1), (2, 65, 116),
               (2, 129, 113), (2, 64, 226)]
#: (offset, double threshold delta): fractional offsets on both sides of
#: the ceil and floor edges
MASK_OFFSETS = [(2.5, 1.25), (-1.5, 2.0), (5, 0.5)]
#: the batch's frame_valid: a padding frame in the middle
MASK_VALID = np.array([True, False, True])


def _bgr(rng, shape):
    return rng.integers(0, 256, shape + (3,), dtype=np.uint8)


def _jax_masks(bgr, valid, mode, c_offset, double_delta, white):
    """The JAX package's chain: jitted prepare_batch, jitted detect_masks,
    & frame_valid."""
    gray, blurred = jax.jit(jdet.prepare_batch)(bgr)
    mask, markers = jax.jit(jpp.detect_masks, static_argnums=(1, 2, 3, 4))(
        blurred, mode, c_offset, double_delta, white)
    fv = valid[:, None, None]
    return (np.asarray(mask) & fv,
            None if markers is None else np.asarray(markers) & fv,
            np.asarray(gray))


@pytest.mark.parametrize('shape', MASK_SHAPES)
@pytest.mark.parametrize('mode,white', [('adaptive_double', True),
                                        ('adaptive_double', False),
                                        ('adaptive', True),
                                        ('adaptive', False)])
def test_adaptive_masks_plain_matches_jitted_jax(rng, shape, mode, white):
    """Mask, markers and gray of the fused pass's plain version, bit for
    bit against the jitted JAX chain, on a batch with a padding frame."""
    bgr = _bgr(rng, shape)
    valid = MASK_VALID[:shape[0]]
    for c_offset, delta in MASK_OFFSETS:
        mask, markers, gray = pp.adaptive_masks_from_bgr_plain(
            torch.from_numpy(bgr), torch.from_numpy(valid), mode, c_offset,
            delta, white, want_gray=True)
        want = _jax_masks(bgr, valid, mode, c_offset, delta, white)
        assert mask.dtype == torch.bool and gray.dtype == torch.int32
        np.testing.assert_array_equal(_np(mask), want[0])
        assert (markers is None) == (want[1] is None)
        if markers is not None:
            np.testing.assert_array_equal(_np(markers), want[1])
        np.testing.assert_array_equal(_np(gray), want[2])
        np.testing.assert_array_equal(
            _np(gray), np.asarray(jax.jit(jpp.bgr_to_gray)(bgr)))


@pytest.mark.parametrize('shape', MASK_SHAPES)
def test_adaptive_masks_tiled_design_matches_plain(rng, shape):
    """The fused kernel's bands and strips, its lanes' gray words and
    neighbour columns, the clamped window rows and edge columns and its
    chains give the plain version's bits, both rules, white and dark, a
    padding frame; W % 4 == 0 frames on the byte path too."""
    bgr = _bgr(rng, shape)
    valid = MASK_VALID[:shape[0]]
    for mode, white in (('adaptive_double', True), ('adaptive_double', False),
                        ('adaptive', True)):
        for c_offset, delta in MASK_OFFSETS:
            want = pp.adaptive_masks_from_bgr_plain(
                torch.from_numpy(bgr), torch.from_numpy(valid), mode,
                c_offset, delta, white, want_gray=True)
            for words in {shape[2] % 4 == 0, False}:
                got = _tiled_masks(bgr, valid, mode, c_offset, delta, white,
                                   words)
                for g, w in zip(got, want):
                    assert (g is None) == (w is None)
                    if g is not None:
                        np.testing.assert_array_equal(g, _np(w))


def _byte(x, i):
    return (x >> np.uint32(8 * i)) & np.uint32(255)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays."""
    src = [_byte(x, i) for i in range(4)] + [_byte(y, i) for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
               for i in range(4)).astype(np.uint32)


def _dp2a(a, b, c, hi):
    """CUDA's unsigned __dp2a_lo / __dp2a_hi: the two 16-bit halves of a
    times bytes 0-1 (lo) or 2-3 (hi) of b, plus c."""
    a = np.uint32(a)
    return (c + (a & np.uint32(0xFFFF)) * _byte(b, 2 * hi) +
            (a >> np.uint32(16)) * _byte(b, 2 * hi + 1)).astype(np.uint32)


def test_adaptive_masks_packed_arithmetic():
    """The kernel's packed integer steps against the plain arithmetic: the
    gray of four pixels from three BGR words by eight dot products (seeded
    and extreme B, G, R values in each of the four pixel slots), the
    [1 2 1] blur in
    16-bit lanes turned to float32 under the exponent of 2^23 (seeded
    windows and all-255 ones), and the rule fl(acc + 0.5) < blur - bound
    for floor(fl(acc + 0.5)) < blur - bound at every float32 acc within
    2^11 ulps of each half-integer in [0, 256) and at seeded ones. The
    shortcut acc < blur - (bound + 0.5) is not the same: at acc =
    0.49999997, acc + 0.5 rounds to 1. The fused pass's own steps: the
    gray's [1 2 1] in 16-bit lanes from a lane's word and its neighbours'
    edge bytes (funnel shifts), the reflect-101 words at the frame's
    edges, the mean as the low byte of (acc + 0.5) + 2^23 rounded down,
    and the rules in 16-bit lanes for every blur, mean and bound."""
    rng = np.random.default_rng(7)
    corners = np.stack(np.meshgrid(*[[0, 1, 254, 255]] * 3, indexing='ij'),
                       -1).reshape(-1, 3)
    bgr = np.concatenate([corners, rng.integers(0, 256, (1 << 16, 3))]
                         ).astype(np.uint32)
    want = (bgr[:, 0] * 3735 + bgr[:, 1] * 19235 + bgr[:, 2] * 9798 +
            16384) >> 15
    for slot in range(4):
        px = rng.integers(0, 256, (len(bgr), 12)).astype(np.uint32)
        px[:, 3 * slot:3 * slot + 3] = bgr
        p, q, r = (sum(px[:, 4 * i + j] << np.uint32(8 * j)
                       for j in range(4)).astype(np.uint32)
                   for i in range(3))
        kbg, kr = 7470 | 38470 << 16, 19596
        kb, kgr = 7470 << 16, 38470 | 19596 << 16
        g2 = [_dp2a(kr, p, _dp2a(kbg, p, 32768, 0), 1),
              _dp2a(kgr, q, _dp2a(kb, p, 32768, 1), 0),
              _dp2a(kr, r, _dp2a(kbg, q, 32768, 1), 0),
              _dp2a(kgr, r, _dp2a(kb, r, 32768, 0), 1)]
        word = _byte_perm(_byte_perm(g2[0], g2[1], 0x0062),
                          _byte_perm(g2[2], g2[3], 0x0062), 0x5410)
        np.testing.assert_array_equal(_byte(word, slot), want)
        np.testing.assert_array_equal(g2[slot] >> np.uint32(16), want)
    gray = rng.integers(0, 256, (1 << 16, 3, 8)).astype(np.uint32)
    gray[:1000] = 255
    words = [sum(gray[:, :, 4 * i + j] << np.uint32(8 * j)
                 for j in range(4)).astype(np.uint32) for i in range(2)]
    lo, hi = words
    wide = lo.astype(np.uint64) | hi.astype(np.uint64) << np.uint64(32)
    p = (wide >> np.uint64(16)).astype(np.uint32)
    q = (wide >> np.uint64(24)).astype(np.uint32)
    zero = np.zeros_like(lo)
    lanes = {}
    for name, sel in (('even', 0x4240), ('odd', 0x4341)):
        hs = (_byte_perm(p, zero, sel) + 2 * _byte_perm(q, zero, sel) +
              _byte_perm(hi, zero, sel))
        lanes[name] = (((hs[:, 0] + 2 * hs[:, 1] + hs[:, 2] + 0x00080008)
                        >> np.uint32(4)) & np.uint32(0x0FFF0FFF))
    magic = np.full(len(lo), 0x4B000000, np.uint32)
    got = np.stack([_byte_perm(lanes[lane], magic, sel).view(np.float32) -
                    np.float32(8388608.0)
                    for lane, sel in (('even', 0x7650), ('odd', 0x7650),
                                      ('even', 0x7652), ('odd', 0x7652))], 1)
    rows = gray[:, :, 2:6] + 2 * gray[:, :, 3:7] + gray[:, :, 4:8]
    s = rows[:, 0] + 2 * rows[:, 1] + rows[:, 2]
    np.testing.assert_array_equal(got, ((4096 * s + 32768) >> 16)
                                  .astype(np.float32))
    near = (np.arange(512, dtype=np.float32) / 2)[:, None].view(np.int32) + \
        np.arange(-(1 << 11), 1 << 11, dtype=np.int32)
    acc = np.concatenate([near.ravel().view(np.float32),
                          rng.uniform(0, 256, 10 ** 6).astype(np.float32)])
    acc = acc[(acc >= 0) & (acc < 256)]
    half = acc + np.float32(0.5)
    for bound in (-7, -3, 0, 2, 5):
        for blur in (0, 1, 127, 128, 200, 255):
            want = np.floor(half) < np.float32(blur - bound)
            got = half < np.float32(blur) - np.float32(bound)
            np.testing.assert_array_equal(got, want)
    tie = np.float32(0.49999997)
    assert np.floor(tie + np.float32(0.5)) == 1 and tie < np.float32(0.5)
    # the fused pass's gray row: a lane's 4 columns in g, column x - 1 in
    # byte 3 of lw and x + 4 in byte 0 of rw (the neighbour lanes' words,
    # their other bytes whatever they hold), by two funnel shifts, [1 2 1]
    # in 16-bit lanes; at the frame's edges g << 16 puts column 1 in byte 3
    # and g >> 16 column w - 2 in byte 0
    g6 = rng.integers(0, 256, (1 << 16, 6)).astype(np.uint32)
    g6[:1000] = 255
    junk = rng.integers(0, 1 << 24, (2, len(g6))).astype(np.uint32)
    g = sum(g6[:, 1 + j] << np.uint32(8 * j) for j in range(4)).astype(
        np.uint32)
    lw = (g6[:, 0] << np.uint32(24)) | junk[0]
    rw = g6[:, 5] | (junk[1] << np.uint32(8))
    zero = np.zeros_like(g)

    def sums121(lw, g, rw):
        left = ((lw.astype(np.uint64) | g.astype(np.uint64) << np.uint64(32))
                >> np.uint64(24)).astype(np.uint32)
        right = ((g.astype(np.uint64) | rw.astype(np.uint64) << np.uint64(32))
                 >> np.uint64(8)).astype(np.uint32)
        return [(_byte_perm(left, zero, sel) + 2 * _byte_perm(g, zero, sel) +
                 _byte_perm(right, zero, sel)).astype(np.uint32)
                for sel in (0x4240, 0x4341)]

    def lanes_of(e, o):
        lo, hi = np.uint32(0xFFFF), np.uint32(16)
        return np.stack([e & lo, o & lo, e >> hi, o >> hi], 1)

    np.testing.assert_array_equal(
        lanes_of(*sums121(lw, g, rw)),
        g6[:, :4] + 2 * g6[:, 1:5] + g6[:, 2:6])
    edge = g6.copy()
    edge[:, 0], edge[:, 5] = g6[:, 2], g6[:, 3]
    np.testing.assert_array_equal(
        lanes_of(*sums121(g << np.uint32(16), g, g >> np.uint32(16))),
        edge[:, :4] + 2 * edge[:, 1:5] + edge[:, 2:6])
    # the fused pass's rules: mean = floor(acc + 0.5) as the low byte of
    # (acc + 0.5) + 2^23 rounded down, at the accs near half-integers above
    # (a mean of bytes: acc + 0.5 < 256)
    half = half[half < 256]
    exact = half.astype(np.float64) + 2 ** 23
    down = exact.astype(np.float32)
    down = np.where(down.astype(np.float64) > exact,
                    np.nextafter(down, np.float32(-np.inf)), down)
    bits = down.view(np.uint32)
    assert np.all(bits >> np.uint32(8) == np.uint32(0x4B0000))
    np.testing.assert_array_equal(bits & np.uint32(255), np.floor(half))
    # then per 16-bit lane (columns x and x + 2 in the even word, x + 1 and
    # x + 3 in the odd one) blur + (0x8100 - T) - mean, T = 257 + bound
    # clamped to 0 .. 512, has bit 15 set where blur - mean > bound, for
    # every blur, mean and bound; __byte_perm(even, odd, 0x7351) >> 7
    # puts column x + q's bit in byte q
    blur, mean = (v.ravel().astype(np.uint32) for v in np.meshgrid(
        np.arange(256), np.arange(256), indexing='ij'))
    n4 = len(blur) // 4
    b4, m4 = blur.reshape(n4, 4), mean.reshape(n4, 4)
    for bound in (-pp._BOUND_LIMIT, -258, -257, -256, -7, -1, 0, 3, 254, 255,
                  256, pp._BOUND_LIMIT):
        k = np.uint32((0x8100 - min(max(257 + bound, 0), 512)) * 0x00010001)
        even = (b4[:, 0] | b4[:, 2] << np.uint32(16)) + k - \
            (m4[:, 0] | m4[:, 2] << np.uint32(16))
        odd = (b4[:, 1] | b4[:, 3] << np.uint32(16)) + k - \
            (m4[:, 1] | m4[:, 3] << np.uint32(16))
        for v in (even & np.uint32(0xFFFF), even >> np.uint32(16),
                  odd & np.uint32(0xFFFF), odd >> np.uint32(16)):
            assert v.min() >= 0x7E01 and v.max() <= 0x81FF
        word = (_byte_perm(even, odd, 0x7351) >> np.uint32(7)) & \
            np.uint32(0x01010101)
        want = b4.astype(np.int64) - m4 > bound
        np.testing.assert_array_equal(
            np.stack([_byte(word, q) for q in range(4)], 1), want)


def test_adaptive_masks_wrapper_on_cpu(rng):
    """A CPU tensor goes to the plain version and launches nothing; what
    the kernel does not take raises ValueError on any device, and mean
    mode raises."""
    bgr = torch.from_numpy(_bgr(rng, (3, 40, 70)))
    valid = torch.from_numpy(MASK_VALID)
    pp.adaptive_masks_from_bgr.launches = 0
    for mode in ('adaptive', 'adaptive_double'):
        for want_gray in (False, True):
            got = pp.adaptive_masks_from_bgr(bgr, valid, mode, 5, 2.0, True,
                                             want_gray=want_gray)
            want = pp.adaptive_masks_from_bgr_plain(bgr, valid, mode, 5, 2.0,
                                                    True, want_gray)
            assert (got[1] is None) == (mode == 'adaptive')
            assert (got[2] is None) != want_gray
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w)
    assert pp.adaptive_masks_from_bgr.launches == 0
    meta = torch.empty((1, 4, 4, 3), dtype=torch.uint8, device='meta')
    bad = [
        (bgr, valid, 'mean'),
        (bgr.to(torch.int32), valid, 'adaptive'),
        (bgr[..., :2].contiguous(), valid, 'adaptive'),
        (bgr[0], valid[:1], 'adaptive'),
        (bgr.transpose(1, 2), valid, 'adaptive'),
        (bgr, valid.to(torch.uint8), 'adaptive'),
        (bgr, valid[:2], 'adaptive'),
        (bgr, torch.ones(6, dtype=torch.bool)[::2], 'adaptive'),
        (meta, torch.ones(1, dtype=torch.bool, device='meta'), 'adaptive'),
        (meta, torch.ones(1, dtype=torch.bool), 'adaptive')]
    for frames, fv, mode in bad:
        with pytest.raises(ValueError):
            pp.adaptive_masks_from_bgr(frames, fv, mode, 5, 2.0, True)
    assert pp.adaptive_masks_from_bgr.launches == 0


def test_one_pixel_axis_blur_matches_jax(rng):
    """blur3's reflect-101 border on an axis of one pixel reflects onto the
    pixel itself, as jnp.pad's reflect does: the same shape and bits."""
    for shape in ((1, 1, 5), (1, 5, 1), (2, 1, 1), (1, 2, 1)):
        g = rng.integers(0, 256, shape).astype(np.int32)
        np.testing.assert_array_equal(
            _np(pp.blur3(torch.from_numpy(g))),
            np.asarray(jax.jit(jpp.blur3)(g)))


def _cuda_masks_cases(rng):
    """(bgr, valid) batches of the cuda twins: the CPU tests' shapes, a
    W % 4 != 0 frame at full size and the bench batch's shape."""
    out = [(_bgr(rng, s), MASK_VALID[:s[0]]) for s in MASK_SHAPES]
    out.append((_bgr(rng, (2, 921, 1227)), np.array([False, True])))
    out.append((_bgr(rng, (64, 922, 1228)), np.arange(64) < 61))
    return out


@pytest.mark.cuda
def test_adaptive_masks_kernel_matches_plain_on_cuda(rng):
    """csrc/adaptive_mean.cu's ysmr_adaptive_masks against the plain
    version on the card, bit for bit: the CPU tests' shapes, modes, rules
    and offsets (and so the tile design's cases), a 921 x 1227 batch
    (byte-wise loads and stores) and a padded 64 x 922 x 1228 batch, with
    and without the gray; one launch counted per call. Runs on a machine
    with an NVIDIA GPU (see README)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    dev = torch.device('cuda')
    for bgr_np, valid_np in _cuda_masks_cases(rng):
        bgr = torch.from_numpy(bgr_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        for mode, white in (('adaptive_double', True),
                            ('adaptive_double', False), ('adaptive', True),
                            ('adaptive', False)):
            for (c_offset, delta), want_gray in zip(MASK_OFFSETS,
                                                    (True, False, True)):
                pp.adaptive_masks_from_bgr.launches = 0
                got = pp.adaptive_masks_from_bgr(bgr, valid, mode, c_offset,
                                                 delta, white, want_gray)
                assert pp.adaptive_masks_from_bgr.launches == 1
                want = pp.adaptive_masks_from_bgr_plain(
                    bgr, valid, mode, c_offset, delta, white, want_gray)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert (g is None) == (w is None)
                    if g is not None:
                        assert g.dtype == w.dtype and torch.equal(g, w), (
                            bgr.shape, mode, white, c_offset)


@pytest.mark.cuda
def test_adaptive_masks_tiled_design_matches_kernel_on_cuda(rng):
    """The numpy emulation of the tile design against the kernel on the
    card on the tile-crossing shapes (the twin of the CPU design test)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    dev = torch.device('cuda')
    for shape in MASK_SHAPES:
        bgr = _bgr(rng, shape)
        valid = MASK_VALID[:shape[0]]
        for c_offset, delta in MASK_OFFSETS:
            want = _tiled_masks(bgr, valid, 'adaptive_double', c_offset,
                                delta, False)
            got = pp.adaptive_masks_from_bgr(
                torch.from_numpy(bgr).to(dev),
                torch.from_numpy(valid).to(dev), 'adaptive_double',
                c_offset, delta, False, want_gray=True)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.cpu().numpy(), w)


@pytest.mark.parametrize('c_offset', [-7.0, -5.0, -2.5, 0.0, 3.0, 5.0, 7.5])
@pytest.mark.parametrize('white', [True, False])
def test_adaptive_threshold_matches_jax_and_cv2(rng, c_offset, white):
    img = rng.integers(0, 256, (61, 83), dtype=np.uint8)
    ttype = cv2.THRESH_BINARY if white else cv2.THRESH_BINARY_INV
    ref = cv2.adaptiveThreshold(img, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                ttype, 11, c_offset) > 0
    ours = _np(pp.adaptive_threshold(
        torch.from_numpy(img.astype(np.int32))[None], c_offset, white))[0]
    np.testing.assert_array_equal(ours, ref)
    jfn = jax.jit(jpp.adaptive_threshold, static_argnums=(1, 2))
    np.testing.assert_array_equal(
        ours, np.asarray(jfn(img.astype(np.int32), c_offset, white)))


def test_adaptive_threshold_fullsize_matches_jax_and_cv2(rng):
    img = rng.integers(0, 256, (922, 1228), dtype=np.uint8)
    ref = cv2.adaptiveThreshold(img, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                cv2.THRESH_BINARY, 11, -5.0) > 0
    ours = _np(pp.adaptive_threshold(
        torch.from_numpy(img.astype(np.int32))[None], -5.0, True))[0]
    np.testing.assert_array_equal(ours, ref)
    jfn = jax.jit(jpp.adaptive_threshold, static_argnums=(1, 2))
    np.testing.assert_array_equal(
        ours, np.asarray(jfn(img.astype(np.int32), -5.0, True)))


def test_global_threshold_matches_jax_and_cv2(rng):
    img = rng.integers(0, 256, (4, 61, 83), dtype=np.uint8)
    thr = np.array([-3, 0, 100, 254], np.int32)
    for white, ttype in ((True, cv2.THRESH_BINARY),
                         (False, cv2.THRESH_BINARY_INV)):
        ours = _np(pp.global_threshold(torch.from_numpy(img.astype(np.int32)),
                                       torch.from_numpy(thr), white))
        np.testing.assert_array_equal(ours, np.asarray(
            jpp.global_threshold(img.astype(np.int32), thr, white)))
        for i, t in enumerate(thr):
            np.testing.assert_array_equal(
                ours[i], cv2.threshold(img[i], int(t), 255, ttype)[1] > 0)


def test_mean_std_sums_match_jax_and_cv2(rng):
    img = rng.integers(0, 256, (2, 97, 113), dtype=np.uint8)
    ours = pp.frame_mean_std_sums(torch.from_numpy(img.astype(np.int32)))
    ref = jax.jit(jpp.frame_mean_std_sums)(img.astype(np.int32))
    for a, b in zip(ours, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    mean, std = pp.combine_mean_std(97 * 113, *(_np(a) for a in ours))
    for i in range(2):
        m_ref, s_ref = cv2.meanStdDev(img[i])
        assert mean[i] == pytest.approx(m_ref.item(), abs=1e-9)
        assert std[i] == pytest.approx(s_ref.item(), abs=1e-9)


@pytest.mark.parametrize('mode,white', [('adaptive_double', True),
                                        ('adaptive', False),
                                        ('mean', True)])
def test_detect_masks_match_jitted_jax(rng, mode, white):
    """Mask and markers of every mode, bit for bit against JAX's
    detect_masks jitted as in detect_from_blurred."""
    img = rng.integers(0, 256, (3, 61, 83)).astype(np.int32)
    thr = np.array([90, 128, 200], np.int32)
    ours = pp.detect_masks(torch.from_numpy(img), mode, 5, 2.0, white,
                           global_thresholds=torch.from_numpy(thr))
    ref = jax.jit(jpp.detect_masks, static_argnums=(1, 2, 3, 4))(
        img, mode, 5, 2.0, white, global_thresholds=thr)
    for a, b in zip(ours, ref):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(_np(a), np.asarray(b))
