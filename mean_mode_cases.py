"""Seeded inputs of mean-threshold mode's preprocess and masks
(``ysmr_tpu_torch/ops/preprocess.py::mean_prepare_from_bgr`` and
``mean_masks``, the kernels ``ysmr_mean_prepare`` and ``ysmr_mean_masks``
of ``csrc/adaptive_mean.cu``) and numpy models of the two kernels'
designs, with numpy only. The tests (``tests/test_torch_mean_mode.py``
and its cuda twin) and ``chip_smoke.py`` (the mean-threshold phase) share
them.
"""

import numpy as np

#: (N, H, W) batches: a batch of frames crossing the prepare kernel's 30-row
#: bands and 128-column strips, one pixel, one row, one column
SHAPES = ((64, 97, 131), (3, 1, 1), (3, 1, 130), (3, 67, 1))
#: (N, H, W) batches the kernels split unevenly besides those: W % 4 != 0
#: (byte-wise loads and stores), frames under 16 pixels (several frames in
#: one 16-byte span of the masks), planes no multiple of 16 (8 mod 16:
#: 5 x 8 x 41; 1 mod 16: 4 x 17 x 17), a height one row past a band
#: (2 x 31 x 200), the bench width (ten strips, the last partial) over two
#: bands and a row, and rows over 274 strips whose sums of squares wrap in
#: int32 where the gray is 250 or more (2 x 3 x 35000)
EDGE_SHAPES = ((2, 130, 261), (7, 3, 5), (5, 13, 23), (2, 2, 2),
               (5, 8, 41), (4, 17, 17), (2, 31, 200), (3, 61, 1228),
               (2, 3, 35000))
#: thresholds at and beyond the uint8 range (any int32 is taken)
THRESHOLDS = (0, 255, -1, 256, -70000, 70000, 1, 254, 128)
#: a frame of 255s whose row sum of squares (40,000 x 65,025) wraps in
#: int32, as JAX's sum does
WRAP_SHAPE = (1, 1, 40000)

#: the prepare kernel's warp tile: a band of rows of a strip of columns,
#: 4 columns a lane
BAND, STRIP_W, LANES = 30, 128, 32


def bgr_frames(rng, shape):
    """Seeded BGR uint8 frames of an (N, H, W) shape."""
    return rng.integers(0, 256, tuple(shape) + (3,), dtype=np.uint8)


def wrap_frames():
    """The WRAP_SHAPE batch of white BGR pixels (gray 255)."""
    return np.full(WRAP_SHAPE + (3,), 255, np.uint8)


def frame_thresholds(rng, n):
    """(N,) int32 thresholds: THRESHOLDS first, then seeded values."""
    out = rng.integers(-300, 560, n).astype(np.int32)
    k = min(n, len(THRESHOLDS))
    out[:k] = THRESHOLDS[:k]
    return out


def padded_valid(n):
    """frame_valid of a short batch: its last third are padding frames (at
    least one, where there are two frames)."""
    return np.arange(n) < n - max(n // 3, 1 if n > 1 else 0)


def gapped_valid(n):
    """frame_valid with padding frames between valid ones: every third
    frame from the second on is invalid."""
    return np.arange(n) % 3 != 1


def _gray2(b, g, r):
    """gray2_of: twice the gray's fixed-point sum, the gray in byte 2."""
    return (b.astype(np.uint32) * 7470 + g.astype(np.uint32) * 38470 +
            r.astype(np.uint32) * 19596 + 32768)


def _dp2a(coef, word, acc, hi):
    """CUDA's __dp2a_lo (hi False: bytes 0-1 of word) or __dp2a_hi (bytes
    2-3) against the two 16-bit halves of coef, plus acc, in uint32."""
    sh = 16 if hi else 0
    b0 = (word >> np.uint32(sh)) & np.uint32(0xFF)
    b1 = (word >> np.uint32(sh + 8)) & np.uint32(0xFF)
    return acc + b0 * np.uint32(coef & 0xFFFF) + b1 * np.uint32(coef >> 16)


def _reflect101(v, n):
    v = np.where(v < 0, -v, np.where(v >= n, 2 * n - 2 - v, v))
    return np.clip(v, 0, n - 1)


def _lanes16(v, odd):
    """Bytes 0 and 2 (odd False) or 1 and 3 of v as 16-bit lanes."""
    v = v >> np.uint32(8) if odd else v
    return v & np.uint32(0x00FF00FF)


def _row_words(bgr_row, w, x):
    """Of one BGR row (W, 3) uint8 and the lanes' first columns x: each
    lane's gray word (4 gray bytes of columns x .. x + 3), its gray2_of
    values (4, lanes) and the gray of columns x - 1 and x + 4 as the
    prepare kernel forms them. With W % 4 == 0 the words path: the three
    BGR words of the lane, the neighbours' words by __shfl within a warp
    of 32 lanes, lane 0's word ending with pixel x - 1 and lane 31's word
    starting with pixel x + 4 read as words and dotted with that layout's
    coefficients, reflect-101 at x == 0 and x + 4 == W; else every pixel
    through reflect-101, one byte at a time."""
    kbg, kr = 7470 | 38470 << 16, 19596
    kb, kgr = 7470 << 16, 38470 | 19596 << 16
    flat = np.zeros(3 * w + 16, np.uint8)
    flat[:3 * w] = bgr_row.reshape(-1)
    words = flat[:(3 * w + 16) // 4 * 4].view('<u4')
    lane = (x // 4) % LANES
    if w % 4:
        g2 = np.stack([_gray2(*bgr_row[_reflect101(x + j, w)].T)
                       for j in range(-1, 5)])
        gray = (g2 >> np.uint32(16)) & np.uint32(0xFF)
        return g2[1:5], gray[0], gray[5]
    inside = x < w
    wd = [np.where(inside, words[np.minimum(3 * x // 4 + k, len(words) - 1)],
                   np.uint32(0)) for k in range(3)]
    p, q, r = wd
    m = np.uint32(32768)
    g2 = np.stack([_dp2a(kr, p, _dp2a(kbg, p, m, False), True),
                   _dp2a(kgr, q, _dp2a(kb, p, m, True), False),
                   _dp2a(kr, r, _dp2a(kbg, q, m, True), False),
                   _dp2a(kgr, r, _dp2a(kb, r, m, False), True)])
    gray = (g2 >> np.uint32(16)) & np.uint32(0xFF)
    # the lane's left and right neighbours within the warp (__shfl_up /
    # __shfl_down: the warp's edge lanes get their own value)
    prev = np.where(lane > 0, np.roll(gray[3], 1), gray[3])
    nxt = np.where(lane < LANES - 1, np.roll(gray[0], -1), gray[0])
    # the edge lanes' extra word and its gray
    left_word = words[np.clip(3 * x // 4 - 1, 0, len(words) - 1)]
    right_word = words[np.minimum(3 * x // 4 + 3, len(words) - 1)]
    eg_left = _dp2a(kgr, left_word, _dp2a(kb, left_word, m, False), True)
    eg_right = _dp2a(kr, right_word, _dp2a(kbg, right_word, m, False), True)
    left = np.where(lane == 0, (eg_left >> np.uint32(16)) & 0xFF, prev)
    right = np.where(lane == LANES - 1, (eg_right >> np.uint32(16)) & 0xFF,
                     nxt)
    left = np.where(x == 0, gray[1], left)
    right = np.where(x + 4 >= w, gray[2], right)
    return g2, left.astype(np.uint32), right.astype(np.uint32)


def _gray_word(g2):
    """The 4 gray bytes of gray2_of values (4, lanes) as one word a lane."""
    gray = (g2 >> np.uint32(16)) & np.uint32(0xFF)
    return gray[0] | gray[1] << np.uint32(8) | gray[2] << np.uint32(16) | \
        gray[3] << np.uint32(24)


def blur_design(bgr):
    """The blurred (H, W) uint8 frame of one BGR (H, W, 3) uint8 frame as
    ysmr_mean_prepare forms it: lanes of 4 columns (``_row_words``), each
    window row's [1 2 1] in 16-bit lanes of the words x - 1 .. x + 2,
    x .. x + 3 and x + 1 .. x + 4 (``__funnelshift_r`` of the neighbour
    bytes), three rows' sums (rows reflect-101) to (S + 8) >> 4 in the same
    lanes, packed by ``__byte_perm(even, odd, 0x6240)``."""
    h, w = bgr.shape[:2]
    x = np.arange(0, -(-w // STRIP_W) * STRIP_W, 4)
    sums = []
    for y in range(-1, h + 1):
        g2, left, right = _row_words(bgr[_reflect101(np.array(y), h)], w, x)
        g = _gray_word(g2)
        lw = left << np.uint32(24)
        lo = (lw >> np.uint32(24)) | (g << np.uint32(8))    # x - 1 .. x + 2
        hi = (g >> np.uint32(8)) | (right << np.uint32(24))  # x + 1 .. x + 4
        sums.append([_lanes16(lo, o) + np.uint32(2) * _lanes16(g, o) +
                     _lanes16(hi, o) for o in (False, True)])
    out = np.zeros((h, len(x) * 4), np.uint8)
    for y in range(h):
        be, bo = [((sums[y][o] + np.uint32(2) * sums[y + 1][o] +
                    sums[y + 2][o] + np.uint32(0x00080008)) >> np.uint32(4))
                  & np.uint32(0x0FFF0FFF) for o in (0, 1)]
        word = (be & 0xFF) | (bo & 0xFF) << np.uint32(8) | \
            ((be >> np.uint32(16)) & 0xFF) << np.uint32(16) | \
            ((bo >> np.uint32(16)) & 0xFF) << np.uint32(24)
        out[y] = word.astype('<u4').view(np.uint8)
    return out[:, :w]


def prepare_sums_design(gray, rng):
    """The (N, 3) int32 sums [total, hi, lo] as ysmr_mean_prepare forms
    them from (N, H, W) gray values: a warp a tile of BAND rows and
    STRIP_W columns, lane l on the columns 4 l .. 4 l + 3 (bytes outside
    the frame masked to 0); each lane adds its gray (``__dp4a``), each
    row's squares (``__dp4a``) summed over the warp
    (``__reduce_add_sync``), all in uint32. The tiles finish in ``rng``'s
    order: each adds its rows' sums to the frame's row table and its total
    to the frame's sums by atomics, then takes a ticket; the tile with the
    last ticket reads the table, splits each whole row sum as an int32 into
    hi (>> 16) and lo (& 0xFFFF) and writes their uint32 sums."""
    n, h, w = gray.shape
    bands, strips = -(-h // BAND), -(-w // STRIP_W)
    g = np.zeros((n, bands * BAND, strips * STRIP_W), np.uint32)
    g[:, :h, :w] = gray
    # (frame, band, row, strip, lane, byte)
    g = g.reshape(n, bands, BAND, strips, LANES, 4)
    lane_sq = (g * g).sum(axis=-1, dtype=np.uint32)
    tile_rows = lane_sq.sum(axis=4, dtype=np.uint32)   # (n, b, row, strip)
    tile_total = g.sum(axis=(2, 5), dtype=np.uint32).sum(axis=-1,
                                                         dtype=np.uint32)
    sums = np.zeros((n, 3), np.uint32)
    for f in range(n):
        table = np.zeros(bands * BAND, np.uint32)
        tiles = [(b, s) for b in range(bands) for s in range(strips)]
        for ticket, k in enumerate(rng.permutation(len(tiles))):
            b, s = tiles[k]
            rows = min(BAND, h - b * BAND)
            table[b * BAND:b * BAND + rows] += tile_rows[f, b, :rows, s]
            sums[f, 0] += tile_total[f, b, s]
            if ticket == len(tiles) - 1:
                row = table[:h].view(np.int32)
                sums[f, 1] = (row >> 16).view(np.uint32).sum(dtype=np.uint32)
                sums[f, 2] = (row & 0xFFFF).view(np.uint32).sum(
                    dtype=np.uint32)
    return sums.view(np.int32)


def _mask_word(v, k, flip, keep):
    """mask_word: byte i is 1 where byte i of v exceeds the threshold
    (v's byte + k carries into bit 8), flipped and kept."""
    even = v & np.uint32(0x00FF00FF)
    odd = (v >> np.uint32(8)) & np.uint32(0x00FF00FF)
    gt = (((even + k) >> np.uint32(8)) & np.uint32(0x00010001)) | \
        ((odd + k) & np.uint32(0x01000100))
    return (gt ^ flip) & keep


def masks_design(blurred, thresholds, valid, white_on_dark, base=0,
                 vec=True):
    """The bool mask as ysmr_mean_masks forms it, the batch starting at
    address ``base`` mod 16: a block row a frame, its threshold and valid
    flag read once; with ``vec`` the frame's head bytes (up to its first
    16-byte boundary) and tail bytes one at a time and its body in 16-byte
    vectors, each a word of 4 bytes at a time (``mask_word``); without,
    every byte alone. An invalid frame reads no byte."""
    n, h, w = blurred.shape
    plane = h * w
    out = np.zeros((n, plane), np.uint8)
    flip = np.uint32(0 if white_on_dark else 0x01010101)
    for f in range(n):
        keep = np.uint32(0x01010101 if valid[f] else 0)
        t = min(max(int(thresholds[f]), -1), 255)
        k = np.uint32((255 - t) * 0x00010001)
        src = blurred[f].reshape(-1) if valid[f] else \
            np.zeros(plane, np.uint8)
        head = min((16 - (base + f * plane) % 16) % 16, plane) if vec \
            else plane
        nv = (plane - head) // 16
        for i in list(range(head)) + list(range(head + 16 * nv, plane)):
            out[f, i] = _mask_word(np.uint32(src[i]), k, flip, keep) & 1
        body = src[head:head + 16 * nv].copy().view('<u4')
        out[f, head:head + 16 * nv] = _mask_word(body, k, flip,
                                                 keep).view(np.uint8)
    return out.reshape(n, h, w).astype(bool)
