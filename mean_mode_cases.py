"""Seeded inputs of mean-threshold mode's preprocess and masks
(``ysmr_tpu_torch/ops/preprocess.py::mean_prepare_from_bgr`` and
``mean_masks``, the kernels ``ysmr_mean_prepare`` and ``ysmr_mean_masks``
of ``csrc/adaptive_mean.cu``) and numpy models of the two kernels'
designs, with numpy only. The tests (``tests/test_torch_mean_mode.py``
and its cuda twin) and ``chip_smoke.py`` (the mean-threshold phase) share
them.
"""

import numpy as np

#: (N, H, W) batches: a batch of frames crossing the prepare kernel's 64 x
#: 128 tiles, one pixel, one row, one column
SHAPES = ((64, 97, 131), (3, 1, 1), (3, 1, 130), (3, 67, 1))
#: (N, H, W) batches the kernels split unevenly besides those: W % 4 != 0
#: (byte-wise loads and stores), frames under 16 pixels (a 16-byte vector
#: of the masks kernel over several frames), a plane no multiple of 16
EDGE_SHAPES = ((2, 130, 261), (7, 3, 5), (5, 13, 23), (2, 2, 2))
#: thresholds at and beyond the uint8 range (any int32 is taken)
THRESHOLDS = (0, 255, -1, 256, -70000, 70000, 1, 254, 128)
#: a frame of 255s whose row sum of squares (40,000 x 65,025) wraps in
#: int32, as JAX's sum does
WRAP_SHAPE = (1, 1, 40000)

TILE_H, TILE_W, STRIP, LANES = 64, 128, 16, 32


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


def _butterfly(v):
    """The warp's __shfl_xor_sync sum over its last axis (32 lanes), in
    uint32: every lane ends with the same wrapped sum."""
    lanes = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v


def prepare_sums_design(gray, rng):
    """The (N, 3) int32 sums [total, hi, lo] as ysmr_mean_prepare forms
    them from (N, H, W) gray values: a block a band of 64 rows, its 128-
    column tiles in turn, warp s on the band's rows 16 s .. 16 s + 15, lane
    l on each tile's columns 4 l .. 4 l + 3 (bytes outside the frame
    masked to 0); each lane adds its gray and each row's squares
    (``__dp4a``) over the tiles in uint32, the warp sums each row over its
    lanes (butterfly), splits the whole row sum as an int32 into hi (>> 16)
    and lo (& 0xFFFF), sums those and its gray; the warps' (total, hi, lo)
    go to their frame by atomics, here in ``rng``'s order."""
    n, h, w = gray.shape
    bands, tiles = -(-h // TILE_H), -(-w // TILE_W)
    g = np.zeros((n, bands * TILE_H, tiles * TILE_W), np.uint32)
    g[:, :h, :w] = gray
    # (frame, band, warp, row, tile, lane, byte)
    g = g.reshape(n, bands, TILE_H // STRIP, STRIP, tiles, LANES, 4)
    # each lane's row sums over the tiles: (frame, band, warp, row, lane)
    row_sq = (g * g).sum(axis=-1, dtype=np.uint32).sum(axis=4,
                                                        dtype=np.uint32)
    row = _butterfly(row_sq)[..., 0].view(np.int32)   # (n, b, warp, row)
    hi = (row >> 16).view(np.uint32).sum(axis=-1, dtype=np.uint32)
    lo = (row & 0xFFFF).view(np.uint32).sum(axis=-1, dtype=np.uint32)
    lane_total = g.sum(axis=(3, 4, 6), dtype=np.uint32)
    total = _butterfly(lane_total)[..., 0]
    warp_rows = np.arange(bands)[:, None] * TILE_H + \
        np.arange(TILE_H // STRIP)[None, :] * STRIP
    sums = np.zeros((n, 3), np.uint32)
    for f in range(n):
        adds = [(total[f, b, s], hi[f, b, s], lo[f, b, s])
                for b, s in zip(*np.nonzero(warp_rows < h))]
        for k in rng.permutation(len(adds)):
            sums[f] += np.array(adds[k], np.uint32)
    return sums.view(np.int32)


def byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of
    the 8 bytes y:x."""
    both = (int(y) << 32) | int(x)
    return sum(((both >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def funnelshift_r(lo, hi, shift):
    """CUDA's __funnelshift_r: the low word of (hi:lo) >> shift."""
    return (((int(hi) << 32) | int(lo)) >> shift) & 0xFFFFFFFF


def blur_row_design(blur_row):
    """One row of the prepare kernel's blurred window (140 values below 256,
    window column c the blur at x0 - 5 + c) as its emit packs it, a 32-bit
    word per 4 columns (``__byte_perm(even, odd, 0x6240)``, even holding
    columns c and c + 2 in its 16-bit lanes, odd c + 1 and c + 3), and the
    bytes each lane l then stores, those of columns 4 l + 5 .. 4 l + 8
    (``__funnelshift_r`` of its words 4 l + 4 and 4 l + 8 by 8): the tile's
    128 blurred bytes."""
    v = [int(b) for b in blur_row]
    words = [byte_perm(v[c] | v[c + 2] << 16, v[c + 1] | v[c + 3] << 16,
                       0x6240) for c in range(0, len(v), 4)]
    out = []
    for lane in range(LANES):
        word = funnelshift_r(words[lane + 1], words[lane + 2], 8)
        out += [(word >> (8 * q)) & 0xFF for q in range(4)]
    return np.array(out, np.uint8)


def masks_design(blurred, thresholds, valid, white_on_dark):
    """The bool mask as ysmr_mean_masks forms it: a thread a 16-byte chunk
    of the flat (N, H, W) array, its frame found from its first byte and
    advanced where a byte passes the frame's end."""
    n, h, w = blurred.shape
    flat = blurred.reshape(-1)
    plane, total = h * w, flat.size
    out = np.zeros(total, bool)
    for i0 in range(0, total, 16):
        f = i0 // plane
        nxt = (f + 1) * plane
        for i in range(i0, min(i0 + 16, total)):
            while i >= nxt:
                f += 1
                nxt += plane
            out[i] = bool(valid[f]) and \
                ((int(flat[i]) > int(thresholds[f])) != (not white_on_dark))
    return out.reshape(n, h, w)
