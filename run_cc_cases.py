"""Seeded run wires of the run-graph connected components
(``ysmr_tpu_torch/ops/run_cc.py``, the kernels ``csrc/run_cc.cu``): masks
with markers encoded as the pipeline's run wire, with numpy and the port's
numpy encoder only. The tests (``tests/test_torch_run_cc.py`` and its cuda
twin) and ``chip_smoke.py`` (phase 33) share them.
"""

import numpy as np
from scipy import ndimage

from ysmr_tpu_torch.native import encode_runs_numpy

#: the seeded cases: random blobs with an empty frame; the same with the
#: slots past each frame's count holding stale runs and random words (the
#: pipeline reuses its wire buffer) and a padded frame; a frame that fills
#: the table (windows that reach past its end); runs at x = 0 and w - 1 and
#: full rows; frames of one row; no markers; every pixel a marker; frames
#: one and two pixels wide; runs of length 0 below the counts and runs out
#: of raster order (both outside the encoder's contract)
CASES = ('blobs', 'stale_padding', 'full_table', 'edges', 'one_row',
         'no_markers', 'all_markers', 'one_column', 'two_columns',
         'zero_length', 'unordered')
#: the cases the encoder can write
WIRE_CASES = CASES[:-2]
#: the isolated pixels of a frame of ``many_components``: a count above
#: int16's range
MANY_COMPONENTS = 160 * 256


def encode_frames(img, marker, r=None):
    """(T, H, W) bool mask and marker -> ((T, R) uint32 run wire, (T,)
    int32 run counts); R the next power of two of the longest frame's
    runs unless given."""
    t, h, w = img.shape
    f = max(int(img.reshape(t, -1).sum(1).max()), 4)
    packed = np.zeros((t, f), np.uint32)
    counts = np.zeros(t, np.int32)
    for i in range(t):
        yy, xx = np.nonzero(img[i])
        lin = (yy * w + xx).astype(np.uint32)
        mk = marker[i][yy, xx].astype(np.uint32)
        packed[i, :len(lin)] = lin | (mk << 31)
        counts[i] = len(lin)
    cap = f if r is None else r
    runs = np.zeros((t, cap), np.uint32)
    rcnt = np.zeros(t, np.int32)
    ret = encode_runs_numpy(packed, counts, runs, rcnt, w=w)
    if ret < 0:
        raise ValueError('run encoding failed ({})'.format(ret))
    if r is None:
        r = 1 << max(int(ret) - 1, 1).bit_length()
    return runs[:, :r].copy(), rcnt


def _blobs(rng, t, h, w, p=0.03, marker_p=0.3):
    img = ndimage.binary_dilation(
        rng.random((t, h, w)) < p, structure=np.ones((1, 3, 3)),
        iterations=1) & (rng.random((t, h, w)) < 0.85)
    return img, img & (rng.random((t, h, w)) < marker_p)


def run_case(name, seed=0):
    """(runs (T, R) uint32, counts (T,) int32, w) of a seeded case."""
    rng = np.random.default_rng(seed)
    if name in ('blobs', 'stale_padding', 'no_markers', 'all_markers'):
        img, marker = _blobs(rng, 4, 40, 67)
        img[2] = False                       # an empty frame
        marker[2] = False
        if name == 'no_markers':
            marker[:] = False
        elif name == 'all_markers':
            marker = img.copy()
        runs, counts = encode_frames(img, marker)
        if name == 'stale_padding':
            # past each count: another frame's runs, then random words;
            # frame 3 keeps its runs but counts none (a padded frame)
            old, _ = encode_frames(img[::-1], marker[::-1],
                                   r=runs.shape[1])
            for i in range(runs.shape[0]):
                n = counts[i]
                runs[i, n:] = old[i, n:]
                tail = rng.integers(0, 1 << 32, runs.shape[1], np.uint64)
                k = n + (runs.shape[1] - n) // 2
                runs[i, k:] = tail[k:].astype(np.uint32)
            counts[3] = 0
        return runs, counts, img.shape[2]
    if name == 'zero_length':
        # runs of length 0 below the counts, which the encoder never
        # writes: the valid runs are no prefix and the key rows not sorted
        runs, counts, w = run_case('blobs', seed)
        for i in (0, 1, 3):
            runs[i, rng.integers(0, counts[i], 3)] &= np.uint32(0x07FFFFFF)
        return runs, counts, w
    if name == 'unordered':
        # runs out of raster order below the counts, which the encoder never
        # writes: the sorted runs take their slower, general passes
        runs, counts, w = run_case('blobs', seed)
        for i in (0, 3):
            j, k = rng.choice(counts[i], 2, replace=False)
            runs[i, [j, k]] = runs[i, [k, j]]
        return runs, counts, w
    if name == 'full_table':
        img, marker = _blobs(rng, 3, 24, 40, p=0.08)
        img[:, -1, ::2] = True               # runs in the bottom row
        marker[:, -1, ::4] = True
        runs, counts = encode_frames(img, marker)
        r = int(counts.max())                # one frame fills the table
        return runs[:, :r].copy(), counts, img.shape[2]
    if name == 'edges':
        h, w = 20, 75
        img = np.zeros((3, h, w), bool)
        img[0, :, 0] = True                  # the left column
        img[0, :, -1] = True                 # the right column
        img[0, 0, :] = True                  # full rows: 31 + 31 + 13
        img[0, -1, :] = True
        img[1, 3:17, 30:45] = True           # a block, split into runs
        img[1, 5, :] = True
        img[2, ::2, ::2] = True              # isolated pixels to the edges
        marker = np.zeros_like(img)
        marker[0, 10, 0] = True
        marker[1, 5, -1] = True
        marker[2] = img[2] & (rng.random(img[2].shape) < 0.5)
        runs, counts = encode_frames(img, marker)
        return runs, counts, w
    if name == 'one_row':
        img = rng.random((4, 1, 150)) < 0.5
        img[1] = False
        marker = img & (rng.random(img.shape) < 0.3)
        runs, counts = encode_frames(img, marker)
        return runs, counts, 150
    if name in ('one_column', 'two_columns'):
        # w = 1: every run one pixel of a column (no division); w = 2
        img = rng.random((3, 30, 1 if name == 'one_column' else 2)) < 0.6
        marker = img & (rng.random(img.shape) < 0.4)
        runs, counts = encode_frames(img, marker)
        return runs, counts, img.shape[2]
    raise ValueError(name)


def many_components():
    """(runs, counts, w, h): two 320 x 512 frames of ``MANY_COMPONENTS``
    isolated marked pixels each (every other pixel of every other row),
    R = 65536."""
    img = np.zeros((2, 320, 512), bool)
    img[:, ::2, ::2] = True
    runs, counts = encode_frames(img, img)
    return runs, counts, img.shape[2], img.shape[1]
