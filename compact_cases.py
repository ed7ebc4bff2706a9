"""Seeded inputs of frames mode's compaction and row tables
(``ysmr_tpu_torch/ops/labeling.py::compact_row_tables``, the kernel
``csrc/compact.cu``): masks that split the kernel's layout unevenly and
the labels the labeling gives them, with numpy and scipy only. The tests
(``tests/test_torch_compact.py`` and its cuda twin) and ``chip_smoke.py``
(phase 32) share them.
"""

import numpy as np
from scipy import ndimage

#: the seeded cases: random blobs; more components than max_det; a
#: component taller than max_bh; empty frames (padding); frames of one row
#: and of one column; components on every frame edge and a full frame;
#: frames of fewer than 32 pixels (a word over several frames)
CASES = ('blobs', 'over_capacity', 'tall', 'empty_frames', 'one_row',
         'one_column', 'edges', 'tiny')


def min_index_labels(mask):
    """The labels ``label_components`` gives (8-connected), from scipy:
    each mask pixel's component's minimum in-frame linear index, h*w on
    the background; (T, H, W) int32."""
    t, h, w = mask.shape
    out = np.empty((t, h, w), np.int32)
    for i in range(t):
        lab, n = ndimage.label(mask[i], structure=np.ones((3, 3), bool))
        uniq, first = np.unique(lab.reshape(-1), return_index=True)
        min_idx = np.full(n + 1, h * w, np.int32)
        min_idx[uniq] = first
        min_idx[0] = h * w
        out[i] = min_idx[lab]
    return out


def packed_mask(mask):
    """The mask packed as the labeling kernel packs it: 32 pixels of the
    flattened batch a word, bit i of word g the pixel 32 g + i; (ceil(T H
    W / 32),) int32."""
    flat = mask.reshape(-1)
    pad = np.zeros(-(-flat.size // 32) * 32, bool)
    pad[:flat.size] = flat
    return np.packbits(pad, bitorder='little').view('<u4').view(np.int32)


def compact_case(name, seed=0):
    """(mask (T, H, W) bool, max_det, max_bh) of a seeded case."""
    rng = np.random.default_rng(seed)
    max_det, max_bh = 64, 16
    if name in ('blobs', 'over_capacity', 'tall', 'empty_frames'):
        # 47 x 71: frames end inside a 32-pixel word
        mask = ndimage.binary_dilation(
            rng.random((3, 47, 71)) < 0.02, structure=np.ones((1, 3, 3)),
            iterations=2) & (rng.random((3, 47, 71)) < 0.9)
        if name == 'over_capacity':
            max_det = 5
        elif name == 'tall':
            mask[1, 3:44, 30:33] = True
            mask[2, 0:47, 60] = True
            max_bh = 8
        elif name == 'empty_frames':
            mask = np.concatenate([np.zeros((1, 47, 71), bool), mask[:1],
                                   np.zeros((2, 47, 71), bool)])
    elif name == 'one_row':
        mask = rng.random((4, 1, 150)) < 0.5
        mask[1] = False
    elif name == 'one_column':
        mask = rng.random((4, 150, 1)) < 0.5
        mask[2] = True
        max_bh = 40
    elif name == 'edges':
        mask = np.zeros((3, 20, 37), bool)
        mask[0, 0, :] = True                # the top row
        mask[0, -1, 1:] = True              # the bottom row
        mask[0, 2:-2, 0] = True             # the left column
        mask[0, 3:9, -1] = True             # the right column
        mask[0, [1, 1, -2, -2], [0, -1, 0, -1]] = True   # the corners
        mask[1] = True                      # one component, every pixel
        mask[2, ::2, ::3] = True            # isolated pixels to the edges
        max_det = 200
    elif name == 'tiny':
        mask = rng.random((7, 3, 5)) < 0.4
        mask[3] = False
        max_det = 3
    else:
        raise ValueError(name)
    return mask, max_det, max_bh
