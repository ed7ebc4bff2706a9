"""Frames mode's compaction and row tables of the PyTorch port
(ysmr_tpu_torch/ops/labeling.py::compact_row_tables: on a CUDA tensor
csrc/compact.cu) against ysmr_tpu's jitted ``compact_labels`` followed by
``component_tables``, and an emulation of the kernel's design against the
plain version.

Tolerance: none. Labels, ids, row extremes, flags and counts are integers.
JAX's empty components and rows hold other sentinels than the port's
(2^31 - 1 from an empty ``segment_min``, against +-2^30): the comparison
with JAX covers the valid rows and components, and the port's empty
entries are held to its own constants. The cuda twin is in
tests/test_torch_compact_cuda.py, which imports no JAX.
"""

import jax
import numpy as np
import pytest
import torch

from compact_cases import CASES, compact_case, min_index_labels
from ysmr_tpu.ops import labeling as jlb
from ysmr_tpu_torch.ops import labeling as lb

torch.set_num_threads(1)

BIG = lb.BIG_I
M32 = 0xFFFFFFFF


def _plain(mask, max_det, max_bh):
    labels = torch.from_numpy(min_index_labels(mask))
    return labels, lb.compact_row_tables(labels, torch.from_numpy(mask),
                                         max_det=max_det, max_bh=max_bh)


@pytest.mark.parametrize('case', CASES)
def test_compact_row_tables_match_jax(case):
    """The row tables, row flags, min_y and component counts of every
    frame, bit-equal to ysmr_tpu's ``compact_labels`` followed by
    ``component_tables`` (its row tables as its candidate points carry
    them), on the CPU route."""
    mask, max_det, max_bh = compact_case(case)
    labels, (row_min, row_max, row_valid, min_y, n) = _plain(
        mask, max_det, max_bh)
    assert lb.compact_row_tables.launches == 0
    t = mask.shape[0]
    compact = jax.jit(jlb.compact_labels, static_argnames=('max_det',))
    tables = jax.jit(jlb.component_tables,
                     static_argnames=('max_det', 'max_bh'))
    for i in range(t):
        comp, jn = compact(labels.numpy()[i], mask[i], max_det=max_det)
        ref = tables(comp, mask[i], max_det=max_det, max_bh=max_bh)
        sl = slice(i * max_det, (i + 1) * max_det)
        assert int(n[i]) == int(jn)
        pv = np.asarray(ref['points_valid'])
        valid = pv[:, :max_bh]
        np.testing.assert_array_equal(row_valid.numpy()[sl], valid)
        pts = np.asarray(ref['points'])[..., 0]
        np.testing.assert_array_equal(row_min.numpy()[sl][valid],
                                      pts[:, :max_bh][valid])
        np.testing.assert_array_equal(row_max.numpy()[sl][valid],
                                      pts[:, max_bh:][valid])
        assert (row_min.numpy()[sl][~valid] == BIG).all()
        assert (row_max.numpy()[sl][~valid] == -BIG).all()
        used = valid[:, 0]
        np.testing.assert_array_equal(min_y.numpy()[sl][used],
                                      np.asarray(ref['min_y'])[used])
        assert (min_y.numpy()[sl][~used] == BIG).all()
        # a component has its first row: the root's
        np.testing.assert_array_equal(valid.any(1), used)
    counts = n.numpy()
    assert counts.sum() > 0
    if case == 'over_capacity':
        assert (counts > max_det).any()
    if case == 'tall':
        assert row_valid.numpy()[:, -1].any()
    if case in ('empty_frames', 'one_row', 'tiny'):
        assert (counts == 0).any()


def test_compact_row_tables_are_the_two_plain_steps():
    """The plain version is ``compact_labels`` then
    ``component_row_tables``; the CPU route is the plain version."""
    mask, max_det, max_bh = compact_case('blobs', seed=4)
    labels = torch.from_numpy(min_index_labels(mask))
    tm = torch.from_numpy(mask)
    comp, n = lb.compact_labels(labels, tm, max_det=max_det)
    want = lb.component_row_tables(comp, tm, max_det=max_det,
                                   max_bh=max_bh) + (n,)
    for got in (lb.compact_row_tables_plain(labels, tm, max_det=max_det,
                                            max_bh=max_bh),
                lb.compact_row_tables(labels, tm, max_det=max_det,
                                      max_bh=max_bh)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_compact_row_tables_refuses_other_devices():
    mask, max_det, max_bh = compact_case('tiny')
    labels = torch.from_numpy(min_index_labels(mask)).to('meta')
    with pytest.raises(ValueError):
        lb.compact_row_tables(labels, torch.from_numpy(mask).to('meta'),
                              max_det=max_det, max_bh=max_bh)


# ---- the kernel's design (csrc/compact.cu: roots, scan, tables),
# emulated in sequence ----

def _div_mod(q, d):
    """The kernel's q / d and q % d: the float64 quotient truncated, one
    correction."""
    t = int(np.float64(q) * (np.float64(1.0) / np.float64(d)))
    r = q - t * d
    if r < 0:
        t, r = t - 1, r + d
    elif r >= d:
        t, r = t + 1, r - d
    return t, r


def _emulate(labels, mask, max_det, max_bh, tile_words, rng):
    """``compact_row_tables`` as the kernel computes it: foreground and
    root words over the flattened batch, root counts within tiles of
    ``tile_words`` words, the tiles' scan and the frames' starts (uint32),
    then each non-empty word's pixels (in shuffled word order): the id
    from the root word of the label's pixel, runs of one table slot
    reduced to a minimum and a maximum before the atomics."""
    t, h, w = mask.shape
    n = h * w
    total = t * n
    nw = (total + 31) // 32
    flat_m = np.zeros(nw * 32, bool)
    flat_m[:total] = mask.reshape(-1)
    flat_l = labels.reshape(-1)
    fg = [int(np.packbits(flat_m[32 * g:32 * g + 32],
                          bitorder='little').view('<u4')[0])
          for g in range(nw)]
    root = []
    for g in range(nw):
        word = 0
        for lane in range(32):
            if fg[g] >> lane & 1:
                q = 32 * g + lane
                if flat_l[q] == _div_mod(q, n)[1]:
                    word |= 1 << lane
        root.append(word)
    tiles = (nw + tile_words - 1) // tile_words
    pre, tile = [], []
    for k in range(tiles):
        run = 0
        for g in range(k * tile_words, min(nw, (k + 1) * tile_words)):
            pre.append(run)
            run = (run + bin(root[g]).count('1')) & M32
        tile.append(run)
    tile_pre = [0]
    for v in tile:
        tile_pre.append((tile_pre[-1] + v) & M32)

    def roots_before(p):
        g = p >> 5
        if g >= nw:
            return tile_pre[tiles]
        below = (1 << (p & 31)) - 1
        return (tile_pre[g // tile_words] + pre[g] +
                bin(root[g] & below).count('1')) & M32

    frame = [roots_before(i * n) for i in range(t + 1)]
    n_comp = np.array([(frame[i + 1] - frame[i]) & M32 for i in range(t)],
                      np.int64).astype(np.int32)
    row_min = np.full((t * max_det, max_bh), BIG, np.int32)
    row_max = np.full((t * max_det, max_bh), -BIG, np.int32)
    row_valid = np.zeros((t * max_det, max_bh), bool)
    min_y = np.full(t * max_det, BIG, np.int32)
    for g in rng.permutation(nw):
        runs = {}
        for lane in range(32):
            if not fg[g] >> lane & 1:
                continue
            q = 32 * g + lane
            fr, local = _div_mod(q, n)
            y, x = _div_mod(local, w)
            lab = min(max(int(flat_l[q]), 0), n - 1)
            r = fr * n + lab
            rw = root[r >> 5]
            rbit = 1 << (r & 31)
            p = (tile_pre[(r >> 5) // tile_words] + pre[r >> 5] +
                 bin(rw & (rbit - 1)).count('1')) & M32
            rank = (p - frame[fr]) & M32 if rw & rbit else 0
            ident = int(n_comp[fr]) - 1 - rank
            if not 0 <= ident < max_det:
                continue
            rel = min(max(y - _div_mod(lab, w)[0], 0), max_bh - 1)
            comp = fr * max_det + ident
            runs.setdefault((comp, rel), []).append(x)
            if lab == local:
                min_y[comp] = y
        for (comp, rel), xs in runs.items():
            row_min[comp, rel] = min(row_min[comp, rel], min(xs))
            row_max[comp, rel] = max(row_max[comp, rel], max(xs))
            row_valid[comp, rel] = True
    return row_min, row_max, row_valid, min_y, n_comp


@pytest.mark.parametrize('tile_words', [lb.COMPACT_TILE_WORDS, 3])
@pytest.mark.parametrize('case', CASES)
def test_compact_kernel_design_matches_plain(case, tile_words):
    """The emulated kernel equals the plain version on every case, with
    the kernel's tile of 256 words and with tiles of 3 words (many tiles,
    crossing frames)."""
    mask, max_det, max_bh = compact_case(case)
    labels, want = _plain(mask, max_det, max_bh)
    got = _emulate(labels.numpy(), mask, max_det, max_bh, tile_words,
                   np.random.default_rng(1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_div_mod_is_floor_division():
    """The kernel's reciprocal division against Python's on quotients up
    to a 64-frame 1228 x 922 batch and frame widths 1 to 4096."""
    rng = np.random.default_rng(2)
    for d in [1, 3, 7, 32, 922, 1228, 4096, 1228 * 922, 4096 * 4096]:
        for q in np.concatenate([rng.integers(0, 64 * 1228 * 922, 2000),
                                 np.arange(d - 3, d + 3) % (64 * d),
                                 [0, 64 * d - 1]]):
            assert _div_mod(int(q), d) == divmod(int(q), d)
