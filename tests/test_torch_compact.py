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

from compact_cases import CASES, compact_case, min_index_labels, packed_mask
from ysmr_tpu.ops import labeling as jlb
from ysmr_tpu_torch.ops import labeling as lb

torch.set_num_threads(1)

BIG = lb.BIG_I
M32 = 0xFFFFFFFF
#: csrc/compact.cu's roots launch: threads a tile, 32-pixel words a
#: thread, words a root prefix
TILE_THREADS, THREAD_WORDS, GROUP_WORDS = 256, 4, 8


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


def test_packed_mask_and_cpu_route_ignore_bits():
    """``packed_mask`` packs 32 pixels of the flattened batch a word (bit i
    of word g: pixel 32 g + i); the CPU route ignores ``fg_bits`` and the
    CPU labeling returns no bits."""
    from ysmr_tpu_torch.ops import cc
    mask, max_det, max_bh = compact_case('tiny')
    bits = packed_mask(mask).view(np.uint32)
    flat = mask.reshape(-1)
    assert len(bits) == -(-flat.size // 32)
    for p in range(flat.size):
        assert bool(bits[p >> 5] >> (p & 31) & 1) == bool(flat[p])
    if flat.size % 32:
        assert bits[-1] >> (flat.size % 32) == 0
    labels = torch.from_numpy(min_index_labels(mask))
    tm = torch.from_numpy(mask)
    got = lb.compact_row_tables(labels, tm, max_det=max_det, max_bh=max_bh,
                                fg_bits=torch.from_numpy(packed_mask(mask)))
    want = lb.compact_row_tables_plain(labels, tm, max_det=max_det,
                                       max_bh=max_bh)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    lab, none = cc.label_components_whole_frame(tm, 8, return_bits=True)
    assert none is None and torch.equal(lab, cc.label_components_whole_frame(
        tm, 8))


def test_compact_row_tables_refuses_other_devices():
    mask, max_det, max_bh = compact_case('tiny')
    labels = torch.from_numpy(min_index_labels(mask)).to('meta')
    with pytest.raises(ValueError):
        lb.compact_row_tables(labels, torch.from_numpy(mask).to('meta'),
                              max_det=max_det, max_bh=max_bh)


# ---- the kernel's design (csrc/compact.cu: roots with a decoupled
# look-back, tables by runs), emulated in sequence ----

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


def _popc(v):
    return bin(v & M32).count('1')


def _run_starts(fg, g, w, left):
    """The run starts of word g: foreground pixels whose left neighbour
    (bit 31 of ``left`` for bit 0) is background, or at x = 0."""
    x0 = _div_mod(32 * g, w)[1]
    rows = 0
    o = w - x0 if x0 else 0
    while o < 32:
        rows |= 1 << o
        o += w
    return fg & ((~(((fg << 1) | (left >> 31)) & M32) & M32) | rows)


def _emulate(labels, mask, max_det, max_bh, tile_threads, rng):
    """``compact_row_tables`` as the kernel computes it: foreground words
    over the flattened batch, root bits at the run starts, tiles of
    ``tile_threads`` x 4 words whose exclusive root counts come from a
    look-back over the tiles' published counts and prefixes (a random mix
    of both), the groups' prefixes and the frames' starts (uint32); then
    each word's runs (in shuffled word order), one table update a run."""
    t, h, w = mask.shape
    n = h * w
    total = t * n
    nw = (total + 31) // 32
    tile_words = tile_threads * THREAD_WORDS
    group = GROUP_WORDS
    flat_m = np.zeros(nw * 32, bool)
    flat_m[:total] = mask.reshape(-1)
    flat_l = labels.reshape(-1)
    fg = [int(np.packbits(flat_m[32 * g:32 * g + 32],
                          bitorder='little').view('<u4')[0])
          for g in range(nw)]
    root = []
    for g in range(nw):
        left = (1 << 31) if g and flat_m[32 * g - 1] else 0
        starts = _run_starts(fg[g], g, w, left)
        word = 0
        for i in range(32):
            if starts >> i & 1:
                q = 32 * g + i
                if flat_l[q] == _div_mod(q, n)[1]:
                    word |= 1 << i
        root.append(word)
    tiles = (nw + tile_words - 1) // tile_words
    agg = [sum(_popc(root[g]) for g in
               range(k * tile_words, min(nw, (k + 1) * tile_words))) & M32
           for k in range(tiles)]
    incl = np.cumsum([0] + agg)[1:] & M32
    published = rng.random(tiles) < 0.5     # prefix (else only the count)
    excl_word = []
    for k in range(tiles):
        before = 0
        for j in range(k - 1, -1, -1):
            if published[j]:
                before += int(incl[j])
                break
            before += agg[j]
        run = before & M32
        for g in range(k * tile_words, min(nw, (k + 1) * tile_words)):
            excl_word.append(run)
            run = (run + _popc(root[g])) & M32
    gpre = [excl_word[g] for g in range(0, nw, group)]
    frame = [0] * (t + 1)
    for f in range(t + 1):
        p = f * n
        if p >= nw * 32:
            frame[f] = int(incl[-1]) if tiles else 0
        else:
            g = p >> 5
            frame[f] = (excl_word[g] +
                        _popc(root[g] & ((1 << (p & 31)) - 1))) & M32
    n_comp = np.array([(frame[i + 1] - frame[i]) & M32 for i in range(t)],
                      np.int64).astype(np.int32)

    def roots_before(r):
        g = r >> 5
        v = gpre[g // group]
        for k in range(g - g % group, g):
            v += _popc(root[k])
        return (v + _popc(root[g] & ((1 << (r & 31)) - 1))) & M32

    row_min = np.full((t * max_det, max_bh), BIG, np.int32)
    row_max = np.full((t * max_det, max_bh), -BIG, np.int32)
    row_valid = np.zeros((t * max_det, max_bh), bool)
    min_y = np.full(t * max_det, BIG, np.int32)
    for g in rng.permutation(nw):
        left = fg[g - 1] if g else 0
        starts = _run_starts(fg[g], g, w, left)
        for i in range(32):
            if not starts >> i & 1:
                continue
            q0 = 32 * g + i
            fr, local = _div_mod(q0, n)
            y, x0 = _div_mod(local, w)
            row_end = q0 + (w - 1 - x0)
            q1 = q0
            while q1 + 1 <= row_end and q1 + 1 < nw * 32 and \
                    fg[(q1 + 1) >> 5] >> ((q1 + 1) & 31) & 1:
                q1 += 1
            lab = min(max(int(flat_l[q0]), 0), n - 1)
            r = fr * n + lab
            f0 = frame[fr]
            nt = (frame[fr + 1] - f0) & M32
            rank = (roots_before(r) - f0) & M32 \
                if root[r >> 5] >> (r & 31) & 1 else 0
            ident = int(np.int64(nt).astype(np.int32)) - 1 - rank
            if not 0 <= ident < max_det:
                continue
            rel = min(max(y - _div_mod(lab, w)[0], 0), max_bh - 1)
            comp = fr * max_det + ident
            row_min[comp, rel] = min(row_min[comp, rel], x0)
            row_max[comp, rel] = max(row_max[comp, rel], x0 + q1 - q0)
            row_valid[comp, rel] = True
            if lab == local:
                min_y[comp] = y
    return row_min, row_max, row_valid, min_y, n_comp


@pytest.mark.parametrize('tile_threads', [TILE_THREADS, 3])
@pytest.mark.parametrize('case', CASES)
def test_compact_kernel_design_matches_plain(case, tile_threads):
    """The emulated kernel equals the plain version on every case, with
    the kernel's tile of 256 threads (1024 words) and with tiles of 3
    threads (12 words: many tiles, crossing frames)."""
    mask, max_det, max_bh = compact_case(case)
    labels, want = _plain(mask, max_det, max_bh)
    got = _emulate(labels.numpy(), mask, max_det, max_bh, tile_threads,
                   np.random.default_rng(1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def _nth_bit(bits, k):
    """The kernel's nth_bit: the lane and bit of the warp's k-th set bit
    (lane order), or (-1, None) past the total: five halving steps over
    the lanes' inclusive counts, then the owner's bits cleared from below."""
    pops = [bin(b).count('1') for b in bits]
    excl = [sum(pops[:lane]) for lane in range(32)]
    incl = [e + p for e, p in zip(excl, pops)]
    owner = 0
    for b in (16, 8, 4, 2, 1):
        if incl[owner + b - 1] <= k:
            owner += b
    if k >= incl[31]:
        return -1, None
    rest = bits[owner]
    for _ in range(k - excl[owner]):
        rest &= rest - 1
    return owner, (rest & -rest).bit_length() - 1


def test_nth_bit_design_visits_every_set_bit():
    """The warp's spread of its run starts over its lanes (rounds of 32,
    ``nth_bit``) visits every set bit once, in lane and bit order: random
    words, empty lanes, full words, all lanes empty."""
    rng = np.random.default_rng(5)
    cases = [[0] * 32, [M32] * 32, [M32 if i % 7 == 0 else 0
                                    for i in range(32)]]
    for _ in range(200):
        cases.append([int(rng.integers(0, 1 << 32)) if rng.random() < 0.3
                      else 0 for _ in range(32)])
    for bits in cases:
        flat = [(lane, i) for lane in range(32) for i in range(32)
                if bits[lane] >> i & 1]
        for k in range(len(flat) + 40):
            got = _nth_bit(bits, k)
            assert got == (flat[k] if k < len(flat) else (-1, None))


def test_div_mod_is_floor_division():
    """The kernel's reciprocal division against Python's on quotients up
    to a 64-frame 1228 x 922 batch and frame widths 1 to 4096."""
    rng = np.random.default_rng(2)
    for d in [1, 3, 7, 32, 922, 1228, 4096, 1228 * 922, 4096 * 4096]:
        for q in np.concatenate([rng.integers(0, 64 * 1228 * 922, 2000),
                                 np.arange(d - 3, d + 3) % (64 * d),
                                 [0, 64 * d - 1]]):
            assert _div_mod(int(q), d) == divmod(int(q), d)
