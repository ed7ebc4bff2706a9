"""Whole-frame labeling, marker reconstruction and compaction of the PyTorch
port (ysmr_tpu_torch/ops/labeling.py, the kernel wrappers of ops/cc.py)
against the JAX package and scipy on the same numpy masks.

Tolerances: none. Labels are integers (the minimum linear index of each
component), reconstructions and row tables are exact, and every case
asserts that the plain labeling converged, so the step cap plays no part.
The Pallas kernels run in interpret mode, as tests/test_pallas_cc.py runs
them. The CUDA kernels are held to their plain versions and to scipy in the
``cuda``-marked tests, which skip without a GPU.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import ndimage

from test_labeling import _random_blobs
from test_pallas_cc import _random_pixel_scene
from ysmr_tpu.ops import labeling as jlb
from ysmr_tpu.ops import pallas_cc
from ysmr_tpu_torch.ops import cc
from ysmr_tpu_torch.ops import labeling as lb

torch.set_num_threads(1)

MAX_ITERS = 64


def _masks(seed, t=3, h=96, w=128):
    rng = np.random.default_rng(seed)
    return np.stack([_random_blobs(rng, h=h, w=w) for _ in range(t)])


def scipy_min_index_labels(mask, connectivity):
    """Labels with the port's semantics from scipy.ndimage.label: the
    minimum linear index of each component, h*w on the background."""
    h, w = mask.shape
    structure = np.ones((3, 3), bool) if connectivity == 8 else None
    lab, n = ndimage.label(mask, structure=structure)
    uniq, first = np.unique(lab.reshape(-1), return_index=True)
    min_idx = np.full(n + 1, h * w, np.int32)
    min_idx[uniq] = first
    min_idx[0] = h * w
    return min_idx[lab]


def snake_mask(h, w):
    """One serpentine component: rows joined at alternating ends, a
    geodesic diameter far above 64 steps."""
    m = np.zeros((h, w), bool)
    for y in range(0, h, 2):
        m[y, 1:w - 1] = True
        if y + 1 < h:
            m[y + 1, w - 2 if (y // 2) % 2 == 0 else 1] = True
    return m


@pytest.mark.parametrize('connectivity', [4, 8])
def test_label_components_matches_jax_and_pallas(connectivity):
    masks = _masks(0)
    labels, steps = lb.label_components(torch.from_numpy(masks),
                                        connectivity=connectivity,
                                        max_iters=MAX_ITERS)
    assert labels.dtype == torch.int32
    assert int(steps.max()) < MAX_ITERS          # converged
    ours = labels.numpy()
    pallas = np.asarray(pallas_cc.label_components_whole_frame(
        masks, connectivity=connectivity, max_iters=MAX_ITERS,
        interpret=True))
    np.testing.assert_array_equal(ours, pallas)
    for i in range(len(masks)):
        np.testing.assert_array_equal(ours[i], np.asarray(
            jlb.label_components(masks[i], connectivity=connectivity,
                                 max_iters=MAX_ITERS)))
        np.testing.assert_array_equal(
            ours[i], scipy_min_index_labels(masks[i], connectivity))


def test_label_components_steps_and_cap():
    """Per-frame step counts: an empty frame takes none, and a serpentine
    frame that needs more than the cap reports the cap and keeps the JAX
    function's partial labels."""
    h, w = 40, 48
    masks = np.stack([np.zeros((h, w), bool), snake_mask(h, w),
                      _random_blobs(np.random.default_rng(3), h=h, w=w)])
    labels, steps = lb.label_components(torch.from_numpy(masks),
                                        connectivity=4, max_iters=4)
    assert steps.tolist()[0] == 0 and steps.tolist()[1] == 4
    for i in range(3):
        np.testing.assert_array_equal(labels.numpy()[i], np.asarray(
            jlb.label_components(masks[i], connectivity=4, max_iters=4)))
    assert (labels.numpy()[0] == h * w).all()


def test_reconstruction_matches_scipy_and_pallas(rng):
    """The 33-frame batch of tests/test_pallas_cc.py (two bit planes of the
    TPU kernel, an all-background last frame)."""
    t, h, w = 33, 60, 150
    mask = np.zeros((t, h, w), bool)
    marker = np.zeros((t, h, w), bool)
    for i in range(t - 1):
        m, k, *_ = _random_pixel_scene(rng, h, w)
        mask[i], marker[i] = m, k & m
    _, steps = lb.label_components(torch.from_numpy(mask), connectivity=4,
                                   max_iters=MAX_ITERS)
    assert int(steps.max()) < MAX_ITERS
    ours = cc.binary_reconstruct(torch.from_numpy(mask),
                                 torch.from_numpy(marker),
                                 max_iters=MAX_ITERS).numpy()
    np.testing.assert_array_equal(ours, np.asarray(
        pallas_cc.binary_reconstruct(mask, marker, max_iters=MAX_ITERS,
                                     interpret=True)))
    for i in range(t):
        np.testing.assert_array_equal(
            ours[i], ndimage.binary_propagation(marker[i], mask=mask[i]))
    assert ours[:-1].any() and not ours[-1].any()


def test_propagate_markers_matches_jax():
    masks = _masks(4)
    markers = masks & (np.random.default_rng(5).random(masks.shape) < 0.02)
    ours = lb.propagate_markers(torch.from_numpy(masks),
                                torch.from_numpy(markers))
    for i in range(len(masks)):
        np.testing.assert_array_equal(ours.numpy()[i], np.asarray(
            jlb.propagate_markers(masks[i], markers[i])))


@pytest.mark.parametrize('max_det', [64, 5])
def test_compact_labels_matches_jax(max_det):
    """Reverse raster ids, the overflow bucket beyond capacity."""
    masks = _masks(1)
    labels = lb.label_components(torch.from_numpy(masks))[0]
    comp, n = lb.compact_labels(labels, torch.from_numpy(masks),
                                max_det=max_det)
    jfn = jax.jit(jlb.compact_labels, static_argnames=('max_det',))
    for i in range(len(masks)):
        jc, jn = jfn(labels.numpy()[i], masks[i], max_det=max_det)
        np.testing.assert_array_equal(comp.numpy()[i], np.asarray(jc))
        assert int(n[i]) == int(jn)
    assert int(n.max()) > 5


@pytest.mark.parametrize('max_det,max_bh', [(32, 16), (6, 4)])
def test_component_tables_match_jax(max_det, max_bh):
    """Row tables, candidate points and hull-edge candidates of every
    non-empty component, including components beyond capacity and taller
    than max_bh."""
    masks = _masks(2)
    masks[1, 10:60, 40:44] = True            # taller than max_bh
    tm = torch.from_numpy(masks)
    comp, n = lb.compact_labels(lb.label_components(tm)[0], tm,
                                max_det=max_det)
    ours = lb.component_tables(comp, tm, max_det=max_det, max_bh=max_bh)
    valid = ours['count'].numpy() > 0
    assert valid.any()
    assert (max_det == 6) == bool((n > max_det).any())
    jfn = jax.jit(jlb.component_tables, static_argnames=('max_det', 'max_bh'))
    for i in range(len(masks)):
        ref = jfn(comp.numpy()[i], masks[i], max_det=max_det, max_bh=max_bh)
        sl = slice(i * max_det, (i + 1) * max_det)
        v = valid[sl]
        np.testing.assert_array_equal(v, np.asarray(ref['count']) > 0)
        for key in ('count', 'min_y', 'points_valid', 'edge_dx', 'edge_dy',
                    'edge_valid'):
            np.testing.assert_array_equal(ours[key].numpy()[sl][v],
                                          np.asarray(ref[key])[v], key)
        pv = ours['points_valid'].numpy()[sl][v]
        np.testing.assert_array_equal(ours['points'].numpy()[sl][v][pv],
                                      np.asarray(ref['points'])[v][pv])


# ---- the reconstruction kernel's design (csrc/cc.cu, rec_* passes),
# emulated in sequence on Python integers ----

M32 = 0xFFFFFFFF
MARK = 1 << 31


def _pack_words(flat):
    """The kernel's packing: 4 bytes to a nibble by one multiplication,
    eight nibbles to a word; pixel g in bit g % 32 of word g // 32."""
    n_words = (len(flat) + 31) // 32
    padded = np.zeros(n_words * 32, np.uint8)
    padded[:len(flat)] = flat != 0
    quads = padded.view('<u4').astype(np.uint64)
    nibbles = ((quads * 0x01020408) & M32) >> 24
    shifts = (np.arange(len(nibbles)) % 8 * 4).astype(np.uint64)
    return [int(x) for x in (nibbles << shifts).reshape(-1, 8).sum(1)]


def _unpack_words(words, total):
    """The kernel's unpacking: a nibble to the low bits of four bytes."""
    out = np.zeros(len(words) * 32, np.uint8)
    for k, word in enumerate(words):
        for q in range(8):
            quad = ((word >> (4 * q) & 0xF) * 0x00204081) & 0x01010101
            out[k * 32 + 4 * q:k * 32 + 4 * q + 4] = np.frombuffer(
                int(quad).to_bytes(4, 'little'), np.uint8)
    return out[:total]


def _row_masks(g0, h, w):
    row, x = divmod(g0, w)
    start = top = b = 0
    while b < 32:
        n = min(32 - b, w - x)
        if x == 0:
            start |= 1 << b
        if row % h == 0:
            top |= (M32 >> (32 - n)) << b
        b, x, row = b + n, 0, row + 1
    return start, top & M32


def _segment_starts(m, row_start):
    return m & ~((m << 1) & ~row_start) & M32


def _bits_at(words, off):
    if off <= -32:
        return 0
    if off < 0:
        return (words[0] << -off) & M32
    j, o = off >> 5, off & 31
    lo = words[j] if j < len(words) else 0
    hi = words[j + 1] if j + 1 < len(words) else 0
    return (lo >> o | hi << (32 - o)) & M32 if o else lo


def _segment_bits(m, starts, sb):
    stop = (~m | starts) & ~(M32 >> (31 - sb)) & M32
    upto = M32 if stop == 0 else (1 << ((stop & -stop).bit_length() - 1)) - 1
    return upto & ~((1 << sb) - 1)


def _set_bits(word):
    return [b for b in range(32) if word >> b & 1]


def _reconstruct_emulated(mask, marker, rng):
    """The four passes of the kernel on a (T, H, W) batch, the words of
    each pass in shuffled order."""
    t, h, w = mask.shape
    total = mask.size
    mbits = _pack_words(mask.reshape(-1))
    kbits = [a & b for a, b in zip(_pack_words(marker.reshape(-1)), mbits)]
    lab = {}
    order = lambda: [int(k) for k in rng.permutation(len(mbits))]
    for k in order():                                        # rec_pack
        m, g0 = mbits[k], k * 32
        if m == 0:
            continue
        rs = _row_masks(g0, h, w)[0]
        starts = _segment_starts(m, rs)
        first = g0
        if m & 1 and not rs & 1 and mask.reshape(-1)[g0 - 1]:
            prev = _segment_starts(mbits[k - 1], _row_masks(g0 - 32, h, w)[0])
            first = g0 - 32 + prev.bit_length() - 1
        for b in _set_bits(m):
            sb = (starts & (M32 >> (31 - b))).bit_length() - 1
            lab[g0 + b] = first if b == 0 else g0 + sb

    def root(x):
        while lab[x] & ~MARK != x:
            x = lab[x] & ~MARK
        return x

    for k in order():                                        # rec_merge
        m, g0 = mbits[k], k * 32
        if m == 0:
            continue
        rs, top = _row_masks(g0, h, w)
        carry = mbits[k - 1] >> 31 if k else 0
        left = ((m << 1) | carry) & ~rs & M32
        up = _bits_at(mbits, g0 - w) & ~top
        up_left = _bits_at(mbits, g0 - w - 1) & ~rs
        for b in _set_bits(m & up & ~(left & up_left)):
            a, c = root(g0 + b), root(g0 + b - w)
            if a != c:
                lab[max(a, c)] = min(a, c)
    for k in order():                                        # rec_mark
        m, g0 = mbits[k], k * 32
        starts = _segment_starts(m, _row_masks(g0, h, w)[0])
        for sb in _set_bits(starts):
            r = root(g0 + sb)
            if r != g0 + sb:
                lab[g0 + sb] = r
            if kbits[k] & _segment_bits(m, starts, sb):
                lab[r] |= MARK
    keep = []
    for k, m in enumerate(mbits):                            # rec_keep
        g0, word = k * 32, 0
        starts = _segment_starts(m, _row_masks(g0, h, w)[0])
        for sb in _set_bits(starts):
            v = lab[g0 + sb]
            if v & ~MARK != g0 + sb:
                v = lab[v]
            if v & MARK:
                word |= _segment_bits(m, starts, sb)
        keep.append(word)
    return _unpack_words(keep, total).reshape(t, h, w).astype(bool)


PACK_WIDTHS = [1, 31, 32, 33, 1228]


@pytest.mark.parametrize('w', PACK_WIDTHS)
def test_bit_pack_round_trip_and_row_masks(w):
    """The packing and unpacking multiplications are inverse to each other
    and agree with numpy's little-endian packbits; the row masks name the
    first pixel of every row and the first row of every frame, at widths
    below, at and above the word and at the bench width."""
    rng = np.random.default_rng(w)
    h, t = 5, 3
    flat = (rng.random(t * h * w) < 0.5).astype(np.uint8) * \
        rng.integers(1, 256, t * h * w).astype(np.uint8)
    words = _pack_words(flat)
    ref = np.packbits(flat != 0, bitorder='little')
    ref = np.concatenate([ref, np.zeros(-len(ref) % 4, np.uint8)])
    assert words == ref.view('<u4').tolist()
    np.testing.assert_array_equal(_unpack_words(words, len(flat)), flat != 0)
    g = np.arange(len(words) * 32)
    for k in range(len(words)):
        start, top = _row_masks(k * 32, h, w)
        sl = g[k * 32:(k + 1) * 32]
        assert start == int(((sl % w == 0) << np.arange(32)).sum())
        assert top == int(((sl // w % h == 0) << np.arange(32)).sum())


def _reconstruct_case(case, w):
    """(mask, marker) batches that the reconstruction has to get right:
    ``blobs`` random blobs with sparse markers, some outside the mask;
    ``edges`` an empty frame, a full frame with one marker, a full frame
    with none, and the serpentine marked at its far end."""
    rng = np.random.default_rng(len(case) + w)
    h = 24
    if case == 'blobs':
        mask = np.stack([_random_blobs(rng, h=h, w=max(w, 16))[:, :w]
                         for _ in range(3)])
        mask |= rng.random(mask.shape) < 0.05
        marker = rng.random(mask.shape) < 0.03       # also off the mask
    else:
        mask = np.zeros((4, h, w), bool)
        mask[1:3] = True
        mask[3] = snake_mask(h, w) if w >= 4 else True
        marker = np.zeros_like(mask)
        marker[0, h // 2, w // 2] = True             # marker, no mask
        marker[1, h - 1, w - 1] = True
        ys, xs = np.nonzero(mask[3])
        marker[3, ys[-1], xs[-1]] = True
    return mask, marker


RECONSTRUCT_CASES = [(c, w) for c in ('blobs', 'edges') for w in PACK_WIDTHS]


@pytest.mark.parametrize('case,w', RECONSTRUCT_CASES)
def test_packed_reconstruction_design_matches_plain_and_scipy(case, w):
    """A sequential emulation of the kernel's four passes on bit words
    (words in shuffled order) against scipy's binary_propagation on every
    frame, and against the plain version wherever its labeling converged:
    markers outside the mask, empty and full frames, the serpentine, and
    widths below, at and above the word."""
    mask, marker = _reconstruct_case(case, w)
    got = _reconstruct_emulated(mask, marker, np.random.default_rng(3))
    for i in range(len(mask)):
        np.testing.assert_array_equal(got[i], ndimage.binary_propagation(
            marker[i] & mask[i], mask=mask[i]), err_msg=str(i))
    tm, tk = torch.from_numpy(mask), torch.from_numpy(marker)
    _, steps = lb.label_components(tm, connectivity=4, max_iters=MAX_ITERS)
    conv = (steps < MAX_ITERS).numpy()
    assert conv.any()
    np.testing.assert_array_equal(
        got[conv], lb.propagate_markers(tm, tk, max_iters=MAX_ITERS)
        .numpy()[conv])
    if case == 'edges':
        assert not got[0].any() and got[1].all() and not got[2].any()
        assert got[3].sum() == mask[3].sum()


def test_pixel_kernel_width_cap_is_the_shared_memory_formula():
    """PIXEL_MAX_WIDTH is the widest frame whose tile (2048 slots of int32
    parents), halo and tile lins (w + 1 + 2048 slots of an int32 and a
    flag) fit a Hopper block's 232,448 bytes of shared memory
    (csrc/cc.cu, merge_smem)."""
    def merge_smem(w):
        return 2048 * 4 + (w + 1 + 2048) * 5
    assert merge_smem(cc.PIXEL_MAX_WIDTH) <= 232448 < \
        merge_smem(cc.PIXEL_MAX_WIDTH + 1)
    assert cc.PIXEL_MAX_WIDTH == 42802


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['whole', 'unaligned', 'chunks'])
@pytest.mark.parametrize('case,w', RECONSTRUCT_CASES)
def test_reconstruct_kernel_matches_scipy_and_plain_on_cuda(case, w, layout,
                                                            monkeypatch):
    """The kernel on the design cases: scipy on every frame, the plain
    version where it converged, one launch counted; also on views that
    start off a 16-byte boundary (the byte-wise loads) and with the frames
    of a call split over several launches."""
    dev = _cuda()
    mask, marker = _reconstruct_case(case, w)
    tm, tk = torch.from_numpy(mask).to(dev), torch.from_numpy(marker).to(dev)
    if layout == 'unaligned':
        pad = torch.zeros(5, dtype=torch.bool, device=dev)
        tm = torch.cat([pad[:3], tm.reshape(-1)])[3:].view(mask.shape)
        tk = torch.cat([pad, tk.reshape(-1)])[5:].view(mask.shape)
        assert tm.data_ptr() % 16 and tm.is_contiguous()
    elif layout == 'chunks':
        monkeypatch.setattr(cc, 'RECONSTRUCT_MAX_PIXELS',
                            2 * mask.shape[1] * mask.shape[2])
    before = cc.binary_reconstruct.launches
    got = cc.binary_reconstruct(tm, tk)
    torch.cuda.synchronize()
    assert cc.binary_reconstruct.launches == before + 1
    got = got.cpu().numpy()
    for i in range(len(mask)):
        np.testing.assert_array_equal(got[i], ndimage.binary_propagation(
            marker[i] & mask[i], mask=mask[i]), err_msg=str(i))
    _, steps = lb.label_components(torch.from_numpy(mask), connectivity=4)
    conv = (steps < MAX_ITERS).numpy()
    np.testing.assert_array_equal(got[conv], lb.propagate_markers(
        torch.from_numpy(mask), torch.from_numpy(marker)).numpy()[conv])


@pytest.mark.cuda
def test_pixel_kernel_width_cap_on_cuda():
    """A frame one pixel wider than PIXEL_MAX_WIDTH raises; at the cap a
    short list gives the plain version's labels."""
    dev = _cuda()
    w, h, f = cc.PIXEL_MAX_WIDTH, 3, 64
    mask = np.zeros((1, h, w), bool)
    mask[0, 0, 5:9] = mask[0, 1, 8:12] = mask[0, 2, w - 3:] = True
    mask[0, 1, w - 1] = True
    marker = np.zeros_like(mask)
    marker[0, 0, 6] = marker[0, 2, w - 1] = True
    lists = _pixel_lists(mask, marker, f)
    args = [torch.from_numpy(a).to(dev) for a in lists]
    with pytest.raises(ValueError, match='wider'):
        cc.cc_labels_at_pixels(*args, h=h, w=w + 1, double_threshold=True)
    lab, keep = cc.cc_labels_at_pixels(*args, h=h, w=w, double_threshold=True)
    p_lab, p_keep, steps = cc.cc_labels_at_pixels_plain(
        *(torch.from_numpy(a) for a in lists), h=h, w=w,
        double_threshold=True)
    assert int(steps.max()) < MAX_ITERS
    np.testing.assert_array_equal(lab.cpu().numpy(), p_lab.numpy())
    np.testing.assert_array_equal(keep.cpu().numpy(), p_keep.numpy())
    assert keep.cpu().numpy().sum() == 4 + 4 + 3 + 1


@pytest.mark.cuda
def test_cc_kernels_match_plain_and_scipy_on_cuda():
    """Both kernels against their plain versions on the card, bit for bit,
    one launch counted per call; the serpentine frame (beyond the plain
    version's cap) against scipy only. Runs on a machine with an NVIDIA
    GPU (see README)."""
    dev = _cuda()
    h, w = 96, 128
    masks = np.concatenate([_masks(6, t=4, h=h, w=w),
                            np.zeros((1, h, w), bool),
                            snake_mask(h, w)[None]])
    markers = masks & (np.random.default_rng(7).random(masks.shape) < 0.01)
    tm, tk = torch.from_numpy(masks), torch.from_numpy(markers)
    for conn in (4, 8):
        plain, steps = lb.label_components(tm.to(dev), connectivity=conn)
        before = cc.label_components_whole_frame.launches
        got = cc.label_components_whole_frame(tm.to(dev), connectivity=conn)
        torch.cuda.synchronize()
        assert cc.label_components_whole_frame.launches == before + 1
        conv = (steps < MAX_ITERS).cpu().numpy()
        assert conv[:5].all()
        np.testing.assert_array_equal(got.cpu().numpy()[conv],
                                      plain.cpu().numpy()[conv])
        for i in range(len(masks)):
            np.testing.assert_array_equal(
                got.cpu().numpy()[i], scipy_min_index_labels(masks[i], conn))
    before = cc.binary_reconstruct.launches
    got = cc.binary_reconstruct(tm.to(dev), tk.to(dev))
    torch.cuda.synchronize()
    assert cc.binary_reconstruct.launches == before + 1
    plain = lb.propagate_markers(tm.to(dev), tk.to(dev))
    np.testing.assert_array_equal(got.cpu().numpy()[:5],
                                  plain.cpu().numpy()[:5])
    for i in range(len(masks)):
        np.testing.assert_array_equal(
            got.cpu().numpy()[i],
            ndimage.binary_propagation(markers[i], mask=masks[i]))


def _pixel_lists(masks, markers, f):
    """(T, F) raster-order pixel lists of (T, H, W) masks: x, y int32,
    valid (a prefix) and marker bool."""
    t = masks.shape[0]
    px_x = np.zeros((t, f), np.int32)
    px_y = np.zeros((t, f), np.int32)
    valid = np.zeros((t, f), bool)
    marker = np.zeros((t, f), bool)
    for i in range(t):
        ys, xs = np.nonzero(masks[i])
        n = min(len(ys), f)
        px_x[i, :n], px_y[i, :n] = xs[:n], ys[:n]
        valid[i, :n] = True
        marker[i, :n] = markers[i][ys[:n], xs[:n]]
    return px_x, px_y, valid, marker


def _scipy_pixel_labels(masks, markers, px_x, px_y, valid, double):
    """The kernel's contract from scipy: keep = valid and (with the double
    threshold) 4-connected to a marker pixel; labels the min-index
    8-connected labels of the kept pixels, -1 elsewhere."""
    lab = np.full(px_x.shape, -1, np.int32)
    keep = np.zeros(px_x.shape, bool)
    for i in range(masks.shape[0]):
        m = np.zeros_like(masks[i])
        m[px_y[i][valid[i]], px_x[i][valid[i]]] = True
        kept = ndimage.binary_propagation(markers[i] & m, mask=m) \
            if double else m
        keep[i] = valid[i] & kept[px_y[i], px_x[i]]
        lab[i] = np.where(keep[i], scipy_min_index_labels(kept, 8)[
            px_y[i], px_x[i]], -1)
    return lab, keep


def _scenes(seed, t=3, h=96, w=256, f=512):
    """The random pixel scenes of tests/test_pallas_cc.py, one per frame,
    then an empty frame."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((t + 1, h, w), bool)
    markers = np.zeros((t + 1, h, w), bool)
    for i in range(t):
        masks[i], markers[i], *_ = _random_pixel_scene(rng, h, w, f)
    return masks, markers & masks


@pytest.mark.parametrize('double', [True, False])
def test_cc_labels_at_pixels_plain_matches_pallas_and_scipy(double):
    """The plain version against the Pallas kernel in interpret mode and
    against scipy, bit for bit; both labelings converged."""
    h, w, f = 96, 256, 512
    masks, markers = _scenes(11 if double else 12, h=h, w=w, f=f)
    px_x, px_y, valid, marker = _pixel_lists(masks, markers, f)
    args = [torch.from_numpy(a) for a in (px_x, px_y, valid, marker)]
    lab, keep, steps = cc.cc_labels_at_pixels_plain(
        *args, h=h, w=w, double_threshold=double, max_iters=MAX_ITERS)
    assert int(steps.max()) < MAX_ITERS
    assert lab.dtype == torch.int32 and keep.dtype == torch.bool
    ref_lab, ref_keep = pallas_cc.cc_labels_at_pixels(
        px_x, px_y, valid, marker, h=h, w=w, double_threshold=double,
        max_iters=MAX_ITERS, interpret=True)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(ref_lab))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
    s_lab, s_keep = _scipy_pixel_labels(masks, markers, px_x, px_y, valid,
                                        double)
    np.testing.assert_array_equal(lab.numpy(), s_lab)
    np.testing.assert_array_equal(keep.numpy(), s_keep)
    assert keep.numpy()[:-1].any() and not keep.numpy()[-1].any()
    if double:
        assert (valid & ~keep.numpy()).any()   # unmarked blobs dropped
    # the wrapper takes the plain version for CPU tensors
    w_lab, w_keep = cc.cc_labels_at_pixels(
        *args, h=h, w=w, double_threshold=double, max_iters=MAX_ITERS)
    assert torch.equal(w_lab, lab) and torch.equal(w_keep, keep)


def test_cc_labels_at_pixels_plain_steps_and_cap():
    """A serpentine list needs more steps than the cap: the plain version
    reports the cap (its labels then stay split, as the TPU kernel's)."""
    h, w, f = 40, 48, 2048
    masks = np.stack([snake_mask(h, w), _random_blobs(
        np.random.default_rng(3), h=h, w=w)])
    markers = masks & (np.random.default_rng(4).random(masks.shape) < 0.05)
    args = [torch.from_numpy(a) for a in _pixel_lists(masks, markers, f)]
    _, _, steps = cc.cc_labels_at_pixels_plain(
        *args, h=h, w=w, double_threshold=True, max_iters=8)
    assert steps.tolist()[0] == 8 and steps.tolist()[1] < 8


def _edge_pixel_case(case):
    """Pixel lists that break the kernel's tiling (tiles of 2048 slots with
    a halo of the w + 1 slots before each): ``run_across_tile`` horizontal
    runs over a tile boundary; ``wide_component`` one component over four
    tiles (full-width rows of a 1228-px frame) beside an unmarked one;
    ``f_unaligned`` F no multiple of the tile; ``empty_frame`` a frame with
    no pixel between two others; ``full_list`` frames whose F slots are all
    valid; ``wide_frame`` 9000-px rows, whose halo needs more than 48 kB of
    shared memory. Returns (masks, markers, f)."""
    rng = np.random.default_rng(len(case))
    if case == 'run_across_tile':
        # rows of 300 px: slot 2048 lies inside row 6's run
        masks = np.zeros((2, 12, 300), bool)
        masks[:, :10] = rng.random((2, 10, 300)) < 0.97
        masks[1, 5:7, 240:260] = True
        f = 4096
    elif case == 'wide_component':
        masks = np.zeros((2, 10, 1228), bool)
        masks[:, 2:8] = True
        masks[:, 9, 100:140] = True
        masks[1, 4, 600] = False
        f = 8192
    elif case == 'f_unaligned':
        masks = rng.random((3, 64, 80)) < 0.5
        f = 3000
    elif case == 'wide_frame':
        masks = rng.random((2, 6, 9000)) < 0.6
        f = 40000
    elif case == 'empty_frame':
        masks = _masks(22, t=3, h=96, w=128)
        masks[1] = False
        f = 4096
    else:
        masks = _masks(23, t=2, h=96, w=128)
        masks[:, 40:, :] = True
        f = 2500
    markers = masks & (rng.random(masks.shape) < 0.002)
    if case == 'wide_component':
        markers[:, 5, 700] = True
        markers[:, 9] = False
    return masks, markers, f


PIXEL_EDGE_CASES = ['run_across_tile', 'wide_component', 'f_unaligned',
                    'empty_frame', 'full_list', 'wide_frame']


@pytest.mark.parametrize('double', [True, False])
@pytest.mark.parametrize('case', PIXEL_EDGE_CASES)
def test_cc_labels_at_pixels_plain_on_edge_lists(case, double):
    """The plain version against scipy on the lists that break the
    kernel's tiling, on every frame where its labelings converged; the
    cases hold what they name."""
    masks, markers, f = _edge_pixel_case(case)
    h, w = masks.shape[1:]
    lists = _pixel_lists(masks, markers, f)
    lab, keep, steps = cc.cc_labels_at_pixels_plain(
        *(torch.from_numpy(a) for a in lists), h=h, w=w,
        double_threshold=double, max_iters=MAX_ITERS)
    s_lab, s_keep = _scipy_pixel_labels(masks, markers, *lists[:3], double)
    conv = (steps < MAX_ITERS).numpy()
    assert conv.any()
    np.testing.assert_array_equal(lab.numpy()[conv], s_lab[conv])
    np.testing.assert_array_equal(keep.numpy()[conv], s_keep[conv])
    n_valid = lists[2].sum(1)
    if case == 'run_across_tile':
        xs, ys = lists[0][0], lists[1][0]
        assert ys[2047] == ys[2048] and xs[2048] == xs[2047] + 1
    elif case == 'wide_component':
        assert (s_lab[0, :6 * w] == 2 * w).all()
        assert n_valid.min() > 3 * 2048
    elif case == 'f_unaligned':
        assert f % 2048 and 2048 < n_valid.max() < f
    elif case == 'wide_frame':
        assert w == 9000 and n_valid.min() > 3 * 2048
    elif case == 'empty_frame':
        assert n_valid[1] == 0 and n_valid[0] > 0 and n_valid[2] > 0
    else:
        assert (n_valid == f).all()


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['blobs'] + PIXEL_EDGE_CASES)
def test_cc_labels_at_pixels_kernel_matches_plain_and_scipy_on_cuda(case):
    """The kernel against scipy on every frame (the serpentine beyond the
    plain version's cap included) and against the plain version where
    that converged, single and double threshold, on random blobs and on
    the lists that break its tiling; one launch counted per call. Runs on
    a machine with an NVIDIA GPU (see README)."""
    dev = _cuda()
    if case == 'blobs':
        h, w, f = 96, 128, 8192
        masks = np.concatenate([_masks(8, t=4, h=h, w=w),
                                np.zeros((1, h, w), bool),
                                snake_mask(h, w)[None]])
        markers = masks & (np.random.default_rng(9).random(masks.shape) <
                           0.01)
    else:
        masks, markers, f = _edge_pixel_case(case)
        h, w = masks.shape[1:]
    lists = _pixel_lists(masks, markers, f)
    args = [torch.from_numpy(a).to(dev) for a in lists]
    for double in (True, False):
        before = cc.cc_labels_at_pixels.launches
        lab, keep = cc.cc_labels_at_pixels(*args, h=h, w=w,
                                           double_threshold=double)
        torch.cuda.synchronize()
        assert cc.cc_labels_at_pixels.launches == before + 1
        s_lab, s_keep = _scipy_pixel_labels(masks, markers, *lists[:3],
                                            double)
        np.testing.assert_array_equal(lab.cpu().numpy(), s_lab)
        np.testing.assert_array_equal(keep.cpu().numpy(), s_keep)
        p_lab, p_keep, steps = cc.cc_labels_at_pixels_plain(
            *args, h=h, w=w, double_threshold=double)
        conv = (steps < MAX_ITERS).cpu().numpy()
        if case == 'blobs':
            assert conv[:5].all() and not conv[5]
        np.testing.assert_array_equal(lab.cpu().numpy()[conv],
                                      p_lab.cpu().numpy()[conv])
        np.testing.assert_array_equal(keep.cpu().numpy()[conv],
                                      p_keep.cpu().numpy()[conv])
