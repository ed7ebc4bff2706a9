"""Connected components, per-component stats, hull edges and the exact
minimum-area rectangle.

Counterpart of three paths of ``ysmr_tpu/ops/labeling.py``:

- the run-table path: ``component_stats_runs`` ->
  ``_stats_tail_from_tables`` -> ``_hull_edge_data`` -> the exact rect
  (the integer edge-vector branch of ``min_area_rect``,
  ``_min_area_rect_exact``; here ``rect_from_tables``);
- the image path of frames mode: ``label_components`` (min-label
  propagation with pointer jumping), ``propagate_markers``,
  ``compact_labels`` and ``component_tables`` (the unsorted branch of
  ``component_stats`` over a frame's foreground), which feed the same
  stats tail;
- the pixel-table path of pixels mode: ``component_stats`` (its unsorted
  branch, with the exact count and gray sum of luminosity) over (T, F)
  pixel lists, sharing ``_row_tables`` with ``component_tables``.

The JAX module's docstring sets out why the per-row x extremes span the
convex hull and why the rectangle is exact.

Differences from the JAX module, all of representation:

- Functions take a whole batch: images are (T, H, W), run tables (T, R)
  and the per-component tables (T*D, ...), components of every frame
  flattened into the leading axis (the JAX pipeline ``vmap``s one frame at
  a time). A batched ``while_loop`` under ``vmap`` keeps a converged
  frame's labels, and one more propagation step leaves them as they are,
  so iterating the whole batch until no frame changes gives the same
  labels.
- ``label_components`` and ``propagate_markers`` are the plain versions of
  the kernels ``csrc/cc.cu`` (wrapper ``ops/cc.py``); ``label_components``
  also returns per-frame step counts.
- ``component_tables`` reduces over the foreground pixels only
  (``nonzero``, one host sync per batch on the CPU route); the background
  rows of the JAX reduction go to a slot that is never read. Empty
  components and rows hold +-2^30 where JAX's empty
  ``segment_min``/``segment_max`` give 2^31 - 1; nothing reads them.
- Frames mode's detect takes the compaction and the row tables in one
  call, ``compact_row_tables``: on a CUDA tensor the kernel
  ``csrc/compact.cu`` (two launches, no (T, H, W) plane of ids, no
  ``nonzero``, nothing read back), on a CPU tensor
  ``compact_row_tables_plain``, ``compact_labels`` followed by
  ``component_row_tables``.
- ``.at[idx].min/max(mode='drop')`` onto deliberately out-of-range indices
  becomes ``scatter_reduce_`` into a buffer whose last slot is a dump
  that is never read.
- The stats tail builds no candidate points: the hull kernel
  (``csrc/hull.cu``, wrapper ``ops/hull.py``) forms ``abs_y = min_y +
  row`` and writes ``count``, and the sweep kernel (``csrc/sweep.cu``,
  wrapper ``ops/sweep.py``) reads the row tables at the hull's strict
  chain corners, which hold every hull vertex, so its extents are those
  of ``ysmr_tpu``'s points (``candidate_points``, ``sweep_extents_plain``).
  Their plain versions (``hull_tables_plain``, ``sweep_tables_plain``) run
  over chunks of the non-empty components so the (D, R, R) and (D, K, P)
  tensors stay small at dense capacities. The angle finishing of both
  chains (``edge_finish_plain``) and the choice after the sweep
  (``rect_select_plain``) are the plain versions of the two kernels of
  ``csrc/rect.cu`` (wrapper ``ops/rect.py``). The sweep and the rect
  select take the always-valid horizontal candidate (1, 0) as implicit:
  no (D, K) copy of the edge vectors is made to append it.
- The hull-edge ``arctan2`` is fdlibm's float32 ``atan2f``, spelt out in
  float32 tensor operations: XLA:CPU's float32 atan2 is the C library's
  ``atan2f``, and glibc's is fdlibm's (equal on 189,700 tested inputs). A
  correctly rounded atan2 differs from it in about one input in six, and
  after ``degrees(a) - 90`` still in a few rect angles. The spelt-out
  version gives the same bits on the CPU and CUDA.

The sparse table labeling of ``use table cc``, ``label_components_table``
and ``compact_labels_table`` over (T, F) tables, is the plain version of
``csrc/table_cc.cu`` (wrapper ``ops/cc.py::cc_labels_table``).

Not ported: the float angle sweep of ``min_area_rect`` (every production
caller passes integer edge vectors) and the sorted-run row tables of
``component_stats`` (a TPU layout with the same output).
"""

import math

import numpy as np
import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops import ds

_I32 = torch.int32
_F32 = torch.float32
#: "no value" for int32 row tables (matches the JAX module's 1 << 30)
BIG_I = 1 << 30
#: "no value" for float32 extents and slopes
BIG_F = 3.0e38

# caliper-edge length bound for the cv2-center inv-sqrt table: components
# with hull edges longer than this in x fall back to exact centers
_CV2_CENTER_MAX_EDGE_W = 256

#: float32(180 / pi), the constant of jnp.degrees
_RAD_TO_DEG = float(np.float32(180.0 / math.pi))

#: pair elements per chunk of the plain (D, R, R) / (D, K, P) tensors
_CHUNK_ELEMS = 1 << 22


def _chunks(n, per_item):
    step = max(1, _CHUNK_ELEMS // max(per_item, 1))
    for s in range(0, n, step):
        yield s, min(n, s + step)


def _neighbor_min(lab, invalid, connectivity):
    """Min label over the 4- or 8-neighbourhood of (T, H, W) labels, the
    frame edges padded with ``invalid``."""
    t, h, w = lab.shape
    pad = torch.full((t, h + 2, w + 2), invalid, dtype=lab.dtype,
                     device=lab.device)
    pad[:, 1:h + 1, 1:w + 1] = lab
    if connectivity == 8:
        # separable 3x3 min: every pixel of the block is an 8-neighbour
        hmin = torch.minimum(pad[:, :, 1:w + 1],
                             torch.minimum(pad[:, :, 0:w], pad[:, :, 2:w + 2]))
        return torch.minimum(hmin[:, 0:h], torch.minimum(hmin[:, 1:h + 1],
                                                         hmin[:, 2:h + 2]))
    up = pad[:, 0:h, 1:w + 1]
    down = pad[:, 2:h + 2, 1:w + 1]
    left = pad[:, 1:h + 1, 0:w]
    right = pad[:, 1:h + 1, 2:w + 2]
    return torch.minimum(torch.minimum(up, down), torch.minimum(left, right))


def label_components(mask, connectivity=8, max_iters=64):
    """Connected-component labels by min-label propagation with one
    pointer-jumping hop per step (``ysmr_tpu/ops/labeling.py::
    label_components``, ``jump_every=1``, as its frames-mode CPU path
    calls it). Plain version of the ``csrc/cc.cu`` labeling kernel.

    :param mask: (T, H, W) bool
    :param connectivity: 4 or 8
    :param max_iters: at most this many propagation steps
    :return: (labels, steps): (T, H, W) int32 labels, the minimum linear
        index of the pixel's component (H*W on the background); (T,) int32
        the number of steps that changed a frame's labels (the frame
        converged iff steps < max_iters)
    """
    t, h, w = mask.shape
    n = h * w
    dev = mask.device
    idx = torch.arange(n, dtype=_I32, device=dev).view(1, h, w)
    inv = torch.full((), n, dtype=_I32, device=dev)
    lab = torch.where(mask, idx, inv)
    steps = torch.zeros(t, dtype=_I32, device=dev)
    for _ in range(max_iters):
        neigh = _neighbor_min(lab, n, connectivity)
        new = torch.where(mask, torch.minimum(lab, neigh), inv)
        flat = new.view(t, n)
        hop = torch.gather(flat, 1, flat.clamp(0, n - 1).long())
        new = torch.where(mask, torch.minimum(new, hop.view(t, h, w)), inv)
        changed = (new != lab).view(t, n).any(dim=1)
        if not bool(changed.any()):
            break
        steps += changed.to(_I32)
        lab = new
    return lab, steps


def propagate_markers(mask, markers, max_iters=64, labels=None):
    """``scipy.ndimage.binary_propagation(markers, mask=mask)`` for markers
    inside the mask (``ysmr_tpu/ops/labeling.py::propagate_markers`` with
    its default 4-connectivity): keeps the 4-connected components of
    ``mask`` that hold a pixel of ``markers & mask``. Plain version of the
    ``csrc/cc.cu`` reconstruction kernel.

    :param mask, markers: (T, H, W) bool
    :param labels: optional 4-connected labels of ``mask`` from
        ``label_components``
    :return: (T, H, W) bool
    """
    t, h, w = mask.shape
    n = h * w
    if labels is None:
        labels = label_components(mask, connectivity=4,
                                  max_iters=max_iters)[0]
    flat = labels.reshape(t, n).long()
    marked = torch.zeros((t, n + 1), dtype=_I32, device=mask.device)
    marked.scatter_reduce_(1, flat.clamp(0, n),
                           (markers & mask).reshape(t, n).to(_I32), 'amax')
    kept = torch.gather(marked, 1, flat.clamp(0, n - 1)) > 0
    return kept.view(t, h, w) & mask


def compact_labels(labels, mask, max_det, reverse=True):
    """Root labels -> dense component ids (``ysmr_tpu/ops/labeling.py::
    compact_labels``). With ``reverse`` the ids run in reverse raster order
    of each component's first pixel, cv2's findContours order, which fixes
    detection order and so TRACK_ID order.

    :param labels: (T, H, W) int32 from ``label_components``
    :param mask: (T, H, W) bool
    :return: (comp (T, H, W) int32 in [0, max_det], max_det for the
        background and for components beyond capacity; n_components (T,)
        int32)
    """
    t, h, w = labels.shape
    n = h * w
    flat = labels.reshape(t, n)
    m = mask.reshape(t, n)
    idx = torch.arange(n, dtype=_I32, device=labels.device)[None, :]
    is_root = (flat == idx) & m
    rank = torch.cumsum(is_root.to(_I32), dim=1, dtype=_I32) - 1
    n_components = rank[:, -1] + 1
    root_rank = torch.where(is_root, rank, torch.zeros_like(rank))
    comp = torch.gather(root_rank, 1, flat.clamp(0, n - 1).long())
    if reverse:
        comp = n_components[:, None] - 1 - comp
    comp = torch.where(m, torch.clamp(comp, max=max_det),
                       torch.full_like(comp, max_det))
    return comp.view(t, h, w), n_components


#: the table labeling's value of an invalid entry (``ysmr_tpu``'s 2**30)
TABLE_BIG = 1 << 30


def _table_sort(lin, valid):
    """Each frame's table sorted by lin, invalid entries (``TABLE_BIG``)
    last: (lin_v, sorted_lin, order), ``jnp.argsort``'s stable order."""
    lin_v = torch.where(valid, lin.to(_I32),
                        torch.full((), TABLE_BIG, dtype=_I32,
                                   device=lin.device))
    sorted_lin, order = torch.sort(lin_v, dim=1, stable=True)
    return lin_v, sorted_lin.contiguous(), order


def _table_lookup(sorted_lin, values):
    """The sorted slot holding each value (the left insertion point,
    clipped) and whether it holds it."""
    pos = torch.clamp(torch.searchsorted(sorted_lin, values.contiguous()), 0,
                      sorted_lin.shape[1] - 1)
    return pos, torch.gather(sorted_lin, 1, pos) == values


def label_components_table(lin, valid, *, w, connectivity=8, max_iters=32):
    """Component labels of a sparse pixel table, no whole-frame array
    (``ysmr_tpu/ops/labeling.py::label_components_table``): neighbours by
    binary search in the lin-sorted table, then synchronous min-label
    steps, each with one pointer jump (``lab[index_of(label)]``), at most
    ``max_iters`` of them. Plain version of ``csrc/table_cc.cu``, which
    reaches the fixpoint.

    The JAX function is one frame under ``vmap``, whose ``while_loop``
    runs until every frame converged or the cap; a converged frame is a
    fixed point, so the batch steps until no frame changes (a host sync
    a step on the card), which gives the same bits, the cap included.

    :param lin: (T, F) int32 linear indices y*w + x, unique among each
        frame's valid entries
    :param valid: (T, F) bool
    :param w: frame width (masks the x-edge wrap)
    :return: (labels, steps): (T, F) int32 the minimum lin of the entry's
        component (``TABLE_BIG`` for invalid entries); (T,) int32 the steps
        that changed a frame's labels (the frame converged iff steps <
        max_iters)
    """
    lin_v, sorted_lin, order = _table_sort(lin, valid)
    t, f = lin_v.shape
    dev = lin_v.device
    big = torch.full((), TABLE_BIG, dtype=_I32, device=dev)
    iota = torch.arange(f, device=dev)[None, :].expand(t, f)
    x = lin_v - torch.div(lin_v, w, rounding_mode='floor') * w
    if connectivity == 8:
        offsets = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
                   (0, 1), (1, -1), (1, 0), (1, 1))
    else:
        offsets = ((-1, 0), (0, -1), (0, 1), (1, 0))
    nbrs = []
    for dy, dx in offsets:
        ok = valid
        if dx == -1:
            ok = ok & (x > 0)
        elif dx == 1:
            ok = ok & (x < w - 1)
        nlin = torch.where(ok, lin_v + (dy * w + dx),
                           torch.full_like(lin_v, -1))
        pos, found = _table_lookup(sorted_lin, nlin)
        nbrs.append(torch.where(found, torch.gather(order, 1, pos), iota))
    lab = lin_v
    steps = torch.zeros(t, dtype=_I32, device=dev)
    for _ in range(max_iters):
        m = lab
        for nb in nbrs:
            m = torch.minimum(m, torch.gather(lab, 1, nb))
        pos, found = _table_lookup(sorted_lin, m)
        hop = torch.where(found, torch.gather(
            lab, 1, torch.gather(order, 1, pos)), m)
        new = torch.where(valid, torch.minimum(m, hop), big)
        changed = (new != lab).any(dim=1)
        if not bool(changed.any()):
            break
        steps += changed.to(_I32)
        lab = new
    return lab, steps


def compact_labels_table(labels, valid, lin, reverse=True):
    """Dense component ids of table labels in raster order of each
    component's minimum-lin entry, reversed with ``reverse`` (cv2's
    contour order) (``ysmr_tpu/ops/labeling.py::compact_labels_table``).

    :param labels: (T, F) int32 from ``label_components_table``
    :param valid: (T, F) bool
    :param lin: (T, F) int32 linear indices
    :return: (comp (T, F) int32 the dense id, F for an invalid entry;
        n_comp (T,) int32)
    """
    _, sorted_lin, order = _table_sort(lin, valid)
    f = labels.shape[1]
    roots = valid & (labels == lin)
    n_comp = roots.sum(dim=1, dtype=_I32)
    rank_sorted = torch.cumsum(torch.gather(roots, 1, order).to(_I32),
                               dim=1, dtype=_I32) - 1
    rank = torch.zeros_like(rank_sorted).scatter_(1, order, rank_sorted)
    pos = torch.clamp(torch.searchsorted(sorted_lin, labels.contiguous()), 0,
                      f - 1)
    comp = torch.gather(rank, 1, torch.gather(order, 1, pos))
    if reverse:
        comp = n_comp[:, None] - 1 - comp
    return torch.where(valid, comp, torch.full_like(comp, f)), n_comp


def component_tables(comp, mask, *, max_det, max_bh):
    """Per-component row tables of the image path and the stats tail
    (``ysmr_tpu/ops/labeling.py::component_tables`` without luminosity:
    the unsorted branch of ``component_stats``).

    A component's bbox rows are counted from its minimum y; rows beyond
    ``max_bh - 1`` share the last row. The reductions run over the
    foreground pixels only.

    :param comp: (T, H, W) int32 dense ids from ``compact_labels``
    :param mask: (T, H, W) bool
    :return: the ``_stats_tail_from_tables`` dict over (T*max_det, ...)
    """
    return _stats_tail_from_tables(
        *component_row_tables(comp, mask, max_det=max_det, max_bh=max_bh))


def component_row_tables(comp, mask, *, max_det, max_bh):
    """The row tables that ``component_tables`` reduces: (row_min_x,
    row_max_x, row_valid, min_y) over (T*max_det, ...), as ``_row_tables``
    gives them for the foreground pixels of ``mask``."""
    t, h, w = comp.shape
    n = h * w
    fg = torch.nonzero(mask.reshape(-1)).flatten()
    frame = torch.div(fg, n, rounding_mode='floor')
    lin = (fg - frame * n).to(_I32)
    ys = torch.div(lin, w, rounding_mode='floor')
    xs = lin - ys * w
    seg = comp.reshape(-1)[fg].long()
    return _row_tables(frame, xs, ys, seg, t, max_det=max_det, max_bh=max_bh)


def compact_row_tables_plain(labels, mask, *, max_det, max_bh):
    """Plain version of ``compact_row_tables``: ``compact_labels``, then
    ``component_row_tables`` over the dense ids."""
    comp, n_components = compact_labels(labels, mask, max_det=max_det)
    return component_row_tables(comp, mask, max_det=max_det,
                                max_bh=max_bh) + (n_components,)


def compact_row_tables(labels, mask, *, max_det, max_bh, fg_bits=None):
    """Frames mode's compaction and row tables in one call: the row
    tables ``component_row_tables`` gives for the dense ids of
    ``compact_labels`` (reverse raster order of the components' roots,
    ids from ``max_det`` on dropped), and each frame's component count.

    On a CPU tensor ``compact_row_tables_plain``; on a CUDA tensor the
    kernel ``csrc/compact.cu`` (a memset and two launches, counted as one
    call; bit-equal), or the call raises. The kernel takes the labels as
    ``label_components`` and the labeling kernel give them: each mask
    pixel's label is its component's minimum in-frame linear index.

    :param labels: (T, H, W) int32, contiguous
    :param mask: (T, H, W) bool, contiguous
    :param fg_bits: optional, the mask as ``cc.label_components_whole_frame
        (..., return_bits=True)`` packs it ((ceil(T H W / 32),) int32, bit
        i of word g the pixel 32 g + i of the flattened batch): the kernel
        reads it in place of the mask's bytes (the plain version ignores
        it)
    :return: (row_min_x, row_max_x, row_valid, min_y, n_components):
        (T*max_det, max_bh) int32, int32 and bool, (T*max_det,) int32 and
        (T,) int32
    """
    if labels.device.type == 'cpu':
        return compact_row_tables_plain(labels, mask, max_det=max_det,
                                        max_bh=max_bh)
    name = 'compact_row_tables'
    if labels.device.type != 'cuda':
        raise ValueError('{}: unsupported device {}'.format(
            name, labels.device))
    if labels.dim() != 3:
        raise ValueError('{}: labels must be (T, H, W)'.format(name))
    for a, dtype in ((labels, _I32), (mask, torch.bool)):
        if a.shape != labels.shape or a.dtype != dtype or \
                a.device != labels.device or not a.is_contiguous():
            raise ValueError('{}: expects contiguous (T, H, W) int32 labels '
                             'and bool mask on {}'.format(name,
                                                          labels.device))
    t, h, w = labels.shape
    if h * w >= 1 << 31 or min(h, w) < 1:
        raise ValueError('{}: frames of 1 to 2^31 - 1 pixels'.format(name))
    nw = (t * h * w + 31) // 32
    if fg_bits is not None and (
            fg_bits.shape != (nw,) or fg_bits.dtype != _I32 or
            fg_bits.device != labels.device or not fg_bits.is_contiguous()):
        raise ValueError('{}: fg_bits must be the ({},) int32 packed mask '
                         'on {}'.format(name, nw, labels.device))
    if max_det < 1 or max_bh < 1:
        raise ValueError('{}: max_det and max_bh must be positive'.format(
            name))
    dev = labels.device
    d = t * max_det
    row_min_x = torch.empty((d, max_bh), dtype=_I32, device=dev)
    row_max_x = torch.empty((d, max_bh), dtype=_I32, device=dev)
    row_valid = torch.empty((d, max_bh), dtype=torch.bool, device=dev)
    min_y = torch.empty((d,), dtype=_I32, device=dev)
    n_components = torch.empty((t,), dtype=_I32, device=dev)
    if t:
        lib = _build.load_kernels()
        # the tiles' status words and counter, the foreground and root
        # words, the groups' root prefixes and the frames' starts
        scratch = torch.empty(lib.ysmr_compact_scratch_words(t, h, w),
                              dtype=_I32, device=dev)
        rc = lib.ysmr_compact_row_tables(
            labels.data_ptr(), mask.data_ptr(), row_min_x.data_ptr(),
            row_max_x.data_ptr(), row_valid.data_ptr(), min_y.data_ptr(),
            n_components.data_ptr(),
            None if fg_bits is None else fg_bits.data_ptr(),
            scratch.data_ptr(), t, h, w, max_det,
            max_bh, dev.index, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, 'compact kernel launch')
        compact_row_tables.launches += 1
    return row_min_x, row_max_x, row_valid, min_y, n_components


#: kernel calls since the count was last set to 0
compact_row_tables.launches = 0


def _row_tables(frame, xs, ys, seg, t, *, max_det, max_bh):
    """Per-(component, bbox-row) x extremes of foreground points (the
    segment-reduction branch of ``ysmr_tpu/ops/labeling.py::
    component_stats``): (N,) int64 frame and component id (``max_det`` =
    overflow or background, reduced into a slot that is never read), (N,)
    int32 coordinates. Returns (row_min_x, row_max_x, row_valid, min_y)
    over (T*max_det, ...)."""
    dev = xs.device
    nseg = max_det + 1                  # the overflow bucket max_det included
    key = frame * nseg + seg
    min_y = torch.full((t * nseg,), BIG_I, dtype=_I32, device=dev)
    min_y.scatter_reduce_(0, key, ys, 'amin')
    rel_y = torch.clamp(ys - min_y[key], 0, max_bh - 1)
    nrow = max_det * max_bh + 1         # the last slot is the dump
    rkey = torch.where(seg < max_det, seg * max_bh + rel_y,
                       torch.full_like(seg, nrow - 1)) + frame * nrow

    def scatter(reduce, init):
        buf = torch.full((t * nrow,), init, dtype=_I32, device=dev)
        buf.scatter_reduce_(0, rkey, xs, reduce)
        return buf.view(t, nrow)[:, :nrow - 1].reshape(t * max_det, max_bh)

    row_min_x = scatter('amin', BIG_I)
    row_max_x = scatter('amax', -BIG_I)
    row_valid = row_min_x < BIG_I
    min_y = min_y.view(t, nseg)[:, :max_det].reshape(-1)
    min_y = torch.where(row_valid[:, 0], min_y, torch.full_like(min_y, BIG_I))
    return row_min_x, row_max_x, row_valid, min_y


def component_stats(xs, ys, seg, active, gray_vals=None, *, max_det,
                    max_bh):
    """Per-component stats of (T, F) foreground-pixel tables in any order
    (``ysmr_tpu/ops/labeling.py::component_stats``, its segment-reduction
    branch ``sorted_runs=False``; the sorted branch is a TPU layout with the
    same output).

    :param xs, ys: (T, F) int32 coordinates
    :param seg: (T, F) int32 dense component ids, ``max_det`` for the
        background and beyond capacity
    :param active: (T, F) bool
    :param gray_vals: optional (T, F) int32 gray values; with them
        ``count`` is the exact pixel count and ``lum_sum`` the gray sum of
        each component (T*max_det,) int32 (without, ``count`` is the
        row-span bound, whose only reader is the ``count > 0`` test)
    :return: the ``_stats_tail_from_tables`` dict over (T*max_det, ...)
    """
    t, f = xs.shape
    dev = xs.device
    frame = torch.arange(t, device=dev)[:, None].expand(t, f).reshape(-1)
    seg_a = torch.where(active, seg, torch.full_like(seg, max_det))
    seg_a = seg_a.reshape(-1).long()
    out = _stats_tail_from_tables(
        *_row_tables(frame, xs.reshape(-1), ys.reshape(-1), seg_a, t,
                     max_det=max_det, max_bh=max_bh))
    if gray_vals is not None:
        out['count'], out['lum_sum'] = (
            a.reshape(-1) for a in component_sums(seg, active, gray_vals,
                                                  max_det=max_det))
    return out


def component_sums(seg, active, gray_vals, *, max_det):
    """Exact pixel count and gray sum of each component of (T, F) tables
    (``seg`` = dense id, ``max_det`` = none): two (T, max_det) int32."""
    t = seg.shape[0]
    dev = seg.device
    nseg = max_det + 1
    seg_a = torch.where(active, seg, torch.full_like(seg, max_det))
    key = (seg_a + torch.arange(t, dtype=_I32, device=dev)[:, None] *
           nseg).reshape(-1).long()

    def seg_sum(vals):
        buf = torch.zeros(t * nseg, dtype=_I32, device=dev)
        buf.index_add_(0, key, vals.reshape(-1).to(_I32))
        return buf.view(t, nseg)[:, :max_det]

    return seg_sum(active), seg_sum(torch.where(active, gray_vals,
                                                torch.zeros_like(gray_vals)))


def component_stats_runs(s_start, s_len, s_comp, *, w, h, max_det, max_bh):
    """Component stats straight from component-sorted run tables.

    :param s_start, s_len: (T, R) int32 component-sorted run geometry
        (len 0 = padding)
    :param s_comp: (T, R) int32 component id per run (ids contiguous in
        table order; -1 = none)
    :return: the ``_stats_tail_from_tables`` dict over (T*max_det, ...)
    """
    return _stats_tail_from_tables(
        *run_row_tables(s_start, s_len, s_comp, w=w, h=h, max_det=max_det,
                        max_bh=max_bh))


def run_row_tables(s_start, s_len, s_comp, *, w, h, max_det, max_bh):
    """The row tables of ``component_stats_runs`` (what
    ``_stats_tail_from_tables`` reads): each component's x extremes per
    row of its box, the box's first row being that of the component's
    first run in table order (its least row: starts are ``y*w+x``), and
    that row. Rows of valid runs must be below ``h`` (the encoder's
    contract: the first row is decoded from ``bit_length(h - 1)`` bits).
    ``ops/run_cc.py::finish_components`` writes the same tables from the
    unsorted runs on the card.

    :return: (row_min_x, row_max_x) (T*max_det, max_bh) int32 (+-BIG_I
        where empty), row_valid (T*max_det, max_bh) bool and min_y
        (T*max_det,) int32 (BIG_I where there is no component)
    """
    t, r = s_start.shape
    dev = s_start.device
    valid = s_len > 0
    rows = torch.div(s_start, w, rounding_mode='floor')
    x0 = s_start - rows * w
    x1 = x0 + s_len - 1
    iota = torch.arange(r, dtype=_I32, device=dev)[None, :]
    prev_comp = torch.roll(s_comp, 1, dims=1)
    prev_valid = torch.roll(valid, 1, dims=1)
    comp_start = valid & ((iota == 0) | (s_comp != prev_comp) | ~prev_valid)
    # per-run component min-y (= the row of the component's first run):
    # ordinal-encoded cummax fill-forward
    ybits = max(int(h) - 1, 1).bit_length()
    cnum = torch.cumsum(comp_start.to(_I32), dim=1, dtype=_I32)
    enc = torch.where(comp_start, cnum * (1 << ybits) + rows,
                      torch.full_like(rows, -1))
    y0 = torch.cummax(enc, dim=1).values & ((1 << ybits) - 1)
    rel_y = torch.clamp(rows - y0, 0, max_bh - 1)
    nrow = max_det * max_bh + 1      # the last slot is the dump
    ok = valid & (s_comp >= 0) & (s_comp < max_det)
    idx = torch.where(ok, s_comp * max_bh + rel_y,
                      torch.full_like(rows, nrow - 1))
    idx = (idx + torch.arange(t, dtype=_I32, device=dev)[:, None] * nrow)
    idx = idx.reshape(-1).long()

    def scatter(src, reduce, init):
        buf = torch.full((t * nrow,), init, dtype=_I32, device=dev)
        buf.scatter_reduce_(0, idx, src.reshape(-1), reduce,
                            include_self=True)
        return buf.view(t, nrow)[:, :nrow - 1].reshape(t * max_det, max_bh)

    row_min_x = scatter(x0, 'amin', BIG_I)
    row_max_x = scatter(x1, 'amax', -BIG_I)
    y_tab = scatter(rows, 'amin', BIG_I)
    row_valid = row_min_x < BIG_I
    min_y = torch.where(row_valid[:, 0], y_tab[:, 0],
                        torch.full_like(y_tab[:, 0], BIG_I))
    return row_min_x, row_max_x, row_valid, min_y


def _stats_tail_from_tables(row_min_x, row_max_x, row_valid, min_y):
    """Row-extreme tables (D, R) -> ``count`` and the exact hull-edge
    candidates, with the tables and the hull's strict chain corners that
    the exact rect (``rect_from_tables``) and ``ops/cv2_centers.py`` read.

    Launches nothing of its own: the hull kernel forms ``abs_y = min_y +
    row`` and writes ``count`` (the row-span sum; the pixel tables replace
    it with the exact pixel count under luminosity), the edge finish the
    candidates (their plain versions on a CPU tensor). No candidate
    points are built (``candidate_points`` gives ``ysmr_tpu``'s).

    :param row_min_x, row_max_x: (D, R) int32; row_valid (D, R) bool;
        min_y (D,) int32
    :return: dict of ``count`` (D,) int32, ``min_y``, ``edge_dx``,
        ``edge_dy``, ``edge_angles``, ``edge_valid`` (D, 2 (R - 1)), the
        four tables and ``corner_l``, ``corner_r`` (D, R) bool
    """
    edge_dx, edge_dy, edge_angles, edge_valid, corner_l, corner_r, count = \
        _hull_edge_data(row_min_x, row_max_x, row_valid, min_y)
    return {'count': count, 'min_y': min_y, 'edge_dx': edge_dx,
            'edge_dy': edge_dy, 'edge_angles': edge_angles,
            'edge_valid': edge_valid, 'row_min_x': row_min_x,
            'row_max_x': row_max_x, 'row_valid': row_valid,
            'corner_l': corner_l, 'corner_r': corner_r}


def _abs_y(min_y, r):
    """abs_y = min_y + row, (D, R) int32."""
    return min_y[:, None] + torch.arange(r, dtype=_I32,
                                         device=min_y.device)[None, :]


def candidate_points(row_min_x, row_max_x, row_valid, min_y):
    """``ysmr_tpu``'s candidate points of row tables
    (``ysmr_tpu/ops/labeling.py::_stats_tail_from_tables``): every row's
    left extreme, then every row's right extreme, at y = min_y + row.
    Only plain versions build them; ``cuda_calls`` counts the calls on a
    CUDA tensor (the card's detect makes none).

    :return: pts (D, 2R, 2) float32, valid (D, 2R) bool
    """
    if min_y.is_cuda:
        candidate_points.cuda_calls += 1
    abs_y = _abs_y(min_y, row_min_x.shape[1])
    pts_x = torch.cat([row_min_x, row_max_x], dim=1).to(_F32)
    pts_y = torch.cat([abs_y, abs_y], dim=1).to(_F32)
    return (torch.stack([pts_x, pts_y], dim=-1),
            torch.cat([row_valid, row_valid], dim=1))


#: calls on a CUDA tensor since the count was last set to 0
candidate_points.cuda_calls = 0


def _fold_edge_vector(dx, dy):
    """Fold an integer edge vector to the quadrant dx > 0, dy >= 0 (the
    [0, 90) direction of its rectangle orientation class); a zero vector
    folds to (1, 0)."""
    neg = (dy < 0) | ((dy == 0) & (dx < 0))
    dx = torch.where(neg, -dx, dx)
    dy = torch.where(neg, -dy, dy)
    rot = (dx <= 0) & (dy > 0)           # rotate -90: (dx, dy) <- (dy, -dx)
    dx, dy = torch.where(rot, dy, dx), torch.where(rot, -dx, dy)
    dx = torch.where((dx == 0) & (dy == 0), torch.ones_like(dx), dx)
    return dx, dy


# fdlibm's float atanf (glibc sysdeps/ieee754/flt-32/s_atanf.c): atan of
# the breakpoints 0.5, 1, 1.5, inf split hi + lo, and the odd polynomial
_ATAN_HI = np.array([4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
                     1.5707962513e+00], np.float32)
_ATAN_LO = np.array([5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
                     7.5497894159e-08], np.float32)
_ATAN_T = np.array([3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
                    -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
                    6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
                    -3.6531571299e-02, 1.6285819933e-02], np.float32)
_PI_O_2 = np.float32(1.5707963705e+00)
_PI_LO = np.float32(-8.7422776573e-08)


def _atanf(x):
    """fdlibm's float32 atanf for finite x >= 0, one float32 rounding per
    operation in the C order (no fma)."""
    def c(v):
        return torch.tensor(np.float32(v), dtype=_F32, device=x.device)

    one, ix = c(1.0), x.view(_I32)
    # argument reduction around the breakpoints (7/16, 11/16, 19/16, 39/16)
    red = [(x * c(2.0) - one) / (c(2.0) + x), (x - one) / (x + one),
           (x - c(1.5)) / (one + c(1.5) * x), -one / x]
    bounds = (0x3ee00000, 0x3f300000, 0x3f980000, 0x401c0000)
    xr = x
    idx = torch.full_like(ix, -1)
    for i, (lo, r) in enumerate(zip(bounds, red)):
        sel = ix >= lo
        xr = torch.where(sel, r, xr)
        idx = torch.where(sel, torch.full_like(ix, i), idx)
    z = xr * xr
    w = z * z
    t = [c(v) for v in _ATAN_T]
    s1 = z * (t[0] + w * (t[2] + w * (t[4] + w * (t[6] + w * (t[8] +
                                                              w * t[10])))))
    s2 = w * (t[1] + w * (t[3] + w * (t[5] + w * (t[7] + w * t[9]))))
    small = xr - xr * (s1 + s2)
    ii = idx.clamp(min=0).long()
    hi = torch.from_numpy(_ATAN_HI).to(x.device)[ii]
    lo = torch.from_numpy(_ATAN_LO).to(x.device)[ii]
    big = hi - ((xr * (s1 + s2) - lo) - xr)
    out = torch.where(idx < 0, small, big)
    out = torch.where(ix < 0x31000000, x, out)         # |x| < 2^-29
    return torch.where(ix >= 0x4c000000, c(_ATAN_HI[3]) + c(_ATAN_LO[3]),
                       out)                            # |x| >= 2^25


def _atan2_f32(y, x):
    """fdlibm's float32 atan2f (glibc sysdeps/ieee754/flt-32/e_atan2f.c)
    for finite y >= 0 and x > 0, the folded edge vectors; XLA:CPU's float32
    atan2 gives these bits."""
    k = (y.view(_I32) - x.view(_I32)) >> 23
    z = torch.where(k > 60, torch.tensor(_PI_O_2 + np.float32(0.5) * _PI_LO,
                                         device=x.device),
                    _atanf((y / x).abs()))
    z = torch.where(x == 1.0, _atanf(y), z)
    return torch.where(y == 0.0, y, z)


def _edge_vector_finish(dx_e, dy_e, has_edge, r):
    """Fold each chain's outgoing edge vector and derive its angle; slot 0
    doubles as the always-present horizontal candidate."""
    iota = torch.arange(r - 1, device=dx_e.device)
    dx, dy = _fold_edge_vector(dx_e[:, :r - 1], dy_e[:, :r - 1])
    keep = has_edge[:, :r - 1]
    dx = torch.where(keep, dx, torch.ones_like(dx))
    dy = torch.where(keep, dy, torch.zeros_like(dy))
    ang = torch.where(keep, _atan2_f32(dy, dx), torch.zeros_like(dx))
    valid = keep | (iota[None, :] == 0)
    return dx, dy, ang, valid


def hull_edge_vectors_plain(row_min_x, row_max_x, row_valid, abs_y):
    """The contract of ``ysmr_tpu/ops/pallas_hull.py::hull_edge_vectors``,
    which ``hull_tables_plain`` (the ``csrc/hull.cu`` kernel's plain
    version) calls with abs_y formed: the slope-matrix closed form of
    ``ysmr_tpu/ops/labeling.py::_hull_edge_data`` (:794-833) before the
    angle finishing.

    Point i of the left chain (x minima) is a chain vertex iff the maximum
    slope dx/dy into it from the rows above does not exceed the minimum
    slope out of it to the rows below; its outgoing edge goes to the
    farthest row attaining that minimum. The right chain (x maxima)
    negates the slopes. Slopes are correctly rounded float32 quotients of
    exact integer differences.

    :param row_min_x, row_max_x, abs_y: (D, R) int32; row_valid (D, R) bool
    :return: (dx_l, dy_l, edge_l, dx_r, dy_r, edge_r, corner_l, corner_r):
        (D, R) float32 outgoing edge vectors (0 where the edge flag is
        False), the edge flags and the strict-corner flags (bool)
    """
    d, r = row_min_x.shape
    dev = row_min_x.device
    outs = [torch.zeros((d, r), dtype=_F32, device=dev) for _ in range(2)] + \
        [torch.zeros((d, r), dtype=torch.bool, device=dev)] + \
        [torch.zeros((d, r), dtype=_F32, device=dev) for _ in range(2)] + \
        [torch.zeros((d, r), dtype=torch.bool, device=dev) for _ in range(3)]
    act = torch.nonzero(row_valid.any(dim=1)).flatten()
    iota = torch.arange(r, device=dev)
    upper = iota[None, :] > iota[:, None]                   # j > i
    for s, e in _chunks(act.numel(), r * r):
        sel = act[s:e]
        v = row_valid[sel]
        ys = abs_y[sel].to(_F32)
        pair = v[:, :, None] & v[:, None, :] & upper[None]  # (d, i, j) i<j
        dy = ys[:, None, :] - ys[:, :, None]                # y_j - y_i
        dy_safe = torch.where(pair, dy, torch.ones_like(dy))
        chunk_out = []
        for xs, sgn in ((row_min_x, 1.0), (row_max_x, -1.0)):
            x = xs[sel].to(_F32)
            dxm = x[:, None, :] - x[:, :, None]
            slope = torch.where(pair, sgn * (dxm / dy_safe),
                                torch.full_like(dxm, BIG_F))
            out_min = slope.amin(dim=2)                     # over j > i
            in_max = torch.where(slope < BIG_F, slope,
                                 torch.full_like(slope, -BIG_F)).amax(dim=1)
            has_edge = v & (out_min >= in_max) & (out_min < BIG_F)
            strict = v & (out_min > in_max)
            # the farthest j attaining the minimum slope
            att = pair & (slope <= out_min[:, :, None])
            j_star = torch.where(att, iota[None, None, :],
                                 torch.full_like(iota, -1)[None, None, :])
            jc = j_star.amax(dim=2).clamp(0, r - 1)
            dx_e = torch.gather(x, 1, jc) - x
            dy_e = torch.gather(ys, 1, jc) - ys
            zero = torch.zeros_like(dx_e)
            chunk_out.append((torch.where(has_edge, dx_e, zero),
                              torch.where(has_edge, dy_e, zero), has_edge,
                              strict))
        (dxl, dyl, el, cl), (dxr, dyr, er, cr) = chunk_out
        for o, val in zip(outs, (dxl, dyl, el, dxr, dyr, er, cl, cr)):
            o[sel] = val
    return tuple(outs)


def edge_finish_plain(dx_l, dy_l, edge_l, dx_r, dy_r, edge_r):
    """Plain version of the ``csrc/rect.cu`` edge-finish kernel: each
    chain's R - 1 outgoing edge vectors folded, their fdlibm angles and
    validity (``_edge_vector_finish`` of the left chain, then of the right,
    concatenated).

    :param dx_l, dy_l, dx_r, dy_r: (D, R) float32; edge_l, edge_r (D, R)
        bool (``hull_edge_vectors``' outputs)
    :return: (dx, dy, angles, valid), (D, 2 (R - 1))
    """
    r = dx_l.shape[1]
    lx, ly, la, lv = _edge_vector_finish(dx_l, dy_l, edge_l, r)
    rx, ry, ra, rv = _edge_vector_finish(dx_r, dy_r, edge_r, r)
    return (torch.cat([lx, rx], dim=1), torch.cat([ly, ry], dim=1),
            torch.cat([la, ra], dim=1), torch.cat([lv, rv], dim=1))


def hull_tables_plain(row_min_x, row_max_x, row_valid, min_y):
    """Plain version of the ``csrc/hull.cu`` kernel's entry: ``abs_y =
    min_y + row`` formed, ``hull_edge_vectors_plain`` on it, and ``count``,
    the sum over the valid rows of ``row_max_x - row_min_x + 1``.

    :param row_min_x, row_max_x: (D, R) int32; row_valid (D, R) bool;
        min_y (D,) int32
    :return: ``hull_edge_vectors_plain``'s eight outputs, then count (D,)
        int32
    """
    count = torch.where(row_valid, row_max_x - row_min_x + 1,
                        torch.zeros_like(row_min_x)).sum(dim=1, dtype=_I32)
    return hull_edge_vectors_plain(
        row_min_x, row_max_x, row_valid,
        _abs_y(min_y, row_min_x.shape[1])) + (count,)


def _hull_edge_data(row_min_x, row_max_x, row_valid, min_y):
    """Exact hull-edge candidate vectors and angles of both chains.

    The slopes and ``count`` come from ``ops/hull.py::hull_edge_vectors``
    and the angle finishing from ``ops/rect.py::edge_finish`` (the CUDA
    kernels on a CUDA tensor, ``hull_tables_plain`` and
    ``edge_finish_plain`` on a CPU one).

    :return: (dx, dy, angles, valid, corner_l, corner_r, count): the first
        four (D, 2*(R-1)) folded integer edge vectors, their float32
        angles in [0, pi/2) and validity; the corners (D, R) strict
        chain-corner masks (read by the sweep and ops/cv2_centers); count
        (D,) int32
    """
    from ysmr_tpu_torch.ops import rect
    from ysmr_tpu_torch.ops.hull import hull_edge_vectors
    dxl, dyl, el, dxr, dyr, er, cl, cr, count = hull_edge_vectors(
        row_min_x, row_max_x, row_valid, min_y)
    return rect.edge_finish(dxl, dyl, el, dxr, dyr, er) + (cl, cr, count)


def _with_axis(edge_dx, edge_dy):
    """The (D, K - 1) edge candidates with the horizontal (1, 0) appended:
    the hull's closing edges (top/bottom row) are horizontal and are not
    emitted by the left/right chains."""
    one = torch.ones((edge_dx.shape[0], 1), dtype=edge_dx.dtype,
                     device=edge_dx.device)
    return (torch.cat([edge_dx, one], dim=1),
            torch.cat([edge_dy, one * 0.0], dim=1))


def sweep_tables_plain(row_min_x, row_max_x, row_valid, min_y, corner_l,
                       corner_r, edge_dx, edge_dy):
    """Plain version of the ``csrc/sweep.cu`` kernel: ``sweep_extents_plain``
    over the strict chain corners of the row tables (a left corner at
    ``row_min_x``, a right one at ``row_max_x``, y = min_y + row) along the
    K - 1 edge candidates and the appended (1, 0).

    The extents of a point set along a direction are reached at vertices
    of its convex hull, and every hull vertex of the row extremes is a
    strict corner of its chain or a chain's end, which the hull flags as a
    corner too. So these are the extents over every valid point
    (``sweep_extents_plain`` on ``candidate_points``) whenever the hull's
    float32 slopes keep distinct slopes apart: two slopes p/q and p'/q' of
    integers with |p| < W, 0 < q, q' < R differ by at least 1 / (q q'),
    more than an ulp of either while (W - 1) (R - 1) < 2^23 (1228 x 48 on
    the dense path, 1228 x 64 in frames mode).

    :param corner_l, corner_r: (D, R) bool strict-corner flags of the hull
    :param edge_dx, edge_dy: (D, K - 1) float32 edge candidates
    :return: (min_u, max_u, min_v, max_v), each (D, K) float32
    """
    pts, valid = candidate_points(row_min_x, row_max_x, row_valid, min_y)
    valid = valid & torch.cat([corner_l, corner_r], dim=1)
    return sweep_extents_plain(pts, valid, *_with_axis(edge_dx, edge_dy))


def sweep_extents_plain(pts, valid, dx, dy):
    """The contract of ``ysmr_tpu/ops/pallas_sweep.py::sweep_extents`` (the
    sweep of ``ysmr_tpu/ops/labeling.py:911-922``) on candidate points,
    which ``sweep_tables_plain`` restricts to the hull's corners: per
    component and candidate
    direction (dx, dy), the min and max of ``u = x*dx + y*dy`` and
    ``v = y*dx - x*dy`` over the valid points; (+big, -big) when a
    component has no valid point. With integer points and directions every
    product and sum is an exact float32 integer.

    :param pts: (D, P, 2) float32; valid (D, P) bool; dx, dy (D, K) float32
    :return: (min_u, max_u, min_v, max_v), each (D, K) float32
    """
    d, p = valid.shape
    k = dx.shape[1]
    dev = pts.device
    lo = torch.full((d, k), BIG_F, dtype=_F32, device=dev)
    outs = [lo, torch.full_like(lo, -BIG_F), lo.clone(),
            torch.full_like(lo, -BIG_F)]
    act = torch.nonzero(valid.any(dim=1)).flatten()
    for s, e in _chunks(act.numel(), k * p):
        sel = act[s:e]
        dxb = dx[sel][:, :, None]
        dyb = dy[sel][:, :, None]
        px = pts[sel][..., 0][:, None, :]
        py = pts[sel][..., 1][:, None, :]
        pu = px * dxb + py * dyb
        pv = py * dxb - px * dyb
        vm = valid[sel][:, None, :]
        big = torch.full_like(pu, BIG_F)
        outs[0][sel] = torch.where(vm, pu, big).amin(dim=-1)
        outs[1][sel] = torch.where(vm, pu, -big).amax(dim=-1)
        outs[2][sel] = torch.where(vm, pv, big).amin(dim=-1)
        outs[3][sel] = torch.where(vm, pv, -big).amax(dim=-1)
    return tuple(outs)


def _ds_less(ah, al, bh, bl):
    return (bh < ah) | ((bh == ah) & (bl < al))


def min_area_rect(pts, valid, edge_angles, edge_valid, edge_dx, edge_dy):
    """Exact minimum-area rectangle over integer hull-edge candidates
    (``ysmr_tpu/ops/labeling.py::_min_area_rect_exact``), on candidate
    points: ``sweep_extents_plain`` along the candidates and the appended
    (1, 0), then ``rect_select_plain``. The pipeline takes the same rect
    from the row tables (``rect_from_tables``).

    The minimal rectangle has a side collinear with a hull edge, and the
    projections onto integer edge vectors are exact float32 integers, so
    the scaled areas are exact double-single products compared exactly;
    equal areas resolve to the largest-angle candidate (cv2's calipers
    visit edges in increasing rotation and replace on <=).

    :param pts: (D, P, 2) float32 candidate points; valid (D, P) bool
    :param edge_*: (D, K - 1) candidate edge vectors, angles and validity
    :return: dict of (D,) float32 cx, cy, w, h, angle_deg (cv2's classic
        convention: degrees in [-90, 0), w along the reported angle)
    """
    extents = sweep_extents_plain(pts, valid, *_with_axis(edge_dx, edge_dy))
    cx, cy, w, h, angle_deg = rect_select_plain(
        *extents, edge_dx, edge_dy, edge_angles, edge_valid)
    return {'cx': cx, 'cy': cy, 'w': w, 'h': h, 'angle_deg': angle_deg}


#: the ``_stats_tail_from_tables`` entries the sweep reads
SWEEP_KEYS = ('row_min_x', 'row_max_x', 'row_valid', 'min_y', 'corner_l',
              'corner_r', 'edge_dx', 'edge_dy')


def rect_from_tables(tables):
    """``min_area_rect`` of every component from the stats tail's dict
    (``_stats_tail_from_tables``): the extents from the row tables at the
    hull's strict corners (``ops/sweep.py::sweep_extents``) and the choice
    (``ops/rect.py::rect_select``), the horizontal candidate (1, 0)
    implicit in both (kernels on a CUDA tensor, ``sweep_tables_plain`` and
    ``rect_select_plain`` on a CPU one).

    :return: dict of (D,) float32 cx, cy, w, h, angle_deg
    """
    from ysmr_tpu_torch.ops import rect
    from ysmr_tpu_torch.ops.sweep import sweep_extents
    extents = sweep_extents(*(tables[k] for k in SWEEP_KEYS))
    cx, cy, w, h, angle_deg = rect.rect_select(
        *extents, *(tables[k] for k in ('edge_dx', 'edge_dy', 'edge_angles',
                                        'edge_valid')))
    return {'cx': cx, 'cy': cy, 'w': w, 'h': h, 'angle_deg': angle_deg}


def rect_select_plain(min_u, max_u, min_v, max_v, edge_dx, edge_dy,
                      edge_angles, edge_valid):
    """Plain version of the ``csrc/rect.cu`` rect-select kernel:
    ``_min_area_rect_exact``'s choice after the sweep.

    :param min_u, max_u, min_v, max_v: (D, K) float32 swept extents, the
        horizontal candidate (1, 0) last
    :param edge_dx, edge_dy, edge_angles, edge_valid: (D, K - 1) of the
        hull candidates (the appended one is (1, 0), angle 0, valid)
    :return: (cx, cy, w, h, angle_deg), each (D,) float32
    """
    d, k = min_u.shape
    dev = min_u.device
    edge_dx, edge_dy = _with_axis(edge_dx, edge_dy)
    edge_angles = torch.cat(
        [edge_angles, torch.zeros((d, 1), dtype=_F32, device=dev)], dim=1)
    edge_valid = torch.cat(
        [edge_valid, torch.ones((d, 1), dtype=torch.bool, device=dev)], dim=1)
    # all-invalid components give inverted +-big extents; clamp to keep the
    # arithmetic NaN-free (their outputs are masked by det_valid later)
    du = torch.clamp(max_u - min_u, min=0.0)
    dv = torch.clamp(max_v - min_v, min=0.0)
    l2 = edge_dx * edge_dx + edge_dy * edge_dy
    a_h, a_l = ds.two_prod(du, dv)
    area_h, area_l = ds.div_by_f32(a_h, a_l, l2)
    area_h = torch.where(edge_valid, area_h, torch.full_like(area_h, BIG_F))
    area_l = torch.where(edge_valid, area_l, torch.zeros_like(area_l))

    # double-single minimum over candidates (the JAX module's pairwise
    # halving, so ties among equal pairs resolve the same way)
    mh, ml = area_h, area_l
    n = k
    while n > 1:
        half = n // 2
        if n % 2:
            lt = _ds_less(mh[:, :1], ml[:, :1], mh[:, n - 1:n],
                          ml[:, n - 1:n])
            mh = torch.cat([torch.where(lt, mh[:, n - 1:n], mh[:, :1]),
                            mh[:, 1:]], dim=1)
            ml = torch.cat([torch.where(lt, ml[:, n - 1:n], ml[:, :1]),
                            ml[:, 1:]], dim=1)
        lt = _ds_less(mh[:, :half], ml[:, :half], mh[:, half:2 * half],
                      ml[:, half:2 * half])
        mh, ml = (torch.where(lt, mh[:, half:2 * half], mh[:, :half]),
                  torch.where(lt, ml[:, half:2 * half], ml[:, :half]))
        n = half
    # ties: double-single noise is ~1e-13 relative while distinct rational
    # areas differ by >= 1/(l2_i * l2_j)
    diff_h, _ = ds.sub(area_h, area_l, mh, ml)
    tie = edge_valid & (diff_h <= mh * 1e-9 + 1e-9)
    ebest = torch.argmax(torch.where(tie, edge_angles,
                                     torch.full_like(edge_angles, -1.0)),
                         dim=1)[:, None]

    def pick(a):
        return torch.gather(a, 1, ebest)[:, 0]

    bdx, bdy, bl2 = pick(edge_dx), pick(edge_dy), pick(l2)
    bl = torch.sqrt(bl2.double()).to(_F32)   # correctly rounded, any device
    w_side = pick(du) / bl
    h_side = pick(dv) / bl
    cu2 = pick(min_u) + pick(max_u)   # 2 * scaled centre
    cv2_ = pick(min_v) + pick(max_v)
    t1h, t1l = ds.two_prod(cu2, bdx)
    t2h, t2l = ds.two_prod(cv2_, bdy)
    nxh, nxl = ds.sub(t1h, t1l, t2h, t2l)
    t3h, t3l = ds.two_prod(cu2, bdy)
    t4h, t4l = ds.two_prod(cv2_, bdx)
    nyh, nyl = ds.add(t3h, t3l, t4h, t4l)
    inv = 1.0 / (2.0 * bl2)
    cx = nxh * inv + nxl * inv
    cy = nyh * inv + nyl * inv
    # jnp.degrees(angle) - 90: one multiply by the float32 constant 180/pi,
    # which XLA contracts with the subtraction into one fma
    ang = pick(edge_angles)
    angle_deg = ds.fma_f32(ang, torch.full_like(ang, _RAD_TO_DEG),
                           torch.full_like(ang, -90.0))
    return cx, cy, h_side, w_side, angle_deg
