"""Wrappers of the hand-written CUDA kernels for connected components and
marker reconstruction: over whole frames (frames mode) and over per-frame
foreground pixel lists (the pixel-table branch of pixels mode).

Counterparts of ``ysmr_tpu/ops/pallas_cc.py::label_components_whole_frame``,
``::binary_reconstruct`` and ``::cc_labels_at_pixels``. The kernels
(``csrc/cc.cu``) are union-find passes: over bit-packed masks with one
thread per 32 pixels (labeling and reconstruction, which share their
packing, merge and root passes), or over tiles of the T*F list slots; the
source notes the designs, what bounds them, and where they differ from
the TPU kernels (those stop after ``max_iters`` steps; the union-find
always reaches the fixpoint). The plain PyTorch versions are
``ops/labeling.py::label_components`` and ``::propagate_markers``, and
``cc_labels_at_pixels_plain`` here.

With ``use table cc``, ``cc_labels_table`` (``csrc/table_cc.cu``; plain
version ``cc_labels_table_plain``, ``ysmr_tpu``'s table route) gives the
pixel kernel's function from ``ysmr_tpu/ops/labeling.py::
label_components_table``, which has no Pallas kernel: a union-find over
the runs of each frame's lin-sorted table with no width cap.

After the pixel kernel, ``pixel_finish`` (``csrc/pixel_finish.cu``, three
launches; plain version ``pixel_finish_plain``) turns its labels into the
dense component ids and count, and on request the host-rect batch's int16
readback plane or the device rects' row tables: the torch sequence of
``ysmr_tpu``'s ``compact_ids`` and ``component_stats`` that the
pixel-table branch ran after the labels.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises. Nothing falls back from the kernel to the plain
version.
"""

import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops import labeling as lb
from ysmr_tpu_torch.ops.labeling import label_components, propagate_markers


def _check_masks(name, mask, *others):
    if mask.device.type != 'cuda':
        raise ValueError('{}: unsupported device {}'.format(name, mask.device))
    if mask.dim() != 3:
        raise ValueError('{}: masks must be (T, H, W)'.format(name))
    for a in (mask,) + others:
        if a.shape != mask.shape or a.dtype != torch.bool or \
                a.device != mask.device or not a.is_contiguous():
            raise ValueError('{}: masks must be contiguous (T, H, W) bool '
                             'tensors on {}'.format(name, mask.device))
    t, h, w = mask.shape
    if h * w >= 1 << 31:
        raise ValueError('{}: frames of 2^31 pixels or more'.format(name))
    return t, h, w


#: most pixels of one labeling launch and of one reconstruction launch, and
#: so of one frame there. The kernels index a launch's pixels with an int32;
#: a batch above this goes in several launches of whole frames, only so that
#: the wrappers take any number of frames (no pipeline call comes near: a
#: 64-frame batch of 1228x922 is 72.5 M pixels).
LABEL_MAX_PIXELS = (1 << 31) - 1
RECONSTRUCT_MAX_PIXELS = (1 << 31) - 64


def label_components_whole_frame(mask, connectivity=8, max_iters=64,
                                 return_bits=False):
    """Connected-component labels of each frame: the minimum linear index
    ``y*w + x`` of the pixel's component, ``h*w`` on the background.

    On the CPU the plain version stops after ``max_iters`` propagation
    steps, as the JAX function does; the kernel always converges.

    :param mask: (T, H, W) bool
    :param connectivity: 4 or 8
    :param return_bits: also return the mask as the kernel packs it, 32
        pixels of the flattened batch a word (bit i of word g: pixel 32 g +
        i; ``compact_row_tables``' ``fg_bits``), or None (on the CPU, and
        where the batch took several launches)
    :return: (T, H, W) int32 labels, or (labels, bits)
    """
    if mask.device.type == 'cpu':
        labels = label_components(mask, connectivity=connectivity,
                                  max_iters=max_iters)[0]
        return (labels, None) if return_bits else labels
    t, h, w = _check_masks('label_components_whole_frame', mask)
    if connectivity not in (4, 8):
        raise ValueError('label_components_whole_frame: connectivity must be '
                         '4 or 8')
    labels = torch.empty((t, h, w), dtype=torch.int32, device=mask.device)
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    step = max(1, LABEL_MAX_PIXELS // (h * w))
    # the mask as bits, 32 pixels a word; the union-find forest lives in
    # the labels themselves until the last pass writes them
    bits = torch.empty((min(step, t) * h * w + 31) // 32, dtype=torch.int32,
                       device=mask.device)
    for f0 in range(0, t, step):
        rc = lib.ysmr_cc_label(mask[f0:f0 + step].data_ptr(),
                               labels[f0:f0 + step].data_ptr(),
                               bits.data_ptr(), min(step, t - f0), h, w,
                               connectivity, mask.device.index, stream)
        _build.check(lib, rc, 'cc label kernel launch')
    label_components_whole_frame.launches += 1
    if return_bits:
        return labels, bits if step >= t else None
    return labels


def binary_reconstruct(mask, marker, max_iters=64):
    """Morphological reconstruction of ``marker`` under ``mask``
    (4-connected): a mask pixel is kept iff its 4-connected component of
    the mask holds a pixel of ``marker & mask``.

    On the CPU the plain version labels with at most ``max_iters`` steps,
    as the JAX CPU path does; the kernel always converges.

    :param mask, marker: (T, H, W) bool
    :return: (T, H, W) bool kept pixels
    """
    if mask.device.type == 'cpu':
        return propagate_markers(mask, marker, max_iters=max_iters)
    t, h, w = _check_masks('binary_reconstruct', mask, marker)
    if h * w > RECONSTRUCT_MAX_PIXELS:
        raise ValueError('binary_reconstruct: frames of more than 2^31 - 64 '
                         'pixels')
    out = torch.empty((t, h, w), dtype=torch.bool, device=mask.device)
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    step = max(1, RECONSTRUCT_MAX_PIXELS // (h * w))
    for f0 in range(0, t, step):
        n = min(step, t - f0) * h * w
        # labels are touched at the mask's pixels only; the mask and the
        # marker as bits, 32 pixels a word
        labels = torch.empty(n, dtype=torch.int32, device=mask.device)
        bits = torch.empty(2 * ((n + 31) // 32), dtype=torch.int32,
                           device=mask.device)
        rc = lib.ysmr_cc_reconstruct(
            mask[f0:f0 + step].data_ptr(), marker[f0:f0 + step].data_ptr(),
            labels.data_ptr(), bits.data_ptr(), out[f0:f0 + step].data_ptr(),
            min(step, t - f0), h, w, mask.device.index, stream)
        _build.check(lib, rc, 'cc reconstruct kernel launch')
    binary_reconstruct.launches += 1
    return out


def cc_labels_at_pixels_plain(px_x, px_y, px_valid, px_marker, *, h, w,
                              double_threshold, max_iters=64):
    """Plain version of the ``cc_labels_at_pixels`` kernel: rasterize the
    valid pixels, reconstruct the marked 4-connected components
    (``propagate_markers``), label the kept image 8-connected
    (``label_components``) and gather at the pixels. Each labeling stops
    after ``max_iters`` steps, as the JAX CPU path does.

    :return: (lab_fg, keep, steps): as ``cc_labels_at_pixels``, and (T,)
        int32 the larger step count of the two labelings (the frame
        converged iff steps < max_iters)
    """
    t, f = px_x.shape
    n = h * w
    dev = px_x.device
    lin = (torch.clamp(px_y.to(torch.int64), 0, h - 1) * w +
           torch.clamp(px_x.to(torch.int64), 0, w - 1))
    flat = lin + torch.arange(t, device=dev)[:, None] * n

    def raster(sel):
        # unselected pixels go to a dump slot past the frames
        img = torch.zeros(t * n + 1, dtype=torch.bool, device=dev)
        img[torch.where(sel, flat, torch.full_like(flat, t * n))] = True
        return img[:t * n].view(t, h, w)

    mask = raster(px_valid)
    steps = torch.zeros(t, dtype=torch.int32, device=dev)
    if double_threshold:
        lab4, steps = label_components(mask, connectivity=4,
                                       max_iters=max_iters)
        mask = propagate_markers(mask, raster(px_valid & px_marker),
                                 labels=lab4)
    lab8, steps8 = label_components(mask, connectivity=8, max_iters=max_iters)
    keep = px_valid & mask.reshape(-1)[flat]
    lab = torch.where(keep, lab8.reshape(-1)[flat],
                      torch.full((), -1, dtype=torch.int32, device=dev))
    return lab, keep, torch.maximum(steps, steps8)


#: widest frame of the pixel kernel: a 2048-slot tile and the w + 1 slots
#: before it (int32 lin and a flag each) with the tile's int32 parents fit
#: a Hopper block's 232,448 bytes of shared memory
PIXEL_MAX_WIDTH = 42802


def cc_labels_at_pixels(px_x, px_y, px_valid, px_marker, *, h, w,
                        double_threshold, max_iters=64):
    """Component labels at per-frame foreground pixel lists, with the
    marker keep flag (``ysmr_tpu/ops/pallas_cc.py::cc_labels_at_pixels``).

    On a CUDA tensor the kernel ``ysmr_cc_pixels`` (``csrc/cc.cu``): a
    union-find over the lists in tiles of slots, which always reaches the
    fixpoint. It needs the valid pixels of each frame to be a prefix of
    its list, in strictly ascending ``y*w + x`` (raster) order, as every
    wire gives them, and ``w <= PIXEL_MAX_WIDTH``. On a CPU tensor
    ``cc_labels_at_pixels_plain``.

    :param px_x, px_y: (T, F) int32 pixel coordinates
    :param px_valid, px_marker: (T, F) bool
    :return: (lab_fg, keep): (T, F) int32 the minimum linear index of the
        pixel's 8-connected component among the kept pixels, -1 for the
        others; (T, F) bool the pixel is valid and, with
        ``double_threshold``, its 4-connected component of the valid pixels
        holds a marker pixel
    """
    if px_x.device.type == 'cpu':
        return cc_labels_at_pixels_plain(
            px_x, px_y, px_valid, px_marker, h=h, w=w,
            double_threshold=double_threshold, max_iters=max_iters)[:2]
    name = 'cc_labels_at_pixels'
    if px_x.device.type != 'cuda':
        raise ValueError('{}: unsupported device {}'.format(name, px_x.device))
    if px_x.dim() != 2:
        raise ValueError('{}: pixel lists must be (T, F)'.format(name))
    for a, dt in ((px_x, torch.int32), (px_y, torch.int32),
                  (px_valid, torch.bool), (px_marker, torch.bool)):
        if a.shape != px_x.shape or a.dtype != dt or \
                a.device != px_x.device or not a.is_contiguous():
            raise ValueError('{}: expects contiguous (T, F) int32 px_x/px_y '
                             'and bool px_valid/px_marker on {}'.format(
                                 name, px_x.device))
    if h * w >= 1 << 31:
        raise ValueError('{}: frames of 2^31 pixels or more'.format(name))
    if w > PIXEL_MAX_WIDTH:
        raise ValueError('{}: frames wider than {} px (the kernel stages a '
                         'row of slots in shared memory)'.format(
                             name, PIXEL_MAX_WIDTH))
    t, f = px_x.shape
    dev = px_x.device
    # the forests over the slots: 4-connected (double threshold only) and
    # 8-connected
    forest = torch.empty((2 if double_threshold else 1, t, f),
                         dtype=torch.int32, device=dev)
    labels = torch.empty((t, f), dtype=torch.int32, device=dev)
    keep = torch.empty((t, f), dtype=torch.bool, device=dev)
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ysmr_cc_pixels(px_x.data_ptr(), px_y.data_ptr(),
                            px_valid.data_ptr(), px_marker.data_ptr(),
                            forest.data_ptr(), labels.data_ptr(),
                            keep.data_ptr(), t, f, h, w,
                            int(bool(double_threshold)), dev.index, stream)
    _build.check(lib, rc, 'cc pixels kernel launch')
    cc_labels_at_pixels.launches += 1
    return labels, keep


#: ``csrc/table_cc.cu``: slots a tile, and the most slots of a tile's
#: window (the slots within two image rows before its first lin, and its
#: own slots whose row above can reach before it) staged in shared memory
#: for the edges that leave the tile
TABLE_TILE = 2048
TABLE_WINDOW = 2048


def cc_labels_table_plain(lin, valid, px_marker, *, h, w, double_threshold,
                          max_iters=64):
    """Plain version of ``cc_labels_table``: the route of ``ysmr_tpu``'s
    pixel-table branch with ``use_table`` (``ysmr_tpu/pipeline/
    detect_pixels.py:300-323``): with the double threshold, 4-connected
    table labels of the valid entries, their ascending dense ids
    (``compact_labels_table(reverse=False)``), the marker's segment
    maximum over F + 1 segments and ``keep``; then 8-connected table
    labels of the kept entries. Each labeling stops after ``max_iters``
    steps, as ``ysmr_tpu``'s does. ``h`` is the kernel's only.

    :return: (lab_fg, keep, steps): as ``cc_labels_table``, and (T,) int32
        the larger step count of the two labelings (the frame converged
        iff steps < max_iters)
    """
    t, f = lin.shape
    big = torch.full((), lb.TABLE_BIG, dtype=torch.int32, device=lin.device)
    lin_t = torch.where(valid, lin.to(torch.int32), big)
    steps = torch.zeros(t, dtype=torch.int32, device=lin.device)
    if double_threshold:
        lab4, steps = lb.label_components_table(
            lin_t, valid, w=w, connectivity=4, max_iters=max_iters)
        comp4, _ = lb.compact_labels_table(lab4, valid, lin_t, reverse=False)
        seg = torch.clamp(comp4, max=f).long()
        marked = torch.zeros((t, f + 1), dtype=torch.int32,
                             device=lin.device)
        marked.scatter_reduce_(1, seg, (px_marker & valid).to(torch.int32),
                               'amax')
        keep = valid & (torch.gather(marked, 1, seg) > 0)
    else:
        keep = valid
    lab8, steps8 = lb.label_components_table(
        torch.where(keep, lin.to(torch.int32), big), keep, w=w,
        connectivity=8, max_iters=max_iters)
    lab = torch.where(keep, lab8, torch.full_like(lab8, -1))
    return lab, keep, torch.maximum(steps, steps8)


def cc_labels_table(lin, valid, px_marker, *, h, w, double_threshold,
                    max_iters=64, raster_prefix=False):
    """``cc_labels_at_pixels``' function from the sparse table CC of
    ``use table cc`` (``ysmr_tpu/ops/labeling.py::label_components_table``
    and ``compact_labels_table`` on ``ysmr_tpu``'s pixel-table branch).

    On a CUDA tensor the kernel ``ysmr_table_cc`` (``csrc/table_cc.cu``):
    a union-find over each frame's lin-sorted table in tiles of
    ``TABLE_TILE`` slots, each tile's edges in shared memory, the edges
    that leave a tile found in a window of keys in shared memory (at most
    ``TABLE_WINDOW`` slots; a longer one is read from global memory), the
    runs the unit of the searches, walks and marks; no frame-sized array
    and no width cap; it reaches the fixpoint (``max_iters`` is the plain
    version's).
    The valid entries
    may sit anywhere in a row and in any order: each row is sorted first
    (``torch.sort``, stable), unless ``raster_prefix`` says that the
    valid entries of each row are already a prefix in strictly ascending
    lin, as every wire of the pipeline gives them. On a CPU tensor
    ``cc_labels_table_plain``.

    :param lin: (T, F) int32 linear indices y*w + x, unique among the
        valid entries of a row
    :param valid, px_marker: (T, F) bool
    :return: (lab_fg, keep): (T, F) int32 the minimum lin of the entry's
        8-connected component among the kept entries, -1 for the others;
        (T, F) bool the entry is valid and, with ``double_threshold``, its
        4-connected component of the valid entries holds a marker
    """
    if lin.device.type == 'cpu':
        return cc_labels_table_plain(
            lin, valid, px_marker, h=h, w=w,
            double_threshold=double_threshold, max_iters=max_iters)[:2]
    name = 'cc_labels_table'
    if lin.device.type != 'cuda':
        raise ValueError('{}: unsupported device {}'.format(name, lin.device))
    if lin.dim() != 2:
        raise ValueError('{}: tables must be (T, F)'.format(name))
    for a, dt in ((lin, torch.int32), (valid, torch.bool),
                  (px_marker, torch.bool)):
        if a.shape != lin.shape or a.dtype != dt or \
                a.device != lin.device or not a.is_contiguous():
            raise ValueError('{}: expects contiguous (T, F) int32 lin and '
                             'bool valid/px_marker on {}'.format(
                                 name, lin.device))
    if h * w >= lb.TABLE_BIG:
        raise ValueError('{}: frames of 2^30 pixels or more (the invalid '
                         "entries' value)".format(name))
    t, f = lin.shape
    dev = lin.device
    if raster_prefix:
        keys, order, vptr = lin, None, valid.data_ptr()
    else:
        keys, order = torch.sort(
            torch.where(valid, lin, torch.full((), lb.TABLE_BIG,
                                               dtype=torch.int32,
                                               device=dev)),
            dim=1, stable=True)
        keys, vptr = keys.contiguous(), None
    # the forest over the sorted slots and, with the double threshold, the
    # up-left diagonal partners of the run heads
    forest = torch.empty((2 if double_threshold else 1, t, f),
                         dtype=torch.int32, device=dev)
    labels = torch.empty((t, f), dtype=torch.int32, device=dev)
    keep = torch.empty((t, f), dtype=torch.bool, device=dev)
    lib = _build.load_kernels()
    rc = lib.ysmr_table_cc(
        keys.data_ptr(), vptr, None if order is None else order.data_ptr(),
        px_marker.data_ptr(), forest.data_ptr(), labels.data_ptr(),
        keep.data_ptr(), t, f, w, int(bool(double_threshold)), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, 'table cc kernel launch')
    cc_labels_table.launches += 1
    return labels, keep


def compact_ids(lab_fg, keep, lin):
    """Dense component ids at the kept pixels, in reverse raster order of
    each component's first pixel (cv2's contour order), ``F`` elsewhere
    (``ysmr_tpu/pipeline/detect_pixels.py::compact_ids``).

    The JAX function ranks the roots (the pixels whose label is their own
    linear index) and reads the rank back through a frame-sized table; the
    lists are sorted by ``lin`` (``h*w`` past the valid prefix), so here
    each pixel finds its root's slot by a binary search instead.

    :return: (comp (T, F) int32, n_components (T,) int32)
    """
    f = lab_fg.shape[1]
    roots = keep & (lab_fg == lin)
    rank = torch.cumsum(roots.to(torch.int32), dim=1, dtype=torch.int32) - 1
    n_comp = roots.sum(dim=1, dtype=torch.int32)
    slot = torch.searchsorted(lin, torch.where(keep, lab_fg,
                                               torch.zeros_like(lab_fg)))
    comp = torch.gather(rank, 1, torch.clamp(slot, max=f - 1))
    comp = n_comp[:, None] - 1 - comp
    return torch.where(keep, comp, torch.full_like(comp, f)), n_comp


#: the row tables of ``pixel_finish`` (``run_cc.TABLE_KEYS``' order)
TABLE_KEYS = ('row_min_x', 'row_max_x', 'row_valid', 'min_y')


def _check_finish_modes(name, f, readback, row_tables):
    if readback is not None and not (
            1 <= int(readback['f']) <= f and int(readback['max_det']) >= 1):
        raise ValueError('{}: readback needs 1 <= f <= F and max_det >= '
                         '1'.format(name))
    if row_tables is not None and (int(row_tables['max_det']) < 1 or
                                   int(row_tables['max_bh']) < 1):
        raise ValueError('{}: row_tables need positive max_det and '
                         'max_bh'.format(name))


def pixel_finish_plain(lab_fg, keep, px_x, px_y, valid, *, h, w, ids=False,
                       readback=None, row_tables=None):
    """Plain version of ``pixel_finish``: the torch sequence the
    pixel-table branch ran after the labels (``compact_ids``, the
    ``det_px_idx`` where and int16 cast with ``stage_detect``'s slice,
    casts and concatenation, ``labeling.component_stats``' row tables)."""
    _check_finish_modes('pixel_finish_plain', lab_fg.shape[1], readback,
                        row_tables)
    lin = torch.where(valid, px_y * w + px_x, torch.full_like(px_x, h * w))
    comp, n_comp = compact_ids(lab_fg, keep, lin)
    out = {'n_components': n_comp}
    if ids:
        out['comp'] = comp
    if readback is not None:
        md = int(readback['max_det'])
        det = torch.where(keep & (comp < md), comp,
                          torch.full_like(comp, -1)).to(torch.int16)
        out['readback'] = torch.cat(
            [det[:, :int(readback['f'])],
             n_comp.clamp(max=32767)[:, None].to(torch.int16),
             torch.zeros_like(n_comp)[:, None].to(torch.int16)], dim=1)
    if row_tables is not None:
        md = int(row_tables['max_det'])
        t, f = comp.shape
        seg = torch.where(keep, torch.clamp(comp, max=md),
                          torch.full_like(comp, md))
        frame = torch.arange(t, device=comp.device)[:, None].expand(t, f)
        out.update(zip(TABLE_KEYS, lb._row_tables(
            frame.reshape(-1), px_x.reshape(-1), px_y.reshape(-1),
            seg.reshape(-1).long(), t, max_det=md,
            max_bh=int(row_tables['max_bh']))))
    return out


def pixel_finish(lab_fg, keep, px_x, px_y, valid, *, h, w, ids=False,
                 readback=None, row_tables=None):
    """The pixel-table branch's finish after ``cc_labels_at_pixels``.

    On a CUDA tensor the kernel ``csrc/pixel_finish.cu`` (a roots launch,
    which also fills the row tables, an offsets launch and an ids launch;
    counted as one call): no torch operation between the labels and what
    the host copies or the hull reads, and any F. It needs
    ``cc_labels_at_pixels``' contract: each frame's valid pixels a prefix
    of its list in strictly ascending ``y*w + x``, inside the frame. On a
    CPU tensor ``pixel_finish_plain``.

    :param lab_fg, keep: ``cc_labels_at_pixels``' outputs, (T, F) int32 and
        bool
    :param px_x, px_y: (T, F) int32 the pixels; valid: (T, F) bool
    :param ids: also return ``comp``
    :param readback: None, or dict(f=, max_det=): also return the
        host-rect batch's plane
    :param row_tables: None, or dict(max_det=, max_bh=): also return the
        device rects' row tables
    :return: dict with ``n_components`` (T,) int32; with ``ids`` ``comp``
        (T, F) int32 the dense id at a kept pixel (``n_components - 1 -
        rank`` of its root in raster order), F elsewhere; with
        ``readback`` ``readback`` (T, f + 2) int16: the first f pixels'
        ``comp`` where kept and below max_det, else -1, the count clamped
        to 32767, 0 (the steps); with ``row_tables`` ``TABLE_KEYS`` over
        (T * max_det, max_bh): each component's least and greatest x of
        each bbox row (``labeling.BIG_I`` and ``-BIG_I`` where none), the
        row's flag and its least y
    """
    if lab_fg.device.type == 'cpu':
        return pixel_finish_plain(lab_fg, keep, px_x, px_y, valid, h=h, w=w,
                                  ids=ids, readback=readback,
                                  row_tables=row_tables)
    name = 'pixel_finish'
    if lab_fg.device.type != 'cuda':
        raise ValueError('{}: unsupported device {}'.format(name,
                                                           lab_fg.device))
    if lab_fg.dim() != 2:
        raise ValueError('{}: pixel lists must be (T, F)'.format(name))
    for a, dt in ((lab_fg, torch.int32), (keep, torch.bool),
                  (px_x, torch.int32), (px_y, torch.int32),
                  (valid, torch.bool)):
        if a.shape != lab_fg.shape or a.dtype != dt or \
                a.device != lab_fg.device or not a.is_contiguous():
            raise ValueError('{}: expects contiguous (T, F) int32 lab_fg, '
                             'px_x, px_y and bool keep, valid on {}'.format(
                                 name, lab_fg.device))
    t, f = lab_fg.shape
    _check_finish_modes(name, f, readback, row_tables)
    dev = lab_fg.device
    lib = _build.load_kernels()
    out = {'n_components': torch.empty((t,), dtype=torch.int32, device=dev)}
    if ids:
        out['comp'] = torch.empty((t, f), dtype=torch.int32, device=dev)
    plane_f = plane_md = 0
    if readback is not None:
        plane_f, plane_md = int(readback['f']), int(readback['max_det'])
        out['readback'] = torch.empty((t, plane_f + 2), dtype=torch.int16,
                                      device=dev)
    md = mbh = 0
    if row_tables is not None:
        md, mbh = int(row_tables['max_det']), int(row_tables['max_bh'])
        for k, dt in zip(TABLE_KEYS, (torch.int32, torch.int32, torch.bool)):
            out[k] = torch.empty((t * md, mbh), dtype=dt, device=dev)
        out['min_y'] = torch.empty((t * md,), dtype=torch.int32, device=dev)

    def ptr(key):
        return out[key].data_ptr() if key in out else None

    # the tiles' lists of root lins, counts (then offsets) and first lins
    scratch = torch.empty(lib.ysmr_pixel_finish_scratch_words(t, f),
                          dtype=torch.int32, device=dev)
    rc = lib.ysmr_pixel_finish(
        lab_fg.data_ptr(), keep.data_ptr(), px_x.data_ptr(), px_y.data_ptr(),
        valid.data_ptr(), scratch.data_ptr(), ptr('n_components'),
        ptr('comp'), ptr('readback'), *(ptr(k) for k in TABLE_KEYS), t, f,
        w, plane_f, plane_md, md, mbh, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, 'pixel finish kernel launch')
    pixel_finish.launches += 1
    return out


#: kernel launches since the count was last set to 0
label_components_whole_frame.launches = 0
binary_reconstruct.launches = 0
cc_labels_at_pixels.launches = 0
cc_labels_table.launches = 0
pixel_finish.launches = 0
