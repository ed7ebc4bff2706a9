"""Wrappers of the hand-written CUDA kernels for connected components and
marker reconstruction: over whole frames (frames mode) and over per-frame
foreground pixel lists (the pixel-table branch of pixels mode).

Counterparts of ``ysmr_tpu/ops/pallas_cc.py::label_components_whole_frame``,
``::binary_reconstruct`` and ``::cc_labels_at_pixels``. The kernels
(``csrc/cc.cu``) are union-find passes: over one grid of T*H*W threads
(labeling), over bit-packed masks with one thread per 32 pixels
(reconstruction), or over tiles of the T*F list slots; the source notes
the designs, what bounds them, and where they differ from the TPU kernels
(those stop after ``max_iters`` steps; the union-find always reaches the
fixpoint). The plain PyTorch versions are
``ops/labeling.py::label_components`` and ``::propagate_markers``, and
``cc_labels_at_pixels_plain`` here.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
or the call raises. Nothing falls back from the kernel to the plain
version.
"""

import torch

from ysmr_tpu_torch import _build
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


#: most pixels of one reconstruction launch, and so of one frame there. The
#: kernel indexes a launch's pixels with an int32; a batch above this goes
#: in several launches, only so that the wrapper takes any number of
#: frames (no pipeline call comes near: a 64-frame batch of 1228x922 is
#: 72.5 M pixels).
RECONSTRUCT_MAX_PIXELS = (1 << 31) - 64


def label_components_whole_frame(mask, connectivity=8, max_iters=64):
    """Connected-component labels of each frame: the minimum linear index
    ``y*w + x`` of the pixel's component, ``h*w`` on the background.

    On the CPU the plain version stops after ``max_iters`` propagation
    steps, as the JAX function does; the kernel always converges.

    :param mask: (T, H, W) bool
    :param connectivity: 4 or 8
    :return: (T, H, W) int32 labels
    """
    if mask.device.type == 'cpu':
        return label_components(mask, connectivity=connectivity,
                                max_iters=max_iters)[0]
    t, h, w = _check_masks('label_components_whole_frame', mask)
    if connectivity not in (4, 8):
        raise ValueError('label_components_whole_frame: connectivity must be '
                         '4 or 8')
    labels = torch.empty((t, h, w), dtype=torch.int32, device=mask.device)
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    rc = lib.ysmr_cc_label(mask.data_ptr(), labels.data_ptr(), t, h, w,
                           connectivity, mask.device.index, stream)
    _build.check(lib, rc, 'cc label kernel launch')
    label_components_whole_frame.launches += 1
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


#: kernel launches since the count was last set to 0
label_components_whole_frame.launches = 0
binary_reconstruct.launches = 0
cc_labels_at_pixels.launches = 0
