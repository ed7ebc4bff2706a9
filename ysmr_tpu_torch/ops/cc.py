"""Wrappers of the hand-written CUDA kernels for whole-frame connected
components and marker reconstruction (frames mode).

Counterparts of ``ysmr_tpu/ops/pallas_cc.py::label_components_whole_frame``
and ``::binary_reconstruct``. The kernels (``csrc/cc.cu``) are union-find
passes over one grid of T*H*W threads; the source notes the design, what
bounds it, and where it differs from the TPU kernels (those stop after
``max_iters`` steps; the union-find always reaches the fixpoint). The plain
PyTorch versions are ``ops/labeling.py::label_components`` and
``::propagate_markers``.

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
    labels = torch.empty((t, h, w), dtype=torch.int32, device=mask.device)
    flag = torch.zeros((t, h, w), dtype=torch.bool, device=mask.device)
    out = torch.empty((t, h, w), dtype=torch.bool, device=mask.device)
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    rc = lib.ysmr_cc_reconstruct(mask.data_ptr(), marker.data_ptr(),
                                 labels.data_ptr(), flag.data_ptr(),
                                 out.data_ptr(), t, h, w, mask.device.index,
                                 stream)
    _build.check(lib, rc, 'cc reconstruct kernel launch')
    binary_reconstruct.launches += 1
    return out


#: kernel launches since the count was last set to 0
label_components_whole_frame.launches = 0
binary_reconstruct.launches = 0
