"""Frames mode's compaction and row tables on the card: the kernel
``csrc/compact.cu`` (``ysmr_tpu_torch/ops/labeling.py::compact_row_tables``
on a CUDA tensor) against its plain version on the same card tensors, bit
for bit, on the seeded cases of the root module ``compact_cases.py`` that
``tests/test_torch_compact.py`` holds to ysmr_tpu on the CPU. This file
imports no JAX.

Tolerance: none. Every output is an integer minimum, maximum, count or
flag.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from compact_cases import CASES, compact_case, min_index_labels, packed_mask
from ysmr_tpu_torch.ops import labeling as lb


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES)
def test_compact_kernel_matches_plain_on_cuda(case):
    """The kernel against the plain version on the same card tensors,
    every output bit-equal, one call, the inputs untouched."""
    dev = _cuda()
    mask, max_det, max_bh = compact_case(case)
    labels = torch.from_numpy(min_index_labels(mask)).to(dev)
    tm = torch.from_numpy(mask).to(dev)
    before = labels.clone(), tm.clone()
    n = lb.compact_row_tables.launches
    got = lb.compact_row_tables(labels, tm, max_det=max_det, max_bh=max_bh)
    want = lb.compact_row_tables_plain(labels, tm, max_det=max_det,
                                       max_bh=max_bh)
    torch.cuda.synchronize()
    assert lb.compact_row_tables.launches == n + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(labels, before[0]) and torch.equal(tm, before[1])


@pytest.mark.cuda
def test_compact_kernel_on_a_labeled_batch_on_cuda():
    """The labeling kernel's labels of a 16-frame 480 x 640 batch of
    random blobs through the kernel, equal to the plain version."""
    dev = _cuda()
    from ysmr_tpu_torch.ops import cc
    rng = np.random.default_rng(3)
    mask = ndimage.binary_dilation(
        rng.random((16, 480, 640)) < 0.002, structure=np.ones((1, 3, 3)),
        iterations=3)
    tm = torch.from_numpy(mask).to(dev)
    labels = cc.label_components_whole_frame(tm, connectivity=8)
    got = lb.compact_row_tables(labels, tm, max_det=512, max_bh=64)
    want = lb.compact_row_tables_plain(labels, tm, max_det=512, max_bh=64)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[4].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES)
def test_compact_kernel_with_packed_mask_matches_plain_on_cuda(case):
    """The kernel reading the packed mask (``fg_bits``, as frames mode's
    detect hands it over) against the plain version, bit for bit, one
    call; a packed mask of another length is refused."""
    dev = _cuda()
    mask, max_det, max_bh = compact_case(case)
    labels = torch.from_numpy(min_index_labels(mask)).to(dev)
    tm = torch.from_numpy(mask).to(dev)
    bits = torch.from_numpy(packed_mask(mask)).to(dev)
    n = lb.compact_row_tables.launches
    got = lb.compact_row_tables(labels, tm, max_det=max_det, max_bh=max_bh,
                                fg_bits=bits)
    want = lb.compact_row_tables_plain(labels, tm, max_det=max_det,
                                       max_bh=max_bh)
    torch.cuda.synchronize()
    assert lb.compact_row_tables.launches == n + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    with pytest.raises(ValueError):
        lb.compact_row_tables(labels, tm, max_det=max_det, max_bh=max_bh,
                              fg_bits=bits[:-1])


@pytest.mark.cuda
def test_labeling_packs_the_mask_on_cuda():
    """``label_components_whole_frame(..., return_bits=True)``: the labels
    of the call without it and the mask packed 32 pixels a word."""
    dev = _cuda()
    from ysmr_tpu_torch.ops import cc
    mask, _, _ = compact_case('blobs')
    tm = torch.from_numpy(mask).to(dev)
    labels, bits = cc.label_components_whole_frame(tm, 8, return_bits=True)
    assert torch.equal(labels, cc.label_components_whole_frame(tm, 8))
    assert torch.equal(bits.cpu(), torch.from_numpy(packed_mask(mask)))
