"""The run wire expanded to the pixel table (``ops/run_cc.py::
expand_runs``, the pixel-table branch with ``run cc = off``): the plain
version gives each frame's pixels as the packed wire holds them, and
every slot (the slots past a frame's pixels too) of ``ysmr_tpu``'s
expansion through the detect; the kernel's design (``csrc/expand_runs.cu``:
a block a frame, chunks of runs scanned with a carry, the tail rule)
emulated in numpy on the seeded wires of ``run_cc_cases.py``; the kernel
itself on the card (``-m cuda``)."""

import numpy as np
import pytest
import torch

import run_cc_cases as rcc_cases
from test_runs_wire import _random_wire
from test_torch_detect_pixels import _runs
from ysmr_tpu_torch.ops import run_cc as rcc

torch.set_num_threads(1)


def _widths(runs, counts):
    """Table widths: the longest frame's pixels, more (a tail) and fewer
    (runs cut at the table's end)."""
    total = int(max(((runs[i, :counts[i]] >> 27).astype(np.int64).sum()
                     for i in range(len(counts))), default=0))
    return sorted({max(total, 1), total + 37, max(total // 2, 1)})


def _cases():
    for name in rcc_cases.WIRE_CASES:
        runs, counts, _ = rcc_cases.run_case(name)
        yield name, runs, counts


def _emulate(runs, counts, f, double, chunk):
    """``csrc/expand_runs.cu`` in numpy: per frame the runs below the count
    in chunks of ``chunk``, each run's first slot the exclusive prefix sum
    of the lengths carried over the chunks, its slots below f written;
    then the tail past the frame's pixels."""
    t, r = runs.shape
    lin = np.full((t, f), -7, np.int32)
    marker = np.full((t, f), 2, np.uint8)
    for i in range(t):
        rc = min(max(int(counts[i]), 0), r)
        carry = 0
        for c0 in range(0, rc, chunk):
            words = runs[i, c0:min(c0 + chunk, rc)].astype(np.int64)
            lens = words >> 27
            offs = carry + np.cumsum(lens) - lens
            for word, n, off in zip(words, lens, offs):
                if n > 0 and off < f:
                    end = min(off + n, f)
                    lin[i, off:end] = (word & 0x03FFFFFF) + \
                        np.arange(end - off)
                    marker[i, off:end] = (word >> 26) & 1 if double else 0
            carry += int(lens.sum())
        if carry >= f:
            continue
        last = int(runs[i, rc - 1] if rc else runs[i, 0])
        base = (last & 0x03FFFFFF) - (carry - (last >> 27)) if rc else 1
        lin[i, carry:] = base + np.arange(carry, f)
        marker[i, carry:] = (last >> 26) & 1 if double else 0
    return lin, marker.astype(bool)


def test_expanded_pixels_are_the_packed_wire():
    """On random wires the expansion's first ``count`` slots of each frame
    are the packed wire's lins and marker bits."""
    rng = np.random.default_rng(4)
    h, w, t, f = 120, 160, 6, 2048
    packed, counts = _random_wire(rng, t, f, h, w)
    runs, rcnt = _runs(packed, counts, w)
    lin, marker = rcc.expand_runs(torch.from_numpy(runs.view(np.int32)),
                                  torch.from_numpy(rcnt), f, True)
    for i in range(t):
        n = counts[i]
        np.testing.assert_array_equal(lin[i, :n].numpy(),
                                      (packed[i, :n] & 0x7FFFFFFF))
        np.testing.assert_array_equal(marker[i, :n].numpy(),
                                      packed[i, :n] >> 31 > 0)
    lin1, marker1 = rcc.expand_runs(torch.from_numpy(runs.view(np.int32)),
                                    torch.from_numpy(rcnt), f, False)
    assert torch.equal(lin1, lin) and not bool(marker1.any())


@pytest.mark.parametrize('chunk', [1024, 7])
def test_expand_kernel_design_matches_plain(chunk):
    """The kernel's design gives the plain version's bits on every slot:
    the seeded wires (stale words past the counts, a padded frame, a full
    table, one row, one and two columns), tables wider than the pixels
    (the tail), narrower (runs cut) and a frame with no run, both
    thresholds, chunks of 1024 runs and of 7 (the carry)."""
    for name, runs, counts in _cases():
        for f in _widths(runs, counts):
            for double in (True, False):
                want = rcc.expand_runs_plain(
                    torch.from_numpy(runs.view(np.int32)),
                    torch.from_numpy(counts), f, double)
                got = _emulate(runs, counts, f, double, chunk)
                np.testing.assert_array_equal(got[0], want[0].numpy(),
                                              err_msg=name)
                np.testing.assert_array_equal(got[1], want[1].numpy(),
                                              err_msg=name)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
def test_expand_kernel_matches_plain_on_cuda():
    """The kernel against its plain version on the card, every slot bit for
    bit, one launch a call, on the design cases and on a wire of 3000
    runs a frame (three chunks); the refusals."""
    dev = _cuda()
    cases = list(_cases())
    rng = np.random.default_rng(8)
    packed, counts = _random_wire(rng, 5, 8192, 300, 400, n_blobs=400)
    runs, rcnt = _runs(packed, counts, 400, r=4096)
    assert int(rcnt.max()) > 2048
    cases.append(('many runs', runs, rcnt))
    for name, runs, counts in cases:
        args = (torch.from_numpy(runs.view(np.int32)).to(dev),
                torch.from_numpy(counts).to(dev))
        for f in _widths(runs, counts):
            for double in (True, False):
                want = rcc.expand_runs_plain(*args, f, double)
                rcc.expand_runs.launches = 0
                got = rcc.expand_runs(*args, f, double)
                torch.cuda.synchronize()
                assert rcc.expand_runs.launches == 1
                assert torch.equal(got[0], want[0]), name
                assert torch.equal(got[1], want[1]), name
    with pytest.raises(ValueError, match='int32'):
        rcc.expand_runs(args[0].to(torch.int64), args[1], 16, True)
