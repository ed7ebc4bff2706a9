"""The run wire expanded to the pixel table (``ops/run_cc.py::
expand_runs``, the pixel-table branch with ``run cc = off``): the plain
version gives each frame's pixels as the packed wire holds them, and
every slot (the slots past a frame's pixels too) of ``ysmr_tpu``'s
expansion through the detect; the kernel's design (``csrc/expand_runs.cu``:
chunk sums of the run lengths, then tiles of output slots, each finding
its runs in the chunks that cover it; the tail rule) emulated in numpy on
the seeded wires of ``run_cc_cases.py`` and the edge cases of
``table_cc_cases.py``; the kernel itself on the card (``-m cuda``)."""

import numpy as np
import pytest
import torch

import run_cc_cases as rcc_cases
import table_cc_cases as tcc_cases
from test_runs_wire import _random_wire
from test_torch_detect_pixels import _runs
from ysmr_tpu_torch.ops import run_cc as rcc

torch.set_num_threads(1)


def _widths(runs, counts):
    """Table widths: the longest frame's pixels, more (a tail) and fewer
    (runs cut at the table's end)."""
    total = int(max(((runs[i, :max(counts[i], 0)] >> 27).astype(np.int64)
                     .sum() for i in range(len(counts))), default=0))
    return sorted({max(total, 1), total + 37, max(total // 2, 1)})


def _cases():
    for name in rcc_cases.WIRE_CASES:
        runs, counts, _ = rcc_cases.run_case(name)
        yield name, runs, counts


def _emulate(runs, counts, f, double, chunk, tile=rcc.EXPAND_TILE):
    """``csrc/expand_runs.cu`` in numpy: per frame the length sums of the
    chunks of ``chunk`` runs below the count (expand_sums; with one chunk
    in the wire, none: the chunk's own scan gives the total), then per tile
    of ``tile`` slots the scan of the chunk sums for the total and the
    first chunk past the tile's start, each chunk that covers part of the
    tile scanned (inclusive prefix of its lengths), each group of four
    slots' first run found by a binary search of that prefix and the next
    slots by a step; then the tail past the frame's pixels
    (expand_tiles)."""
    t, r = runs.shape
    lin = np.full((t, f), -7, np.int64)
    marker = np.full((t, f), 2, np.uint8)
    for i in range(t):
        rc = min(max(int(counts[i]), 0), r)
        nce = -(-rc // chunk)
        words = runs[i].astype(np.int64)
        sums = [int((words[c * chunk:min((c + 1) * chunk, rc)] >> 27).sum())
                for c in range(nce)]
        incl_sums = np.cumsum(sums)
        total = int(incl_sums[-1]) if nce else 0
        last = int(words[rc - 1] if rc else (words[0] if r else 0))
        tail_base = (last & 0x03FFFFFF) + (last >> 27) - total if rc else 1
        tail_mk = (last >> 26) & 1 if double else 0
        one = r <= chunk
        for s0 in range(0, f, tile):
            s1 = min(s0 + tile, f)
            c = 0 if one else int(np.searchsorted(incl_sums, s0,
                                                  side='right'))
            coff = int(incl_sums[c] - sums[c]) if c < nce else 0
            while c < nce and (coff < s1 or one):
                cw = np.zeros(chunk, np.int64)
                n = min(chunk, rc - c * chunk)
                cw[:n] = words[c * chunk:c * chunk + n]
                incl = np.cumsum(cw >> 27)
                cend = coff + int(incl[-1])
                for g in range(s0, s1, 4):
                    j = -1
                    for sl in range(g, min(g + 4, s1)):
                        if sl < coff or sl >= cend:
                            continue
                        rel = sl - coff
                        if j < 0:
                            j = int(np.searchsorted(incl, rel, side='right'))
                        while incl[j] <= rel:
                            j += 1
                        word = int(cw[j])
                        lin[i, sl] = (word & 0x03FFFFFF) + rel - (
                            int(incl[j]) - (word >> 27))
                        marker[i, sl] = (word >> 26) & 1 if double else 0
                coff = cend
                c += 1
            for sl in range(max(s0, total), s1):
                lin[i, sl] = tail_base + sl
                marker[i, sl] = tail_mk
    return lin.astype(np.int32), marker.astype(bool)


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


@pytest.mark.parametrize('tile', [rcc.EXPAND_TILE, 5])
@pytest.mark.parametrize('chunk', [rcc.EXPAND_CHUNK, 7])
def test_expand_kernel_design_matches_plain(chunk, tile):
    """The kernel's design gives the plain version's bits on every slot:
    the seeded wires (stale words past the counts, a padded frame, a full
    table, one row, one and two columns), tables wider than the pixels
    (the tail), narrower (runs cut) and a frame with no run, both
    thresholds, chunks of 1024 runs and of 7, tiles of 2048 slots and of
    5 (runs across the chunks' and the tiles' edges)."""
    for name, runs, counts in _cases():
        for f in _widths(runs, counts):
            for double in (True, False):
                want = rcc.expand_runs_plain(
                    torch.from_numpy(runs.view(np.int32)),
                    torch.from_numpy(counts), f, double)
                got = _emulate(runs, counts, f, double, chunk, tile)
                np.testing.assert_array_equal(got[0], want[0].numpy(),
                                              err_msg=name)
                np.testing.assert_array_equal(got[1], want[1].numpy(),
                                              err_msg=name)


def _edge_args(name, tile, chunk):
    runs, counts, f = tcc_cases.expand_case(name, tile, chunk)
    return (torch.from_numpy(runs.view(np.int32)), torch.from_numpy(counts),
            f)


@pytest.mark.parametrize('scale', ['kernel', 'small'])
@pytest.mark.parametrize('name', tcc_cases.EXPAND_CASES)
def test_expand_kernel_design_on_edge_cases(name, scale):
    """The design against the plain version on the edge cases cut to the
    kernel's tiling (2048 slots, 1024 runs) and to small ones (64, 7): F
    not a multiple of the tile, runs across the tiles' edges, a run cut at
    F, the pixels filling F exactly (no tail), a frame with no run,
    counts below 0 and above R."""
    tile, chunk = ((rcc.EXPAND_TILE, rcc.EXPAND_CHUNK) if scale == 'kernel'
                   else (64, 7))
    wire, count, f = _edge_args(name, tile, chunk)
    totals = [int(((wire[i, :max(int(count[i]), 0)] >> 27) & 0x1F).sum())
              for i in range(wire.shape[0])]
    if name == 'carry_exactly_f':
        assert totals[0] == f
    if name == 'run_across_tile':
        assert totals[0] > 2 * tile and f % tile != 0
    for double in (True, False):
        want = rcc.expand_runs_plain(wire, count, f, double)
        got = _emulate(wire.numpy().view(np.uint32), count.numpy(), f,
                       double, chunk, tile)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
def test_expand_kernel_matches_plain_on_cuda():
    """The kernel against its plain version on the card, every slot bit for
    bit, one launch a call, on the design cases, on a wire of 3000 runs a
    frame (three chunks) and on the edge cases at the kernel's tiling; the
    refusals."""
    dev = _cuda()
    cases = [(name, runs, counts, _widths(runs, counts))
             for name, runs, counts in _cases()]
    rng = np.random.default_rng(8)
    packed, counts = _random_wire(rng, 5, 8192, 300, 400, n_blobs=400)
    runs, rcnt = _runs(packed, counts, 400, r=4096)
    assert int(rcnt.max()) > 2048
    cases.append(('many runs', runs, rcnt, _widths(runs, rcnt)))
    for name in tcc_cases.EXPAND_CASES:
        runs, counts, f = tcc_cases.expand_case(name, rcc.EXPAND_TILE,
                                                rcc.EXPAND_CHUNK)
        cases.append((name, runs, counts, [f]))
    for name, runs, counts, widths in cases:
        args = (torch.from_numpy(runs.view(np.int32)).to(dev),
                torch.from_numpy(counts).to(dev))
        for f in widths:
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
