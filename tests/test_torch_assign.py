"""Per-row nearest detection and greedy matching of the PyTorch port
(ysmr_tpu_torch/ops/assignment.py and the kernel wrapper ops/assign.py)
against the JAX package on the same numpy inputs.

Tolerance: none. The port's distance reproduces XLA's contracted
``sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx*dx)))`` exactly, so row minima,
argmin columns and matches are bit-equal to the jitted
``pairwise_distances`` + min/argmin that ``ysmr_tpu`` runs on the CPU.
The Pallas kernel in interpret mode does not give those bits (it sums two
rounded squares), so it is held only on its argmin columns away from
near ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ysmr_tpu.ops import assignment as jasg
from ysmr_tpu.ops.pallas_assign import row_min_argmin as jrow_pallas
from ysmr_tpu_torch.ops import assignment as asg
from ysmr_tpu_torch.ops.assign import row_min_argmin
from ysmr_tpu_torch.ops.ds import fma_f32

torch.set_num_threads(1)

_JIT_DIST = jax.jit(jasg.pairwise_distances)


def _jax_min_argmin(obj, ov, det, dv):
    m = _JIT_DIST(obj, ov, det, dv)
    return (np.asarray(jnp.min(m, axis=1)),
            np.asarray(jnp.argmin(m, axis=1)).astype(np.int32))


def _inputs(rng, r, c, k):
    obj = rng.uniform(0, 1228, (r, k)).astype(np.float32)
    det = rng.uniform(0, 1228, (c, k)).astype(np.float32)
    ov = rng.random(r) < 0.8
    dv = rng.random(c) < 0.8
    ov[0] = False
    dv[:2] = False
    if c > 6:
        det[4] = det[5]       # an exact distance tie: the first column wins
        dv[4] = dv[5] = True
        obj[1] = det[6]       # an exact zero distance
        ov[1] = dv[6] = True
    return obj, ov, det, dv


def test_fma_f32_is_exact():
    """fma_f32 equals the correctly rounded a*b + c, including float64
    sums that land exactly halfway between two float32 values."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-1e3, 1e3, 20000).astype(np.float32)
    b = rng.uniform(-1e3, 1e3, 20000).astype(np.float32)
    c = rng.uniform(-1e6, 1e6, 20000).astype(np.float32)
    # midpoint cases: c = 1 + 2^-24 style sums with a tiny product
    a[:100] = np.float32(2.0 ** -30)
    b[:100] = np.float32(1.0) + np.float32(2.0 ** -23) * rng.integers(
        1, 8, 100).astype(np.float32)
    c[:100] = np.float32(1.0) + np.float32(2.0 ** -23) * rng.integers(
        0, 8, 100).astype(np.float32)
    from fractions import Fraction
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    for i in range(0, 20000, 97):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + \
            Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # round the exact rational to float32, ties to even
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(Fraction(float(x)) - exact) for x in cands]
        best = min(errs)
        ties = [x for x, e in zip(cands, errs) if e == best]
        want = ties[0] if len(ties) == 1 else \
            [x for x in ties if not (x.view(np.int32) & 1)][0]
        assert got[i] == want, (i, a[i], b[i], c[i])
    for i in range(100):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + \
            Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(Fraction(float(x)) - exact) for x in cands]
        assert abs(Fraction(float(got[i])) - exact) == min(errs), i


def _edge_inputs(case, k):
    """Inputs that break a tiling of the rows and a split of the columns:
    ``unaligned`` R and C no multiple of the kernel's 16-row tiles or 64
    column slices; ``one`` R = C = 1; ``narrow`` fewer columns than one
    slice set; ``tie_far`` and ``tie_slice`` exact distance ties whose two
    columns lie in different column slices (far apart, and 64 apart in
    one thread's slice); ``rows_invalid`` and ``cols_invalid``."""
    rng = np.random.default_rng(len(case) * 10 + k)
    r, c = {'unaligned': (4097, 4095), 'one': (1, 1),
            'narrow': (700, 63)}.get(case, (257, 1000))
    obj, ov, det, dv = _inputs(rng, r, c, k)
    if case.startswith('tie'):
        pairs = ((3, 999), (10, 500), (0, 64)) if case == 'tie_far' else \
            ((3, 67), (10, 138), (7, 71))
        for row, (a, b) in enumerate(pairs):
            det[b] = det[a]
            dv[a] = dv[b] = True
            # the duplicated detection is the row's nearest, a tie between
            # columns a and b (the first must win)
            obj[10 + row] = det[a] + np.float32(0.25)
            ov[10 + row] = True
    elif case == 'rows_invalid':
        ov[:] = False
    elif case == 'cols_invalid':
        dv[:] = False
    return obj, ov, det, dv


EDGE_CASES = ['unaligned', 'one', 'narrow', 'tie_far', 'tie_slice',
              'rows_invalid', 'cols_invalid']


@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('r,c', [(40, 17), (128, 96), (64, 3), (4097, 4095),
                                 (1, 1), (700, 63)])
def test_row_min_argmin_bit_equal_to_jitted_xla(k, r, c):
    obj, ov, det, dv = _inputs(np.random.default_rng(r + c + k), r, c, k)
    ref_min, ref_arg = _jax_min_argmin(obj, ov, det, dv)
    got_min, got_arg = row_min_argmin(torch.from_numpy(obj),
                                      torch.from_numpy(ov),
                                      torch.from_numpy(det),
                                      torch.from_numpy(dv))
    np.testing.assert_array_equal(got_min.numpy(), ref_min)
    np.testing.assert_array_equal(got_arg.numpy(), ref_arg)
    if r * c > 1 << 16:
        return
    # the full matrix of the port equals XLA's too
    np.testing.assert_array_equal(
        asg.pairwise_distances(torch.from_numpy(obj), torch.from_numpy(ov),
                               torch.from_numpy(det),
                               torch.from_numpy(dv)).numpy(),
        np.asarray(_JIT_DIST(obj, ov, det, dv)))


@pytest.mark.parametrize('k', [2, 3])
def test_argmin_agrees_with_pallas_interpret(k):
    """The Pallas kernel rounds its distances differently, but its argmin
    columns agree wherever the row's two best distances are apart."""
    obj, ov, det, dv = _inputs(np.random.default_rng(9), 128, 96, k)
    p_min, p_arg = jrow_pallas(obj, ov, det, dv, interpret=True)
    got_min, got_arg = row_min_argmin(torch.from_numpy(obj),
                                      torch.from_numpy(ov),
                                      torch.from_numpy(det),
                                      torch.from_numpy(dv))
    m = np.asarray(_JIT_DIST(obj, ov, det, dv))
    second = np.sort(m, axis=1)[:, 1]
    clear = (second - got_min.numpy()) > 1e-3
    np.testing.assert_array_equal(got_arg.numpy()[clear],
                                  np.asarray(p_arg)[clear])
    np.testing.assert_allclose(got_min.numpy(), np.asarray(p_min),
                               rtol=1e-6)


def test_all_invalid_rows_and_columns():
    obj = np.zeros((8, 2), np.float32)
    det = np.zeros((4, 2), np.float32)
    for ov, dv in ((np.zeros(8, bool), np.ones(4, bool)),
                   (np.ones(8, bool), np.zeros(4, bool))):
        m, a = row_min_argmin(torch.from_numpy(obj), torch.from_numpy(ov),
                              torch.from_numpy(det), torch.from_numpy(dv))
        assert (m.numpy() == np.float32(asg.BIG)).all()
        assert (a.numpy() == 0).all()


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_greedy_assign_matches_jax(seed):
    """Matches and consumed columns from the same candidates, contested
    columns and invalid rows included."""
    rng = np.random.default_rng(seed)
    r, c = 50, 30
    obj = rng.uniform(0, 60, (r, 2)).astype(np.float32)
    det = rng.uniform(0, 60, (c, 2)).astype(np.float32)
    ov = rng.random(r) < 0.7
    dv = rng.random(c) < 0.8
    ref = jasg.greedy_assign(_JIT_DIST(obj, ov, det, dv), jnp.asarray(ov),
                             jnp.asarray(dv))
    row_min, cand = row_min_argmin(torch.from_numpy(obj),
                                   torch.from_numpy(ov),
                                   torch.from_numpy(det),
                                   torch.from_numpy(dv))
    got = asg.greedy_assign_from_candidates(row_min, cand,
                                            torch.from_numpy(ov),
                                            torch.from_numpy(dv))
    np.testing.assert_array_equal(got['row_to_col'].numpy(),
                                  np.asarray(ref['row_to_col']))
    np.testing.assert_array_equal(got['col_matched'].numpy(),
                                  np.asarray(ref['col_matched']))
    full = asg.greedy_assign(
        asg.pairwise_distances(torch.from_numpy(obj), torch.from_numpy(ov),
                               torch.from_numpy(det), torch.from_numpy(dv)),
        torch.from_numpy(ov), torch.from_numpy(dv))
    np.testing.assert_array_equal(full['row_to_col'].numpy(),
                                  got['row_to_col'].numpy())


@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('case', EDGE_CASES)
def test_row_min_argmin_edge_cases_bit_equal_to_jitted_xla(case, k):
    """Ties across column slices and all-invalid rows or columns: row
    minima and first minimal columns equal XLA's."""
    obj, ov, det, dv = _edge_inputs(case, k)
    ref_min, ref_arg = _jax_min_argmin(obj, ov, det, dv)
    got_min, got_arg = row_min_argmin(*(torch.from_numpy(a)
                                        for a in (obj, ov, det, dv)))
    np.testing.assert_array_equal(got_min.numpy(), ref_min)
    np.testing.assert_array_equal(got_arg.numpy(), ref_arg)
    if case.startswith('tie'):
        assert got_arg.numpy()[10:13].tolist() == \
            ([3, 10, 0] if case == 'tie_far' else [3, 10, 7])


@pytest.mark.cuda
@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('case', ['mixed'] + EDGE_CASES)
def test_kernel_matches_plain_on_cuda(case, k):
    """The assign kernel against its plain version on the card, bit for
    bit, K = 2 and 3: invalid rows and columns and exact ties at three
    shapes (``mixed``), and the edge cases of the row tiles and column
    slices; one launch counted per call. Runs on a machine with an NVIDIA
    GPU (see README)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    dev = torch.device('cuda')
    inputs = [_inputs(np.random.default_rng(r * k), r, c, k)
              for r, c in ((1000, 1500), (3, 700), (513, 1))] \
        if case == 'mixed' else [_edge_inputs(case, k)]
    for obj, ov, det, dv in inputs:
        args = [torch.from_numpy(a) for a in (obj, ov, det, dv)]
        plain = row_min_argmin(*args)
        before = row_min_argmin.launches
        got = row_min_argmin(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        assert row_min_argmin.launches == before + 1
        np.testing.assert_array_equal(got[0].cpu().numpy(),
                                      plain[0].numpy())
        np.testing.assert_array_equal(got[1].cpu().numpy(),
                                      plain[1].numpy())


def _batched_inputs(v, k, r=45, c=29, seed=0):
    """V problems with ragged validity: per video its own share of valid
    rows and detections and an exact tie; with V > 1 video 1 has no valid
    row and the last video no valid detection."""
    rng = np.random.default_rng(seed + 10 * v + k)
    obj = np.stack([_inputs(rng, r, c, k)[0] for _ in range(v)])
    det = rng.uniform(0, 1228, (v, c, k)).astype(np.float32)
    ov = rng.random((v, r)) < rng.uniform(0.3, 0.95, (v, 1))
    dv = rng.random((v, c)) < rng.uniform(0.3, 0.95, (v, 1))
    det[:, 4] = det[:, 5]
    dv[:, 4] = dv[:, 5] = True
    obj[:, 2] = det[:, 8]
    if v > 1:
        ov[1] = False
        dv[-1] = False
    return obj, ov, det, dv


def _jax_min_argmin_one(obj, ov, det, dv):
    m = jasg.pairwise_distances(obj, ov, det, dv)
    return jnp.min(m, axis=1), jnp.argmin(m, axis=1)


_JIT_VMAP_MIN_ARGMIN = jax.jit(jax.vmap(_jax_min_argmin_one))


@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('v', [1, 3, 5])
def test_batched_plain_equals_single_calls_and_jax_vmap(v, k):
    """A (V, R, K) call, through the wrapper's CPU route: bit-equal to V
    single calls and to ``jax.jit(jax.vmap(...))`` of ``ysmr_tpu``'s
    distances + min/argmin, with an all-invalid video and a video with
    no valid detection."""
    obj, ov, det, dv = _batched_inputs(v, k)
    got_min, got_arg = row_min_argmin(*(torch.from_numpy(a)
                                        for a in (obj, ov, det, dv)))
    assert tuple(got_min.shape) == tuple(got_arg.shape) == ov.shape
    assert got_min.dtype == torch.float32 and got_arg.dtype == torch.int32
    ref_min, ref_arg = _JIT_VMAP_MIN_ARGMIN(obj, ov, det, dv)
    np.testing.assert_array_equal(got_min.numpy(), np.asarray(ref_min))
    np.testing.assert_array_equal(got_arg.numpy(),
                                  np.asarray(ref_arg).astype(np.int32))
    for i in range(v):
        one_min, one_arg = row_min_argmin(*(torch.from_numpy(a[i])
                                            for a in (obj, ov, det, dv)))
        np.testing.assert_array_equal(got_min[i].numpy(), one_min.numpy())
        np.testing.assert_array_equal(got_arg[i].numpy(), one_arg.numpy())
    if v > 1:
        assert (got_min[1].numpy() == np.float32(asg.BIG)).all()
        assert (got_min[-1].numpy() == np.float32(asg.BIG)).all()
        assert (got_arg[1].numpy() == 0).all()


def test_batched_shapes_are_checked():
    """The plain version takes one problem or a batch of them, both
    operands alike; anything else raises."""
    obj, ov, det, dv = (torch.from_numpy(a) for a in _batched_inputs(3, 2))
    with pytest.raises(ValueError, match='both'):
        row_min_argmin(obj, ov, det[0], dv[0])
    with pytest.raises(ValueError, match='both'):
        row_min_argmin(obj[None], ov[None], det[None], dv[None])


def _candidates_with_ties(rng, v, r, c):
    """Per-row candidates as the kernel gives them, with many rows
    claiming one column and equal row minima (the stable rank decides)."""
    row_min = rng.integers(0, 6, (v, r)).astype(np.float32) * np.float32(0.5)
    cand = rng.integers(0, c, (v, r)).astype(np.int32)
    ov = rng.random((v, r)) < 0.8
    dv = rng.random((v, c)) < 0.8
    ov[0, :3] = True
    cand[0, :3] = 2
    row_min[0, :3] = 0.0
    dv[0, 2] = True
    row_min = np.where(ov, row_min, np.float32(asg.BIG))
    cand = np.where(ov, cand, 0).astype(np.int32)
    return row_min, cand, ov, dv


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_batched_greedy_matches_jax_vmap(seed):
    """The greedy matcher over (V, R) candidates and (V, C) detections:
    ``jax.vmap`` of ``ysmr_tpu``'s matcher, and the V single calls, on
    contested columns and tied minima."""
    rng = np.random.default_rng(seed)
    v, r, c = 4, 40, 12
    row_min, cand, ov, dv = _candidates_with_ties(rng, v, r, c)
    ref = jax.vmap(jasg.greedy_assign_from_candidates)(
        jnp.asarray(row_min), jnp.asarray(cand), jnp.asarray(ov),
        jnp.asarray(dv))
    args = [torch.from_numpy(a) for a in (row_min, cand, ov, dv)]
    got = asg.greedy_assign_from_candidates(*args)
    assert int((got['row_to_col'] >= 0).sum()) > 10
    # the three tied claimants of column 2 in video 0: the first row wins
    assert got['row_to_col'][0, :3].tolist() == [2, -1, -1]
    for key in ('row_to_col', 'col_matched'):
        assert tuple(got[key].shape) == tuple(np.asarray(ref[key]).shape)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
        for i in range(v):
            one = asg.greedy_assign_from_candidates(*(a[i] for a in args))
            assert torch.equal(one[key], got[key][i]), (key, i)


@pytest.mark.cuda
@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('case', ['ragged', 'one_video', 'no_columns'])
def test_batched_kernel_matches_plain_and_single_launches_on_cuda(case, k):
    """The batched kernel on the card: one launch for all V, bit-equal to
    its plain version and to V single launches. ``ragged``: V = 5 at
    R = 1001 (no multiple of the 16-row tiles), an all-invalid video and
    a video with no valid detection (C = 0 valid columns); ``one_video``:
    V = 1; ``no_columns``: C = 0 for the whole batch. Runs on a machine
    with an NVIDIA GPU (see README)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    dev = torch.device('cuda')
    v, r, c = {'ragged': (5, 1001, 700), 'one_video': (1, 1001, 700),
               'no_columns': (3, 77, 0)}[case]
    if c:
        arrays = _batched_inputs(v, k, r=r, c=c, seed=7)
    else:
        rng = np.random.default_rng(7)
        arrays = (rng.uniform(0, 100, (v, r, k)).astype(np.float32),
                  rng.random((v, r)) < 0.8, np.zeros((v, 0, k), np.float32),
                  np.zeros((v, 0), bool))
    args = [torch.from_numpy(a) for a in arrays]
    plain = row_min_argmin(*args)
    before = row_min_argmin.launches
    got = row_min_argmin(*(a.to(dev) for a in args))
    torch.cuda.synchronize()
    assert row_min_argmin.launches == before + 1
    for g, p in zip(got, plain):
        assert tuple(g.shape) == (v, r)
        np.testing.assert_array_equal(g.cpu().numpy(), p.numpy())
    for i in range(v):
        one = row_min_argmin(*(a[i].to(dev) for a in args))
        for g, o in zip(got, one):
            np.testing.assert_array_equal(g[i].cpu().numpy(),
                                          o.cpu().numpy())
