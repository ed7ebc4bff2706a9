"""The GSFF block of the port's tracker frame step
(ysmr_tpu_torch/ops/gsff.py::register_and_step: the register fill and one
correct/predict step; on a CUDA tensor one launch of csrc/gsff.cu) against
the torch sequence it replaces, ysmr_tpu's inlined fill plus ``_step``, and
an emulation of the kernel's design.

Tolerances and why:
- ``register_and_step_plain`` against ``register_slots`` + ``_step``, and
  the kernel's emulation against the plain version: bit-equal (the same
  float32 operations in the same order);
- against ysmr_tpu: ``len``, ``mode``, ``buf`` and ``buf_lo`` equal (copies
  and integer rules); log weights 1e-5 and positions 5e-4 px, the bound
  tests/test_torch_tracker.py::test_gsff_step_residue_by_innovation states
  for coordinates up to 400 px and a 1 px innovation (XLA:CPU contracts
  the double-single arithmetic into fmas and rounds float32 exp/log its
  own way; the modes' log weights then differ in their last bits, and the
  step blends modes whose estimates lie apart: up to 1.8e-4 px, six
  float32 ulps at 256-512 px, over ten seeds of these cases);
- the kernel against the plain version on the card: bit-equal.
"""

import os
import re

import numpy as np
import pytest
import torch

from test_torch_tracker import _both_steps, _random_gsff_state
from ysmr_tpu.ops import gsff as jgsff
from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops import ds
from ysmr_tpu_torch.ops import gsff

torch.set_num_threads(1)

#: the banks of the tests: the default tracking.ini's, fps 60 with the
#: horizon unset (n_max 60), a minimum horizon, one, two and four filters
BANKS = {
    'fps30': dict(fps=30.0),
    'fps60': dict(fps=60.0),
    'n_min5': dict(fps=30.0, n_min=5),
    'n_f1': dict(fps=30.0, n_f=1),
    'n_f2': dict(fps=30.0, n_f=2),
    'n_f4': dict(fps=30.0, n_f=4),
}


def _mixed_case(rng, jp, s=48, width=400):
    """A random mid-run state of ``s`` slots with matched, coasting,
    registering and inactive slots mixed, a third of the modes below what
    the ring allows (so the step grows them), lo halves on the stored
    predictions; and the frame's measurements. Numpy arrays."""
    st = _random_gsff_state(rng, s, jp, width)
    low = (rng.random(s) < 0.3) & (st['mode'] > 0)
    st['mode'] = np.where(low, rng.integers(0, np.maximum(st['mode'], 1)),
                          st['mode']).astype(np.int32)
    st['log_w'] = np.where(np.arange(jp.n_f)[None] < st['mode'][:, None],
                           st['log_w'], gsff.NEG_INF).astype(np.float32)
    st['pred_lo'] = (rng.uniform(-1, 1, (s, 2)) * 1e-6).astype(np.float32)
    kind = rng.integers(0, 4, s)   # matched, coasting, registering, inactive
    meas = (st['buf'][:, -1] + rng.normal(0, 1, (s, 2))).astype(np.float32)
    return st, meas, kind != 3, kind == 2, kind == 1


def _torch_args(tp, st, meas, active, register, coasting, device='cpu'):
    """``register_and_step``'s arguments on ``device``."""
    def put(a):
        return torch.from_numpy(np.array(a)).to(device)

    return (tp.gains_on(device),
            torch.tensor(tp.n_i, dtype=torch.int32, device=device), tp.n_f,
            tp.n_i[0], {k: put(v) for k, v in st.items()}, put(meas),
            put(active), put(register), put(coasting))


def _assert_same(got, want):
    (gst, gcor, gpred), (wst, wcor, wpred) = got, want
    assert set(gst) == set(gsff.STATE_KEYS)
    for key in gsff.STATE_KEYS:
        np.testing.assert_array_equal(np.asarray(gst[key]),
                                      np.asarray(wst[key]), err_msg=key)
    np.testing.assert_array_equal(np.asarray(gcor), np.asarray(wcor))
    np.testing.assert_array_equal(np.asarray(gpred), np.asarray(wpred))


@pytest.mark.parametrize('bank', sorted(BANKS))
def test_plain_is_the_two_call_sequence(bank):
    """``register_and_step_plain`` is bit for bit the frame step's former
    GSFF block: the coasting lo halves, ``register_slots``, ``_step``."""
    rng = np.random.default_rng(12)
    jp = jgsff.GSFFParams(**BANKS[bank])
    tp = gsff.GSFFParams(**BANKS[bank])
    gains, n_i, n_f, n_i0, state, m, active, reg, coast = _torch_args(
        tp, *_mixed_case(rng, jp))
    m_lo = torch.where(coast[:, None], state['pred_lo'],
                       torch.zeros_like(state['pred_lo']))
    want = gsff._step(gains, n_i, n_f,
                      gsff.register_slots(state, n_i0, reg, m), m, active,
                      measurements_lo=m_lo)
    got = gsff.register_and_step_plain(gains, n_i, n_f, n_i0, state, m,
                                       active, reg, coast)
    _assert_same(got, want)
    assert got[0]['len'][reg].eq(n_i0 + 1).all()


@pytest.mark.parametrize('bank', sorted(BANKS))
def test_register_and_step_matches_jax(bank):
    """The port's block against ysmr_tpu's inlined fill and ``_step`` on
    one seeded state, registering, coasting and inactive slots mixed."""
    rng = np.random.default_rng(13)
    jp = jgsff.GSFFParams(**BANKS[bank])
    tp = gsff.GSFFParams(**BANKS[bank])
    np.testing.assert_array_equal(tp.gains_ds, np.asarray(jp.gains))
    st, meas, active, reg, coast = _mixed_case(rng, jp)
    (jst, jcor, jpred), (tst, tcor, tpred) = _both_steps(
        jp, tp, st, meas, active, register=reg, coasting=coast)
    for key in ('len', 'mode', 'buf', 'buf_lo'):
        np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]),
                                      err_msg=key)
    np.testing.assert_allclose(tcor, jcor, atol=5e-4, rtol=0)
    np.testing.assert_allclose(tpred, jpred, atol=5e-4, rtol=0)
    np.testing.assert_allclose(tst['log_w'].numpy(), np.asarray(jst['log_w']),
                               atol=1e-5, rtol=1e-5)
    # every kind of slot was there, and the step grew modes: those of the
    # registered slots, and with more than one filter lowered ones
    assert active.any() and (~active).any() and reg.any() and coast.any()
    grew = active & (np.asarray(jst['mode']) > np.where(reg, 0, st['mode']))
    assert grew[reg].all()
    assert tp.n_f == 1 or grew[~reg].any()


def _flat_tree(h, l):
    """ds.dot_tree's levels as a warp of csrc/gsff.cu runs them on a
    chunk's first-level entries, (N, n, stride): row i of every column
    (estimate) at once, the rows flat. An odd level folds row n - 1 into
    row 0, then rows < half add rows half .. 2 half - 1, as passes over
    consecutive flat entries. Returns row 0, (N, stride)."""
    h, l = h.clone(), l.clone()
    n, stride = h.shape[1], h.shape[2]
    h, l = h.flatten(1), l.flatten(1)
    while n > 1:
        half = n // 2
        if n % 2:
            fold = slice((n - 1) * stride, n * stride)
            h[:, :stride], l[:, :stride] = ds.add(
                h[:, :stride], l[:, :stride], h[:, fold], l[:, fold])
        off = half * stride
        h[:, :off], l[:, :off] = ds.add(h[:, :off], l[:, :off],
                                        h[:, off:2 * off], l[:, off:2 * off])
        n = half
    return h[:, :stride], l[:, :stride]


def _emulate_kernel(gains, n_i, n_f, n_i0, state, m, active, register,
                    coasting):
    """csrc/gsff.cu's design on the CPU, slot-parallel over torch float32
    vectors: the ring read through the fill (``Slot::ring``); a warp per
    slot whose lane i forms each estimate's first level, product(i) +
    product(i + n_max), from the window's differences into row i of the
    tree, a chunk of up to ``KERNEL_CHUNK`` estimates a column each (an
    odd stride), reduced level by level over the flat rows
    (``_flat_tree``); lane g adds estimate g's center. The finish spread
    over the filters' lanes (the log likelihoods, exps and weighted
    products a filter each) and gathered in the plain order by lane 0
    (the NaN-propagating maximum, the sum) and lanes 0-3 (the four
    accumulations); the ring written a ring entry a lane."""
    n, buf_len, _ = state['buf'].shape
    n_max = buf_len - 1
    f32 = torch.float32
    zero = torch.zeros(n, dtype=f32)
    reg = register
    mh = [m[:, c] for c in range(2)]
    ml = [torch.where(coasting, state['pred_lo'][:, c], zero)
          for c in range(2)]

    def ring(q):
        """Ring float q (entry q // 2, coordinate q % 2) after the fill."""
        j, c = q // 2, q % 2
        return (torch.where(reg, mh[c], state['buf'][:, j, c]),
                torch.where(reg, zero, state['buf_lo'][:, j, c]))

    def window(post):
        """The window's 2 n_max entries minus their centers: (N, 2 n_max)
        hi and lo (before the append ring float k + 2, after it k + 4 or
        the measurement)."""
        center = [(mh[c], ml[c]) if post else ring(2 * n_max + c)
                  for c in range(2)]
        hs, ls = [], []
        for k in range(2 * n_max):
            if not post:
                v = ring(k + 2)
            else:
                v = ring(k + 4) if k < 2 * n_max - 2 else (mh[k % 2],
                                                           ml[k % 2])
            dh, dl = ds.sub(*v, *center[k % 2])
            hs.append(dh)
            ls.append(dl)
        return center, torch.stack(hs, 1), torch.stack(ls, 1)

    def first_levels(post):
        """Each (f, r)'s first level, lane i's pair: entries i and
        i + n_max, (N, n_max) hi and lo."""
        _, wh, wl = window(post)
        out = []
        for f in range(n_f):
            for r in range(2):
                ph, pl = ds.mul(gains[0, f, r][None], gains[1, f, r][None],
                                wh, wl)
                out.append(ds.add(ph[:, :n_max], pl[:, :n_max],
                                  ph[:, n_max:], pl[:, n_max:]))
        return out

    # the 4 n_f estimates in the kernel's order (before the append at
    # 2 f + r, after it at 2 n_f + 2 f + r), chunk by chunk through the
    # tree's rows; lane g adds estimate g's center
    levels = first_levels(False) + first_levels(True)
    centers = [ring(2 * n_max + r) for r in range(2)] + \
        [(mh[r], ml[r]) for r in range(2)]
    ne = 4 * n_f
    chunk = min(ne, gsff.KERNEL_CHUNK)
    stride = chunk | 1
    est = []
    for e0 in range(0, ne, chunk):
        ec = min(chunk, ne - e0)
        th = torch.zeros(n, n_max, stride, dtype=f32)
        tl = torch.zeros_like(th)
        for g in range(ec):
            th[:, :, g], tl[:, :, g] = levels[e0 + g]
        rh, rl = _flat_tree(th, tl)
        for g in range(ec):
            e = e0 + g
            c = centers[(2 if e >= 2 * n_f else 0) + e % 2]
            est.append(ds.add(*c, rh[:, g], rl[:, g]))
    pre = [[est[2 * f + r] for r in range(2)] for f in range(n_f)]
    post = [[est[2 * n_f + 2 * f + r] for r in range(2)] for f in range(n_f)]
    length = torch.where(reg, torch.full_like(state['len'], n_i0),
                         state['len'])
    mode = torch.where(reg, torch.zeros_like(state['mode']), state['mode'])
    log_w = torch.where(reg[:, None], torch.full_like(state['log_w'],
                                                      gsff.NEG_INF),
                        state['log_w'])
    grown = mode.clone()
    for _ in range(n_f):
        at = grown.clamp(0, n_f - 1).long()
        grown = grown + ((grown < n_f) & (length >= n_i[at])).to(torch.int32)
    grew = grown > mode
    uniform = -torch.log(grown.clamp(min=1).to(f32).double()).to(f32)
    # the filters' lanes
    lw = []
    for f in range(n_f):
        lw_in = torch.where(grew, uniform, log_w[:, f])
        sq = []
        for r in range(2):
            dh, dl = ds.sub(mh[r], ml[r], *pre[f][r])
            sq.append(dh * dh + (2.0 * dh) * dl)
        log_lik = -0.5 * (sq[0] + sq[1])
        log_lik = torch.where(log_lik < gsff._LOG_LIK_MIN,
                              torch.full_like(log_lik, gsff._LOG_LIK_MIN),
                              log_lik)
        lw.append(torch.where(f < grown, lw_in + log_lik,
                              torch.full_like(log_lik, gsff.NEG_INF)))
    # lane 0: the maximum, left to right
    lw_max = lw[0]
    for v in lw[1:]:
        lw_max = torch.where(torch.isnan(lw_max) | (lw_max > v), lw_max, v)
    exps = [torch.exp((v - lw_max).double()).to(f32) for v in lw]
    total = exps[0]
    for e in exps[1:]:
        total = total + e
    lse = lw_max + torch.log(total.double()).to(f32)
    lw_new, prods = [], []
    for f in range(n_f):
        v = torch.where(f < grown, lw[f] - lse,
                        torch.full_like(lse, gsff.NEG_INF))
        lw_new.append(v)
        w = torch.where(f < grown, torch.exp(v.double()).to(f32), zero)
        prods.append([ds.mul(*pre[f][r], w, zero) for r in range(2)] +
                     [ds.mul(*post[f][r], w, zero) for r in range(2)])
    # lanes 0-3: corrected r, predicted r
    acc = []
    for q in range(4):
        a = prods[0][q]
        for f in range(1, n_f):
            a = ds.add(*a, *prods[f][q])
        acc.append(a)
    out_c = [acc[r][0] + acc[r][1] for r in range(2)]
    out_p = [acc[2 + r][0] for r in range(2)]
    out_pl = [acc[2 + r][1] for r in range(2)]

    # the rings, an entry a lane
    act = active
    hs, ls = [], []
    for j in range(buf_len):
        last = act & (j == n_max)
        src = j + 1 if j < n_max else j
        h = torch.stack([torch.where(act, ring(2 * src + c)[0],
                                     ring(2 * j + c)[0]) for c in range(2)], 1)
        lo = torch.stack([torch.where(act, ring(2 * src + c)[1],
                                      ring(2 * j + c)[1]) for c in range(2)],
                         1)
        hs.append(torch.where(last[:, None], m, h))
        ls.append(torch.where(last[:, None], torch.stack(ml, 1), lo))
    out = {
        'buf': torch.stack(hs, 1),
        'buf_lo': torch.stack(ls, 1),
        'len': torch.where(act, torch.clamp(length + 1, max=n_max + 1),
                           length),
        'mode': torch.where(act, grown, mode),
        'log_w': torch.where(act[:, None], torch.stack(lw_new, 1), log_w),
        'pred_lo': torch.where(act[:, None], torch.stack(out_pl, 1),
                               torch.where(reg[:, None],
                                           torch.zeros_like(m),
                                           state['pred_lo'])),
    }
    zero2 = torch.zeros_like(m)
    return (out, torch.where(act[:, None], torch.stack(out_c, 1), zero2),
            torch.where(act[:, None], torch.stack(out_p, 1), zero2))


class _RandomBank:
    """A bank of random double-single gains where GSFFParams has none (a
    horizon of one entry makes the least-squares gain singular): the
    design's bits do not depend on what the gains mean. Duck-types
    GSFFParams for ``_mixed_case`` and ``_torch_args``."""

    def __init__(self, n_f, n_max, n_i, seed=20):
        self.n_f, self.n_max, self.n_i = n_f, n_max, list(n_i)
        self.buf_len = n_max + 1
        g = np.random.default_rng(seed).normal(0, 0.5, (n_f, 2, 2 * n_max))
        g[0, :, :2] = 0.0   # zero gains: products of -0
        hi = g.astype(np.float32)
        self.gains_ds = np.stack([hi, (g - hi).astype(np.float32)])

    def gains_on(self, device):
        return torch.from_numpy(self.gains_ds).to(device)


#: the design test's banks: four of ``BANKS``, widths on both sides of a
#: warp (n_max 33: the shared buffer folds 33 into 16; 256 with 8
#: filters: 256, 128, 64 in the buffer), and random banks of one and two
#: entries
DESIGN_BANKS = {
    **{k: BANKS[k] for k in ('fps30', 'fps60', 'n_f1', 'n_f4')},
    'n_max33': dict(fps=30.0, n_max=33),
    'n_max256_f8': dict(fps=30.0, n_max=256, n_f=8),
    'n_max1': (3, 1, (0, 1, 1)),
    'n_max2': (3, 2, (1, 1, 2)),
}


@pytest.mark.parametrize('bank', list(DESIGN_BANKS))
def test_kernel_design_matches_plain(bank):
    """The kernel's arithmetic and indexing, emulated on the CPU, give the
    plain version's bits (odd tree levels: n_max 30 folds at 15, 7, 3;
    n_max 60 at 15, 7, 3 after 30; n_max 33 at 33 in the buffer, then 2
    ... in lanes; n_max 256 halves to 32 in the buffer)."""
    rng = np.random.default_rng(14)
    spec = DESIGN_BANKS[bank]
    if isinstance(spec, dict):
        jp = jgsff.GSFFParams(**spec)
        tp = gsff.GSFFParams(**spec)
    else:
        jp = tp = _RandomBank(*spec)
    args = _torch_args(tp, *_mixed_case(rng, jp, s=24))
    _assert_same(_emulate_kernel(*args),
                 gsff.register_and_step_plain(*args))


def test_flat_tree_is_dot_tree(monkeypatch):
    """The warp's tree (the chunk's estimates as columns of flat rows)
    reduces every width from 1 to 300 to ds.dot_tree's bits in each
    column (its levels, the products taken as given), on entries with
    signed zeros, NaN and magnitudes from 1e-3 to 1e3."""
    monkeypatch.setattr(ds, 'mul', lambda gh, gl, wh, wl: (wh, wl))
    rng = np.random.default_rng(21)
    for n in list(range(1, 70)) + [127, 128, 129, 255, 256, 257, 300]:
        h = rng.normal(0, 1, (5, n, 3)) * 10.0 ** rng.integers(-3, 4,
                                                               (5, n, 3))
        h[0] = -0.0
        h[1, ::3] = 0.0
        if n > 2:
            h[2, n // 2, 1] = np.nan
        h = torch.from_numpy(h.astype(np.float32))
        l = torch.from_numpy((rng.normal(0, 1, (5, n, 3)) * 1e-8).astype(
            np.float32))
        l[0] = 0.0
        got = _flat_tree(h, l)
        for col in range(3):
            want = ds.dot_tree(None, None, h[..., col], l[..., col])
            for g, w in zip(got, want):
                np.testing.assert_array_equal(
                    g[:, col].numpy().view(np.int32),
                    w.numpy().view(np.int32), err_msg=str((n, col)))


@pytest.mark.parametrize('k', [2, 3])
def test_private_entry_writes_its_buffers(k):
    """``_register_and_step`` (the scan's entry) reads the measurement as
    the first two of K columns, writes frame f's state into buffer f % 2
    of ``allocate``'s and the positions into its corrected and predicted
    buffers, and gives the public entry's bits; the inputs stay as they
    were."""
    rng = np.random.default_rng(22)
    jp = jgsff.GSFFParams(fps=30.0)
    tp = gsff.GSFFParams(fps=30.0)
    st, meas, active, reg, coast = _mixed_case(rng, jp)
    pos = np.concatenate([meas, rng.uniform(0, 9, (len(meas), k - 2)).astype(
        np.float32)], 1)
    args = _torch_args(tp, st, meas, active, reg, coast)
    gains, n_i, n_f, n_i0, state = args[:5]
    before = {key: x.clone() for key, x in state.items()}
    want = gsff.register_and_step(*args)
    out = gsff.allocate(state, frames=3)
    assert len(out['states']) == 2
    for frame in (0, 1, 2):
        got = gsff._register_and_step(
            gains, n_i, n_f, n_i0, state, torch.from_numpy(pos), *args[6:],
            out=out, frame=frame)
        _assert_same(got, want)
        for key in gsff.STATE_KEYS:
            assert got[0][key] is out['states'][frame % 2][key]
        assert got[1] is out['corrected'] and got[2] is out['predicted']
    for key, x in before.items():
        assert torch.equal(state[key], x)


def test_wrapper_takes_the_plain_route_on_the_cpu():
    """A CPU call is the plain version's, launches nothing, and leaves its
    inputs as they were."""
    rng = np.random.default_rng(15)
    jp = jgsff.GSFFParams(fps=30.0)
    tp = gsff.GSFFParams(fps=30.0)
    args = _torch_args(tp, *_mixed_case(rng, jp))
    before = {k: v.clone() for k, v in args[4].items()}
    gsff.register_and_step.launches = 0
    got = gsff.register_and_step(*args)
    assert gsff.register_and_step.launches == 0
    _assert_same(got, gsff.register_and_step_plain(*args))
    for k, v in before.items():
        assert torch.equal(args[4][k], v)


def _broken(case, args):
    """``register_and_step``'s arguments with one defect."""
    gains, n_i, n_f, n_i0, state, m, active, reg, coast = args
    state = dict(state)
    if case == 'buf_width':
        state['buf'] = state['buf'][..., :1]
    elif case == 'buf_lo_length':
        state['buf_lo'] = state['buf_lo'][:, 1:]
    elif case == 'log_w_filters':
        state['log_w'] = state['log_w'][:, 1:]
    elif case == 'gains_width':
        gains = gains[..., 2:]
    elif case == 'n_i_length':
        n_i = n_i[1:]
    elif case == 'm_rows':
        m = m[1:]
    elif case == 'm_float64':
        m = m.double()
    elif case == 'len_int64':
        state['len'] = state['len'].long()
    elif case == 'active_uint8':
        active = active.to(torch.uint8)
    elif case == 'm_meta':
        m = m.to('meta')
    elif case == 'all_meta':
        gains, n_i, m, active, reg, coast = (
            x.to('meta') for x in (gains, n_i, m, active, reg, coast))
        state = {k: v.to('meta') for k, v in state.items()}
    return gains, n_i, n_f, n_i0, state, m, active, reg, coast


@pytest.mark.parametrize('case', [
    'buf_width', 'buf_lo_length', 'log_w_filters', 'gains_width',
    'n_i_length', 'm_rows', 'm_float64', 'len_int64', 'active_uint8',
    'm_meta', 'all_meta'])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """A wrong shape, type or device raises, on the CPU too; so does a
    device that is neither the CPU nor CUDA."""
    rng = np.random.default_rng(16)
    jp = jgsff.GSFFParams(fps=30.0)
    tp = gsff.GSFFParams(fps=30.0)
    args = _broken(case, _torch_args(tp, *_mixed_case(rng, jp, s=8)))
    with pytest.raises(ValueError):
        gsff.register_and_step(*args)


def test_kernel_cap_and_constants():
    """The cap: a one-warp (one-slot) block whose tree holds one estimate
    within the shared memory of an SM; n_max 256 with 8 filters is inside
    it, n_max 28988 the widest at 8 filters, 29030 at 3, 3418 filters at
    n_max 1. The launch's chunk of 16 estimates (stride 17) fits the
    default bank 8 warps a block. The kernel's constants are the
    module's."""
    assert gsff.kernel_takes(8, 256) and gsff.kernel_takes(3, 29030)
    assert gsff.kernel_shared_bytes(8, 28988) <= gsff.MAX_SHARED_BYTES < \
        gsff.kernel_shared_bytes(8, 28989)
    assert not gsff.kernel_takes(8, 28989) and \
        not gsff.kernel_takes(3, 29031)
    assert gsff.kernel_takes(3418, 1) and not gsff.kernel_takes(3419, 1)
    # the tree's rows are odd: a chunk of 12 is 13 wide
    assert gsff.kernel_shared_bytes(3, 30, 12) == 4 * (17 * 3 + 2 * 30 * 13)
    assert 8 * gsff.kernel_shared_bytes(3, 30, gsff.KERNEL_CHUNK) <= \
        gsff.MAX_SHARED_BYTES
    with open(os.path.join(_build.CSRC_DIR, 'gsff.cu')) as f:
        src = f.read()

    def const(name):
        return re.search(r'constexpr \w+ {} = ([^;]+);'.format(name),
                         src).group(1)

    assert int(const('kMaxShared')) == gsff.MAX_SHARED_BYTES
    assert int(const('kMaxThreads')) == gsff.MAX_BLOCK_THREADS
    assert int(const('kChunk')) == gsff.KERNEL_CHUNK
    assert float.fromhex(const('kNegInf').rstrip('f')) == gsff.NEG_INF
    assert float.fromhex(const('kLogLikMin').rstrip('f')) == \
        gsff._LOG_LIK_MIN


def test_plain_route_has_no_cap():
    """Past the kernel's cap a CPU call still runs (the plain version):
    8 filters over n_max 28989, random gains."""
    rng = np.random.default_rng(17)
    n, n_f, n_max = 3, 8, 28989
    state = {'buf': torch.from_numpy(rng.uniform(0, 9, (n, n_max + 1, 2))
                                     .astype(np.float32)),
             'buf_lo': torch.zeros(n, n_max + 1, 2),
             'len': torch.full((n,), n_max, dtype=torch.int32),
             'mode': torch.zeros(n, dtype=torch.int32),
             'log_w': torch.full((n, n_f), gsff.NEG_INF),
             'pred_lo': torch.zeros(n, 2)}
    gains = torch.from_numpy(rng.normal(0, 1e-3, (2, n_f, 2, 2 * n_max))
                             .astype(np.float32))
    n_i = torch.arange(1, n_f + 1, dtype=torch.int32) * 100
    ones = torch.ones(n, dtype=torch.bool)
    out, cor, pred = gsff.register_and_step(
        gains, n_i, n_f, 100, state, state['buf'][:, -1], ones, ~ones,
        ~ones)
    assert out['mode'].eq(n_f).all() and torch.isfinite(pred).all()


def _on_cpu(result):
    state, corrected, predicted = result
    return ({k: v.cpu() for k, v in state.items()}, corrected.cpu(),
            predicted.cpu())


#: the card's cases: (name, slots, bank, kind of slots, coordinate span)
CUDA_CASES = {
    'n1': (1, dict(fps=30.0), 'mixed', 400),
    'n4095': (4095, dict(fps=30.0), 'mixed', 400),
    'n4096': (4096, dict(fps=30.0), 'mixed', 400),
    'v4x1024': (4 * 1024, dict(fps=30.0), 'mixed', 1228),
    'all_inactive': (4096, dict(fps=30.0), 'inactive', 400),
    'all_registering': (4096, dict(fps=30.0), 'registering', 400),
    'bank256x8': (1024, dict(fps=30.0, n_max=256, n_f=8), 'mixed', 400),
    'n_max33': (1024, dict(fps=30.0, n_max=33), 'mixed', 400),
    'n_max64': (1024, dict(fps=30.0, n_max=64), 'mixed', 400),
    'wide1e4': (4096, dict(fps=30.0), 'mixed', 1e4),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CUDA_CASES))
def test_kernel_bit_equal_to_plain_on_cuda(case):
    """csrc/gsff.cu against the plain version on the same card tensors:
    every state tensor and both outputs bit-equal, one launch a call, the
    inputs untouched; coordinates up to 1228 px, and in +-1e4 px."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    n, bank, kind, span = CUDA_CASES[case]
    rng = np.random.default_rng(18)
    jp = jgsff.GSFFParams(**bank)
    tp = gsff.GSFFParams(**bank)
    st, meas, active, reg, coast = _mixed_case(rng, jp, s=n,
                                               width=min(span, 1228))
    if span > 1228:
        shift = rng.uniform(-span, span - 1228, (n, 1)).astype(np.float32)
        st['buf'] = (st['buf'] + shift[:, None]).astype(np.float32)
        meas = (meas + shift).astype(np.float32)
    if kind == 'inactive':
        active[:] = reg[:] = coast[:] = False
    elif kind == 'registering':
        active[:] = reg[:] = True
        coast[:] = False
    args = _torch_args(tp, st, meas, active, reg, coast, device='cuda')
    before = {k: v.clone() for k, v in args[4].items()}
    gsff.register_and_step.launches = 0
    got = gsff.register_and_step(*args)
    want = gsff.register_and_step_plain(*args)
    torch.cuda.synchronize()
    assert gsff.register_and_step.launches == 1
    _assert_same(_on_cpu(got), _on_cpu(want))
    for k, v in before.items():
        assert torch.equal(args[4][k], v)


@pytest.mark.cuda
def test_kernel_cap_on_cuda():
    """At the cap (8 filters, n_max 28988, random gains) the kernel runs
    and equals the plain version; one past it the wrapper raises."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rng = np.random.default_rng(19)
    n, n_f = 64, 8
    for n_max, fits in ((28988, True), (28989, False)):
        state = {'buf': torch.from_numpy(
                     rng.uniform(0, 99, (n, n_max + 1, 2)).astype(
                         np.float32)).cuda(),
                 'buf_lo': torch.zeros(n, n_max + 1, 2, device='cuda'),
                 'len': torch.from_numpy(rng.integers(
                     0, n_max + 2, n).astype(np.int32)).cuda(),
                 'mode': torch.zeros(n, dtype=torch.int32, device='cuda'),
                 'log_w': torch.full((n, n_f), gsff.NEG_INF, device='cuda'),
                 'pred_lo': torch.zeros(n, 2, device='cuda')}
        gains = torch.from_numpy(rng.normal(0, 1e-3, (
            2, n_f, 2, 2 * n_max)).astype(np.float32)).cuda()
        n_i = torch.arange(1, n_f + 1, dtype=torch.int32,
                           device='cuda') * 113
        act = torch.ones(n, dtype=torch.bool, device='cuda')
        args = (gains, n_i, n_f, 113, state, state['buf'][:, -1] + 0.5,
                act, ~act, ~act)
        if not fits:
            with pytest.raises(ValueError):
                gsff.register_and_step(*args)
            continue
        got = gsff.register_and_step(*args)
        want = gsff.register_and_step_plain(*args)
        torch.cuda.synchronize()
        _assert_same(_on_cpu(got), _on_cpu(want))
