# Host parameters copied from ysmr_tpu/ops/gsff.py; the filter step ported.
"""Batched Gaussian-Sum FIR filter bank over padded track slots (PyTorch).

Counterpart of ``ysmr_tpu/ops/gsff.py``, whose docstring derives the
vectorised filter from the reference's per-object GaussianSumFIR
(gsff.py:28-347): log-space weights, estimates recomputed from the
measurement ring, and double-single arithmetic (``ops/ds.py``) for the
ring, the estimates and the emitted positions. ``generate_n_i``,
``compute_lsf_gain`` and ``GSFFParams`` are host numpy, copied; the
float64 gains also feed the native float64 tracker
(``native/tracker64.cpp``).

``register_and_step`` is the tracker's GSFF block: the register fill and
one step in one call, on a CUDA tensor one launch of the hand-written
kernel ``csrc/gsff.cu`` (bit-equal to ``register_and_step_plain``, the
torch sequence ``register_slots`` + ``_step``), on a CPU tensor the plain
sequence. Nothing falls back from the kernel to the plain version. The
tracker's scan calls its private twin ``_register_and_step``, which trusts
the checked tables, writes into buffers allocated once a scan
(``allocate``) and writes the step's outputs over the live slots' new and
emitted positions in the same launch (``_register_and_step_plain`` on a
CPU tensor).

Numerics: the few transcendentals (``exp``, ``log``) run in float64 and
round to float32, so the CPU and CUDA give the same bits (library float32
versions differ by an ulp); the three-filter sums are written out as adds
in the JAX module's order, never ``torch.sum``, whose association differs
between devices.
"""

import numpy as np
import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops.ds import (add as _ds_add, dot_tree as _ds_dot_tree,
                                   mul as _ds_mul, sub as _ds_sub)

LIKELIHOOD_MINIMUM = 1e-20
NEG_INF = float(np.float32(-1e30))
#: float32(log(likelihood minimum)), as the JAX module rounds it
_LOG_LIK_MIN = float(np.float32(np.log(LIKELIHOOD_MINIMUM)))

_F32 = torch.float32


def generate_n_i(n_min=0, n_max=30, n_f=3):
    """Filter horizon sizes, Eq. 17 (gsff.py:86-109)."""
    p = (n_max - n_min) / n_f
    return [int(n_min + p * i) for i in range(1, n_f + 1)]


def compute_lsf_gain(filter_size, delta_time, a=None, c=None):
    """Least-squares FIR gain for one horizon, Eq. 13/14 (gsff.py:111-153).

    Constant-velocity state model A (4x4) and position observation C (2x4).
    :return: (4, 2*filter_size) float64 gain
    """
    if a is None:
        a = np.array([[1, 0, delta_time, 0],
                      [0, 1, 0, delta_time],
                      [0, 0, 1, 0],
                      [0, 0, 0, 1]], dtype=np.float64)
    if c is None:
        c = np.array([[1, 0, 0, 0],
                      [0, 1, 0, 0]], dtype=np.float64)
    h_bar = c
    a_n = a
    for _ in range(filter_size - 1):
        h_bar = np.concatenate((h_bar, np.dot(c, a_n)), axis=0)
        a_n = np.dot(a_n, a)
    l_bar = np.dot(h_bar, np.linalg.matrix_power(np.linalg.inv(a), filter_size))
    return np.dot(np.linalg.inv(np.dot(l_bar.T, l_bar)), l_bar.T)


class GSFFParams:
    """Precomputed, padded filter-bank parameters (static per video)."""

    def __init__(self, fps, n_min=0, n_max=None, n_f=3):
        if n_max is None:
            n_max = int(fps)
        self.n_f = n_f
        self.n_i = generate_n_i(n_min=n_min, n_max=n_max, n_f=n_f)
        self.n_max = self.n_i[-1]
        self.buf_len = self.n_max + 1
        delta_t = 1.0 / fps
        # gains right-aligned into (n_f, 2, 2*n_max): gain_i consumes the last
        # n_i measurements of the flattened oldest-first window; only the
        # first two state rows (position) are ever used downstream.
        gains = np.zeros((n_f, 2, 2 * self.n_max), dtype=np.float64)
        for i, n in enumerate(self.n_i):
            if n < 1:
                continue
            g = compute_lsf_gain(n, delta_t)
            gains[i, :, 2 * (self.n_max - n):] = g[:2]
        #: float64 right-aligned gains, consumed directly by the native f64
        #: host tracker (native/tracker64.cpp)
        self.gains_f64 = gains
        # double-single representation: stacked (hi, lo) f32 pair carrying
        # the full float64 coefficients (lo = residual after f32 rounding)
        g_hi = gains.astype(np.float32)
        g_lo = (gains - g_hi.astype(np.float64)).astype(np.float32)
        #: (2, n_f, 2, 2*n_max) float32 numpy; ``gains_on`` moves it
        self.gains_ds = np.stack([g_hi, g_lo])

    def gains_on(self, device):
        """The double-single gain pair as a tensor on ``device``."""
        return torch.from_numpy(self.gains_ds).to(device)


#: the keys of a GSFF state, in the kernel's argument order
STATE_KEYS = ('buf', 'buf_lo', 'len', 'mode', 'log_w', 'pred_lo')


def init_state(params, max_slots, device):
    """Fresh per-slot GSFF state (weights kept as logs); ``buf_lo`` and
    ``pred_lo`` are the lo halves of the double-single measurement ring and
    last prediction."""
    def zeros(*shape, dtype=_F32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        'buf': zeros(max_slots, params.buf_len, 2),
        'buf_lo': zeros(max_slots, params.buf_len, 2),
        'len': zeros(max_slots, dtype=torch.int32),
        'mode': zeros(max_slots, dtype=torch.int32),
        'log_w': torch.full((max_slots, params.n_f), NEG_INF, dtype=_F32,
                            device=device),
        'pred_lo': zeros(max_slots, 2),
    }


def register_slots(state, n_i0, register_mask, measurements):
    """Initialise newly-registered slots with their first measurement
    (reference: previous_measurements = [m] * n_i[0], gsff.py:279-281; the
    whole ring is filled with m). Takes the first horizon ``n_i0``
    (``params.n_i[0]``) where the JAX function takes the bank, so the
    tracker's frame step calls it directly."""
    m = measurements.to(_F32)
    reg = register_mask[:, None, None]
    zero = torch.zeros((), dtype=_F32, device=m.device)
    return {
        'buf': torch.where(reg, m[:, None, :].expand_as(state['buf']),
                           state['buf']),
        'buf_lo': torch.where(reg, zero, state['buf_lo']),
        'len': torch.where(register_mask,
                           torch.full_like(state['len'], n_i0),
                           state['len']),
        'mode': torch.where(register_mask, torch.zeros_like(state['mode']),
                            state['mode']),
        'log_w': torch.where(register_mask[:, None],
                             torch.full_like(state['log_w'], NEG_INF),
                             state['log_w']),
        'pred_lo': torch.where(register_mask[:, None], zero,
                               state['pred_lo']),
    }


def _ds_estimates(gains_h, gains_l, center_h, center_l, buf_h, buf_l):
    """LS estimates ``center + gains @ (window - center)`` in double-single.

    :param gains_h, gains_l: (n_f, 2, 2*n_max)
    :param center_h, center_l: (S, 2)
    :param buf_h, buf_l: (S, n_max+1, 2) rings (oldest first)
    :return: (x_h, x_l) of shape (S, n_f, 2)
    """
    s = buf_h.shape[0]
    w2 = gains_h.shape[-1]
    win_h, win_l = _ds_sub(buf_h[:, 1:, :], buf_l[:, 1:, :],
                           center_h[:, None, :], center_l[:, None, :])
    win_h = win_h.reshape(s, 1, 1, w2)
    win_l = win_l.reshape(s, 1, 1, w2)
    dot_h, dot_l = _ds_dot_tree(gains_h[None], gains_l[None], win_h, win_l)
    return _ds_add(center_h[:, None, :], center_l[:, None, :], dot_h, dot_l)


def _exp(x):
    return torch.exp(x.double()).to(_F32)


def _log(x):
    return torch.log(x.double()).to(_F32)


def _sum_filters(a):
    """Sum over the filter axis (axis 1) as left-to-right adds."""
    acc = a[:, 0]
    for i in range(1, a.shape[1]):
        acc = acc + a[:, i]
    return acc


def _step(gains, n_i, n_f, state, measurements, active, measurements_lo=None):
    """One correct+predict step for all slots.

    :param gains: (2, n_f, 2, 2*n_max) double-single gain pair
    :param n_i: the filter horizons (list of ints or an int32 tensor)
    :param measurements: (S, 2) float32 — matched detection position or the
        previous prediction (hi half) for disappeared-but-alive slots
    :param measurements_lo: (S, 2) float32 or None — lo half of the
        measurement (nonzero only for coasting slots)
    :param active: (S,) bool — slots participating this frame
    :return: (new_state, corrected (S, 2), predicted (S, 2))
    """
    buf, length, mode, log_w = (state['buf'], state['len'], state['mode'],
                                state['log_w'])
    buf_lo = state['buf_lo']
    n_max = buf.shape[1] - 1
    dev = buf.device
    m = measurements.to(_F32)
    ml = torch.zeros_like(m) if measurements_lo is None \
        else measurements_lo.to(_F32)
    gains_h, gains_l = gains[0], gains[1]
    n_i_t = torch.as_tensor(n_i, dtype=torch.int32, device=dev)

    # (a) mode growth: while mode < n_f and len >= n_i[mode]
    new_mode = mode
    for _ in range(n_f):
        can_grow = (new_mode < n_f) & \
            (length >= n_i_t[torch.clamp(new_mode, 0, n_f - 1).long()])
        new_mode = new_mode + can_grow.to(torch.int32)
    grew = new_mode > mode
    filt_idx = torch.arange(n_f, dtype=torch.int32, device=dev)
    filt_active = filt_idx[None, :] < new_mode[:, None]  # (S, n_f)
    neg = torch.full_like(log_w, NEG_INF)

    # (b) weights: uniform 1/mode on transition
    uniform = -_log(torch.clamp(new_mode, min=1).to(_F32))[:, None]
    lw_in = torch.where(grew[:, None], uniform, log_w)
    lw_in = torch.where(filt_active, lw_in, neg)

    # (c) pre-append LS estimates (window = last n_max ring entries)
    x_pre_h, x_pre_l = _ds_estimates(gains_h, gains_l, buf[:, -1, :],
                                     buf_lo[:, -1, :], buf, buf_lo)

    # (d) log likelihoods vs the new measurement, floored at the log of the
    # reference's likelihood minimum
    diff_h, diff_l = _ds_sub(m[:, None, :], ml[:, None, :], x_pre_h, x_pre_l)
    sq = diff_h * diff_h + 2.0 * diff_h * diff_l             # (S, n_f, 2)
    d2 = sq[..., 0] + sq[..., 1]
    log_lik = torch.clamp(-0.5 * d2, min=_LOG_LIK_MIN)

    # (e) weight update w_i <- lik_i * w_i / sum in log space
    lw = torch.where(filt_active, lw_in + log_lik, neg)
    lw_max = lw.amax(dim=1, keepdim=True)
    lse = lw_max + _log(_sum_filters(_exp(lw - lw_max)))[:, None]
    lw_new = torch.where(filt_active, lw - lse, neg)
    w_new = torch.where(filt_active, _exp(lw_new), torch.zeros_like(lw_new))

    # (f) corrected output: weighted pre-append estimates
    zero_w = torch.zeros_like(w_new)[:, :, None]
    cw_h, cw_l = _ds_mul(x_pre_h, x_pre_l, w_new[:, :, None], zero_w)
    corr_h, corr_l = cw_h[:, 0, :], cw_l[:, 0, :]
    for i in range(1, n_f):
        corr_h, corr_l = _ds_add(corr_h, corr_l, cw_h[:, i, :], cw_l[:, i, :])
    corrected = corr_h + corr_l

    # (g) append measurement, recompute estimates, predict
    buf_new = torch.cat([buf[:, 1:, :], m[:, None, :]], dim=1)
    buf_lo_new = torch.cat([buf_lo[:, 1:, :], ml[:, None, :]], dim=1)
    x_post_h, x_post_l = _ds_estimates(gains_h, gains_l, m, ml,
                                       buf_new, buf_lo_new)
    pw_h, pw_l = _ds_mul(x_post_h, x_post_l, w_new[:, :, None], zero_w)
    pred_h, pred_l = pw_h[:, 0, :], pw_l[:, 0, :]
    for i in range(1, n_f):
        pred_h, pred_l = _ds_add(pred_h, pred_l, pw_h[:, i, :], pw_l[:, i, :])

    act = active
    out_state = {
        'buf': torch.where(act[:, None, None], buf_new, buf),
        'buf_lo': torch.where(act[:, None, None], buf_lo_new, buf_lo),
        'len': torch.where(act, torch.clamp(length + 1, max=n_max + 1),
                           length),
        'mode': torch.where(act, new_mode, mode),
        'log_w': torch.where(act[:, None], lw_new, log_w),
        'pred_lo': torch.where(act[:, None], pred_l, state['pred_lo']),
    }
    zero2 = torch.zeros_like(corrected)
    corrected = torch.where(act[:, None], corrected, zero2)
    predicted = torch.where(act[:, None], pred_h, zero2)
    return out_state, corrected, predicted


def step(params, gains, state, measurements, active, measurements_lo=None):
    """``_step`` with the bank's static parameters; ``gains`` is
    ``params.gains_on(device)``."""
    return _step(gains, params.n_i, params.n_f, state, measurements, active,
                 measurements_lo)


def register_and_step_plain(gains, n_i, n_f, n_i0, state, m, active,
                            register, coasting):
    """The tracker's GSFF block as torch calls: a coasting slot's
    measurement takes its stored ``pred_lo`` as its lo half, newly
    registered slots get a fresh state (``register_slots``), then one
    ``_step``. Contract of ``register_and_step``."""
    m_lo = torch.where(coasting[:, None], state['pred_lo'],
                       torch.zeros_like(state['pred_lo']))
    gstate = register_slots(state, n_i0, register, m)
    return _step(gains, n_i, n_f, gstate, m, active, measurements_lo=m_lo)


#: dynamic shared memory a block of ``csrc/gsff.cu`` may use (bytes)
MAX_SHARED_BYTES = 232448
#: threads a block may have
MAX_BLOCK_THREADS = 1024
#: estimates a warp of ``csrc/gsff.cu`` holds in its tree at most
KERNEL_CHUNK = 16


def kernel_shared_bytes(n_f, n_max, chunk=1):
    """Shared memory of a one-slot (one-warp) block of ``csrc/gsff.cu``
    whose tree holds ``chunk`` estimates: the slot's 4 n_f double-single
    estimates, n_f log weights and 8 n_f floats of scratch, and the tree's
    n_max rows of double-single entries, ``chunk`` (odd: ``chunk | 1``)
    wide. The launch takes the largest chunk up to ``KERNEL_CHUNK`` that
    fits."""
    return 4 * (17 * n_f + 2 * n_max * (chunk | 1))


def kernel_takes(n_f, n_max):
    """Whether the kernel takes a bank of ``n_f`` filters and longest
    horizon ``n_max`` (its cap: one slot's warp with a tree of one
    estimate must fit an SM's shared memory)."""
    return kernel_shared_bytes(n_f, n_max) <= MAX_SHARED_BYTES


def allocate(state, frames=1):
    """Output buffers of ``frames`` GSFF steps of the tracker's scan for
    the flattened GSFF ``state``: ``states``, two new states (one for a
    single frame) that the frames alternate between, and the (N, 2)
    ``corrected`` and ``predicted`` positions, rewritten each frame."""
    def like(x):
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    return {'states': tuple({k: like(state[k]) for k in STATE_KEYS}
                            for _ in range(min(frames, 2))),
            'corrected': like(state['pred_lo']),
            'predicted': like(state['pred_lo'])}


def _register_and_step_plain(gains, n_i, n_f, n_i0, state, pos, active,
                             register, coasting, *, out, frame,
                             emit_pos=None):
    """``_register_and_step`` by the plain version, on any device:
    ``register_and_step_plain`` copied into ``out``'s buffers and, with
    ``emit_pos``, the live slots' outputs written where the kernel writes
    them."""
    new_state = out['states'][frame % len(out['states'])]
    corrected, predicted = out['corrected'], out['predicted']
    got, corr, pred = register_and_step_plain(
        gains, n_i, n_f, n_i0, state, pos[:, :2], active, register, coasting)
    for key in STATE_KEYS:
        new_state[key].copy_(got[key])
    corrected.copy_(corr)
    predicted.copy_(pred)
    if emit_pos is not None:
        on = active[:, None]
        pos[:, :2] = torch.where(on, pred, pos[:, :2])
        v, s = emit_pos.shape[:2]
        emit_pos[..., :2] = torch.where(on.view(v, s, 1), corr.view(v, s, 2),
                                        emit_pos[..., :2])
    return new_state, corrected, predicted


def _register_and_step(gains, n_i, n_f, n_i0, state, pos, active, register,
                       coasting, *, out, frame, emit_pos=None):
    """``register_and_step`` on checked tensors into ``allocate``'s
    buffers ``out``, frame ``frame``: the private entry of the tracker's
    scan, which checks its tables once. The measurement is the first two
    columns of ``pos``, the new state's (N, K) positions (read at stride
    K; no copy of the slice). Returns (new_state, corrected, predicted),
    views of ``out``.

    With ``emit_pos``, the frame's (V, S, K) emitted positions (a frame of
    ``frame_step.allocate``'s emissions: unit strides over S and K, N = V
    S), the step also writes its outputs over the first two coordinates of
    the active slots: ``predicted`` over ``pos``, ``corrected`` over
    ``emit_pos`` (ysmr_tpu's ``stored_pos`` and ``emit_pos``); the other
    slots keep theirs. The kernel writes them in the same launch."""
    if pos.device.type == 'cpu':
        return _register_and_step_plain(
            gains, n_i, n_f, n_i0, state, pos, active, register, coasting,
            out=out, frame=frame, emit_pos=emit_pos)
    states = out['states']
    new_state = states[frame % len(states)]
    corrected, predicted = out['corrected'], out['predicted']
    n, n_max = state['buf'].shape[0], state['buf'].shape[1] - 1
    if n:
        dev = pos.device
        # the emitted positions: a video's slots and its stride
        em, s, vstride = (None, 1, 0) if emit_pos is None else (
            emit_pos.data_ptr(), emit_pos.shape[1], emit_pos.stride(0))
        lib = _build.load_kernels()
        rc = lib.ysmr_gsff_step(
            *(state[k].data_ptr() for k in STATE_KEYS), gains.data_ptr(),
            n_i.data_ptr(), pos.data_ptr(), active.data_ptr(),
            register.data_ptr(), coasting.data_ptr(),
            *(new_state[k].data_ptr() for k in STATE_KEYS),
            corrected.data_ptr(), predicted.data_ptr(), em, n, n_max, n_f,
            n_i0, pos.stride(0), s, vstride, dev.index,
            torch._C._cuda_getCurrentRawStream(dev.index))
        _build.check(lib, rc, 'gsff kernel launch')
        register_and_step.launches += 1
    return new_state, corrected, predicted


def check(gains, n_i, n_f, state, m=None, active=None, register=None,
          coasting=None):
    """Raise unless the tensors are what ``register_and_step`` takes: the
    bank (``gains`` (2, n_f, 2, 2 n_max) float32, ``n_i`` (n_f,) int32),
    the GSFF ``state`` of N slots (``STATE_KEYS``) and, where given, the
    (N, 2) float32 measurements and (N,) bool masks; all on one device,
    the CPU or CUDA. On CUDA also contiguous, the rings 8-byte aligned and
    the bank within the kernel's cap."""
    buf = state['buf']
    dev = buf.device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError('register_and_step: unsupported device {}'.format(
            dev))
    if buf.dim() != 3 or buf.shape[1] < 2:
        raise ValueError('register_and_step: buf must be (N, n_max+1, 2)')
    n, n_max = buf.shape[0], buf.shape[1] - 1
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    args = [('buf', buf, (n, n_max + 1, 2), f32),
            ('buf_lo', state['buf_lo'], (n, n_max + 1, 2), f32),
            ('len', state['len'], (n,), i32),
            ('mode', state['mode'], (n,), i32),
            ('log_w', state['log_w'], (n, n_f), f32),
            ('pred_lo', state['pred_lo'], (n, 2), f32),
            ('gains', gains, (2, n_f, 2, 2 * n_max), f32),
            ('n_i', n_i, (n_f,), i32)]
    if m is not None:
        args += [('m', m, (n, 2), f32),
                 ('active', active, (n,), b8),
                 ('register', register, (n,), b8),
                 ('coasting', coasting, (n,), b8)]
    for name, a, shape, dtype in args:
        if not torch.is_tensor(a) or tuple(a.shape) != shape or \
                a.dtype != dtype or a.device != dev:
            raise ValueError('register_and_step: {} must be a {} {} tensor '
                             'on {}'.format(name, shape, dtype, dev))
    if dev.type == 'cpu':
        return
    if not kernel_takes(n_f, n_max):
        raise ValueError('register_and_step: the kernel takes {} bytes of '
                         'shared memory a slot; n_f {} and n_max {} need {}'
                         .format(MAX_SHARED_BYTES, n_f, n_max,
                                 kernel_shared_bytes(n_f, n_max)))
    for name, a, _, _ in args:
        if not a.is_contiguous():
            raise ValueError('register_and_step: {} must be contiguous'
                             .format(name))
    if buf.data_ptr() % 8 or state['buf_lo'].data_ptr() % 8:
        raise ValueError('register_and_step: buf and buf_lo must be 8-byte '
                         'aligned')


def register_and_step(gains, n_i, n_f, n_i0, state, m, active, register,
                      coasting):
    """The register fill and one correct/predict step for all N slots:
    ``register_and_step_plain`` on a CPU tensor, one launch of
    ``csrc/gsff.cu`` on a CUDA tensor (bit-equal). The inputs are never
    written: every output is a new tensor. The tracker's scan, which
    checks its tables once (``check``) and writes into buffers allocated
    once a scan, calls ``_register_and_step`` instead.

    :param gains: (2, n_f, 2, 2*n_max) float32 double-single gain pair
    :param n_i: (n_f,) int32 tensor of the filter horizons
    :param n_f: filters of the bank
    :param n_i0: the first horizon, the length of a registered slot
    :param state: the GSFF state: ``buf``, ``buf_lo`` (N, n_max+1, 2)
        float32, ``len``, ``mode`` (N,) int32, ``log_w`` (N, n_f) float32,
        ``pred_lo`` (N, 2) float32
    :param m: (N, 2) float32 measurements
    :param active, register, coasting: (N,) bool: slots that step, slots
        registered this frame (filled first), slots whose measurement is
        their own prediction (its lo half re-attached)
    :return: (new_state, corrected (N, 2), predicted (N, 2))
    """
    check(gains, n_i, n_f, state, m, active, register, coasting)
    if m.device.type == 'cpu':
        return register_and_step_plain(gains, n_i, n_f, n_i0, state, m,
                                       active, register, coasting)
    return _register_and_step(gains, n_i, n_f, n_i0, state, m, active,
                              register, coasting, out=allocate(state),
                              frame=0)


#: kernel launches since the count was last set to 0
register_and_step.launches = 0
