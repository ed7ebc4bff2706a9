"""Run-graph connected components on compact run tables (PyTorch).

Counterpart of ``ysmr_tpu/ops/run_cc.py``; its module docstring sets out the
edge set and why the fixpoint partition is exact. Thresholded masks arrive
as horizontal runs (native ``encode_runs_batch``); two runs in adjacent rows
connect iff their x-intervals overlap (dilated by one pixel for
8-connectivity), same-row runs iff exactly consecutive, plus the
window-intersection shortcuts. Min-label propagation over the (T, R) run
tables labels the components; the same propagation, started from marked
runs at their own index and unmarked ones at index + R, performs the
double-threshold marker reconstruction.

Differences from the JAX module, all of representation:

- The uint32 wire travels as its int32 view (torch has few uint32 ops);
  every right shift is masked, because the arithmetic shift of a word with
  bit 31 set goes negative.
- Window lookups use batched ``torch.searchsorted`` (the JAX sort-merge
  exists only because gathers are slow on the TPU).
- The multi-operand ``lax.sort`` compaction becomes a stable sort of the
  key followed by gathers.
- Index tensors are int64 for ``gather``; labels stay int32.
- Each propagation also returns its per-frame step count, so callers can
  assert convergence (the result depends on the schedule until the fixpoint
  is reached; converged <=> steps < max_iters).
- ``det_px_from_runs``'s scatter of the run starts goes to one dump slot
  past the table instead of JAX's dropped out-of-bounds indices.
- The steps around the two propagations are three wrappers, each with a
  plain version made of the torch operations above: ``prepare_runs``
  (decode, windows, links; with ``frame_valid``, JAX's ``rc_eff`` too),
  ``compact_kept_runs`` (the compaction between the propagations) and
  ``finish_components`` (ids, scatter, counts and, for the device rects,
  the row tables of ``ops/labeling.py::component_stats_runs``, or for
  the host rects the readback plane of ``readback_plane``: JAX's
  ``det_run_idx``, the count and the steps). On a CUDA tensor each
  launches two hand-written kernels of ``csrc/run_cc.cu``, bit-equal to
  its plain version; a CPU tensor takes the plain version. The
  component-sorted runs (``sorted_runs``) are the plain version's only:
  the finish writes the row tables from the unsorted runs.
- ``expand_runs``, the run wire expanded to the pixel table for the
  pixel-table branch (``ysmr_tpu``'s inline expansion in
  ``detect_from_pixels``), is one launch of ``csrc/expand_runs.cu`` on a
  CUDA tensor and ``expand_runs_plain`` on a CPU tensor.
"""

import ctypes

import torch

from ysmr_tpu_torch import _build
from ysmr_tpu_torch.ops import labeling

#: sentinel larger than any real sort key (keys are < 2^22 after packing)
_BIG = 1 << 28
_I32 = torch.int32


def decode_runs(px_runs, run_counts, w):
    """Unpack the run wire into per-run geometry tables.

    :param px_runs: (T, R) int32 view of the uint32 wire — bits 0..25 start
        ``y*w+x``, bit 26 marker, bits 27..31 length 1..31
    :param run_counts: (T,) int32 valid runs per frame (valid = prefix)
    :param w: frame width (runs never cross row boundaries)
    :return: dict of (T, R) int32 ``rows, xs, xe, lens`` + bool
        ``rmark, valid``
    """
    t, r = px_runs.shape
    runs = px_runs.to(_I32)
    starts = runs & 0x03FFFFFF
    rmark = ((runs >> 26) & 1) > 0
    lens = (runs >> 27) & 0x1F
    iota = torch.arange(r, dtype=_I32, device=runs.device)
    valid = iota[None, :] < run_counts.to(_I32)[:, None]
    valid = valid & (lens > 0)
    rows = torch.div(starts, w, rounding_mode='floor')
    xs = starts - rows * w
    return {'rows': rows, 'xs': xs, 'xe': xs + lens - 1, 'lens': lens,
            'rmark': rmark & valid, 'valid': valid}


def run_windows_multi(geo, *, dilates):
    """Overlap-window endpoints into the adjacent rows, per run.

    :param geo: decode_runs output plus ``key_m``
    :param dilates: tuple of dilations (1 for 8-connectivity, 0 for 4)
    :return: one dict per dilation with lo_up, hi_up, ok_up, lo_dn, hi_dn,
        ok_dn — (T, R) int32 / bool; indices point into the same
        (raster-ordered) run table
    """
    rows, xs, xe, valid = geo['rows'], geo['xs'], geo['xe'], geo['valid']
    m = geo['key_m']
    base = rows * m
    big = torch.full_like(base, _BIG)
    # valid runs are a raster-ordered prefix, so both keys ascend per row
    key_e = torch.where(valid, base + xe, big)
    key_s = torch.where(valid, base + xs, big)
    q_lo = torch.cat([q for d in dilates
                      for q in ((base - m) + (xs - d), (base + m) + (xs - d))],
                     dim=1)
    q_hi = torch.cat([q for d in dilates
                      for q in ((base - m) + (xe + d), (base + m) + (xe + d))],
                     dim=1)
    r = rows.shape[1]
    # lo = #runs ending before the query start; hi = last run starting at
    # or before the query end
    lo_all = torch.searchsorted(key_e, q_lo, out_int32=True)
    hi_all = torch.searchsorted(key_s, q_hi, right=True, out_int32=True) - 1
    outs = []
    for k, _ in enumerate(dilates):
        lo_up = lo_all[:, 2 * k * r:(2 * k + 1) * r]
        lo_dn = lo_all[:, (2 * k + 1) * r:(2 * k + 2) * r]
        hi_up = hi_all[:, 2 * k * r:(2 * k + 1) * r]
        hi_dn = hi_all[:, (2 * k + 1) * r:(2 * k + 2) * r]
        outs.append({'lo_up': lo_up, 'hi_up': hi_up,
                     'ok_up': valid & (lo_up <= hi_up),
                     'lo_dn': lo_dn, 'hi_dn': hi_dn,
                     'ok_dn': valid & (lo_dn <= hi_dn)})
    return outs


def run_windows(geo, *, dilate):
    """Single-dilation convenience wrapper over run_windows_multi."""
    return run_windows_multi(geo, dilates=(dilate,))[0]


def _nxt(a, fill):
    return torch.cat([a[:, 1:], torch.full_like(a[:, :1], fill)], dim=1)


def chain_mask(geo, win):
    """(T, R) bool: run i is linked to run i+1 (last column False).

    Links: exactly-consecutive same-row runs (wire splits of one maximal
    run), plus the window-intersection shortcut (both directions).
    """
    rows, xs, xe, valid = geo['rows'], geo['xs'], geo['xe'], geo['valid']
    same_row = valid & _nxt(valid, False) & (_nxt(rows, -1) == rows)
    consec = same_row & (_nxt(xs, -1) == xe + 1)
    cut_up = same_row & win['ok_up'] & _nxt(win['ok_up'], False) & \
        (win['hi_up'] >= _nxt(win['lo_up'], -1))
    cut_dn = same_row & win['ok_dn'] & _nxt(win['ok_dn'], False) & \
        (win['hi_dn'] >= _nxt(win['lo_dn'], -1))
    return consec | cut_up | cut_dn


def propagate_min(init, win, link, *, max_iters=64):
    """Min-label fixpoint over the run graph: the plain PyTorch version of
    the ``csrc/run_prop.cu`` kernel (``ops/run_prop.py``).

    Each step relaxes one hop along the same-row chain edges, takes the four
    adjacent-row window endpoints, and path-halves through ``label mod R``
    (a run inside the same component; labels >= R carry the weak class of
    the marker reconstruction). Steps repeat until one changes nothing, at
    most ``max_iters`` times.

    :param init: (T, R) int32 initial labels
    :param win: run_windows output
    :param link: chain_mask output
    :return: ((T, R) int32 labels, (T,) int32 steps that changed a label —
        the frame converged iff steps < max_iters)
    """
    t, r = init.shape
    idx4 = torch.cat([win['lo_up'], win['hi_up'], win['lo_dn'],
                      win['hi_dn']], dim=1).clamp(0, r - 1).long()
    ok4 = torch.cat([win['ok_up'], win['ok_up'], win['ok_dn'],
                     win['ok_dn']], dim=1)
    big = 2 ** 30
    link_l = torch.cat([torch.zeros_like(link[:, :1]), link[:, :-1]], dim=1)
    big_tr = torch.full_like(init, big)
    big_4 = torch.full_like(idx4, big, dtype=init.dtype)

    def step(lab):
        nxt = _nxt(lab, big)
        prv = torch.cat([torch.full_like(lab[:, :1], big), lab[:, :-1]],
                        dim=1)
        lab = torch.minimum(lab, torch.minimum(
            torch.where(link, nxt, big_tr), torch.where(link_l, prv, big_tr)))
        v4 = torch.where(ok4, torch.gather(lab, 1, idx4), big_4)
        lab = torch.minimum(lab, v4.view(t, 4, r).amin(dim=1))
        tgt = torch.where(lab >= r, lab - r, lab).clamp(0, r - 1).long()
        return torch.minimum(lab, torch.gather(lab, 1, tgt))

    lab = init.to(_I32)
    steps = torch.zeros(t, dtype=_I32, device=init.device)
    for _ in range(max_iters):
        new = step(lab)
        changed = (new != lab).any(dim=1)
        lab = new
        if not bool(changed.any()):
            break
        steps += changed.to(_I32)
    return lab, steps


def _prepare(px_runs, run_counts, *, w):
    geo = decode_runs(px_runs, run_counts, w)
    geo['key_m'] = w + 2
    return geo


def _make_prop():
    """The propagation wrapper: the CUDA kernel for CUDA tensors, this
    module's plain ``propagate_min`` for CPU tensors (ops/run_prop.py)."""
    from ysmr_tpu_torch.ops.run_prop import propagate_min_fused
    return propagate_min_fused


def _iota(t, r, device):
    return torch.arange(r, dtype=_I32, device=device).expand(t, r) \
        .contiguous()


# ---- the three steps around the propagations, each a plain version and a
# wrapper that routes a CUDA tensor to its launch of csrc/run_cc.cu ----

def prepare_runs_plain(px_runs, run_counts, *, w, dilates, weak_init=False,
                       frame_valid=None):
    """Plain version of ``prepare_runs``: the counts of the invalid frames
    set to 0 (``ysmr_tpu``'s ``rc_eff``), ``decode_runs``,
    ``run_windows_multi`` and ``chain_mask``."""
    counts = run_counts.to(_I32)
    if frame_valid is not None:
        counts = torch.where(frame_valid, counts, torch.zeros_like(counts))
    geo = _prepare(px_runs, counts, w=w)
    t, r = geo['rows'].shape
    iota = _iota(t, r, px_runs.device)
    wins = run_windows_multi(geo, dilates=tuple(dilates))
    init = torch.where(geo['rmark'], iota, iota + r) if weak_init else iota
    return {'init': init, 'valid': geo['valid'], 'wins': wins,
            'link': chain_mask(geo, wins[0]), 'counts': counts}


def compact_kept_runs_plain(px_runs, run_counts, lab4, win8o, *, w):
    """Plain version of ``compact_kept_runs``: the stable compaction of the
    runs the 4-connected propagation kept (a stable sort, gathers and a
    cumulative sum), the 8-connected windows remapped onto it and its
    links."""
    geo = _prepare(px_runs, run_counts, w=w)
    t, r = geo['rows'].shape
    iota = _iota(t, r, px_runs.device)
    keep = geo['valid'] & (lab4 < r)

    # stable compaction: surviving runs first, raster order preserved
    ckey = torch.where(keep, iota, iota + r)
    c_orig = torch.sort(ckey, dim=1, stable=True).indices
    c_rows, c_xs, c_xe = (torch.gather(geo[k], 1, c_orig)
                          for k in ('rows', 'xs', 'xe'))
    keep_i = keep.to(_I32)
    n_kept = keep_i.sum(dim=1, dtype=_I32)
    c_valid = iota < n_kept[:, None]

    # window remap: compaction is a stable subset, so kept runs with
    # original index in [lo, hi] occupy the compacted range
    # [#kept strictly before lo, #kept through hi - 1]
    kc = torch.cumsum(keep_i, dim=1, dtype=_I32)
    before = kc - keep_i
    g = {k: torch.gather(win8o[k], 1, c_orig)
         for k in ('lo_up', 'hi_up', 'lo_dn', 'hi_dn', 'ok_up', 'ok_dn')}

    def remap(lo, hi):
        lo2 = torch.gather(before, 1, lo.clamp(0, r - 1).long())
        hi2 = torch.gather(kc, 1, hi.clamp(0, r - 1).long()) - 1
        return lo2, hi2

    lo_up, hi_up = remap(g['lo_up'], g['hi_up'])
    lo_dn, hi_dn = remap(g['lo_dn'], g['hi_dn'])
    win8 = {'lo_up': lo_up, 'hi_up': hi_up,
            'ok_up': c_valid & g['ok_up'] & (lo_up <= hi_up),
            'lo_dn': lo_dn, 'hi_dn': hi_dn,
            'ok_dn': c_valid & g['ok_dn'] & (lo_dn <= hi_dn)}
    geo8 = {'rows': c_rows, 'xs': c_xs, 'xe': c_xe, 'valid': c_valid,
            'key_m': geo['key_m']}
    return {'init': iota, 'win': win8, 'link': chain_mask(geo8, win8),
            'c_orig': c_orig.to(_I32), 'n_kept': n_kept}


def finish_components_plain(px_runs, run_counts, lab8, c_orig, n_kept,
                            steps4, steps8, *, w, sorted_runs=False,
                            row_tables=None, readback=None):
    """Plain version of ``finish_components``: the roots' ascending rank
    (a cumulative sum), the ids gathered and scattered to wire order, the
    kept pixels and, with ``sorted_runs`` or ``row_tables``, one stable
    sort of the combined key (component rank, start < 2^26; the JAX
    version sorts by the two keys); with ``row_tables`` the ids reversed
    to cv2's order and ``labeling.run_row_tables`` of the sorted runs;
    with ``readback`` the host-rect plane (``readback_plane``)."""
    geo = _prepare(px_runs, run_counts, w=w)
    t, r = geo['rows'].shape
    iota = _iota(t, r, px_runs.device)
    if c_orig is None:
        # valid runs are a prefix, so the compaction is the identity
        c_orig = iota.long()
        c_rows, c_xs, c_len = geo['rows'], geo['xs'], geo['lens']
        c_valid = geo['valid']
    else:
        c_orig = c_orig.long()
        c_rows, c_xs, c_len = (torch.gather(geo[k], 1, c_orig)
                               for k in ('rows', 'xs', 'lens'))
        c_valid = iota < n_kept[:, None]

    # component ids: ascending rank of roots in raster order (root = run of
    # minimum index = the component's topmost-leftmost run)
    roots = (c_valid & (lab8 == iota)).to(_I32)
    rank = torch.cumsum(roots, dim=1, dtype=_I32) - 1
    n_components = roots.sum(dim=1, dtype=_I32)
    asc = torch.gather(rank, 1, lab8.clamp(0, r - 1).long())
    comp_c = torch.where(c_valid, asc, torch.full_like(asc, -1))

    # map ids back to original wire-run order (c_orig is a permutation of
    # each row, so the scatter writes every slot exactly once)
    run_comp = torch.empty_like(comp_c).scatter_(1, c_orig, comp_c)
    c_len_v = torch.where(c_valid, c_len, torch.zeros_like(c_len))
    n_px = c_len_v.sum(dim=1, dtype=_I32)
    cc_steps = steps8 if steps4 is None else torch.maximum(steps4, steps8)
    out = {'run_comp': run_comp, 'n_components': n_components,
           'n_px': n_px, 'cc_steps': cc_steps}
    if readback:
        out['readback'] = readback_plane(run_comp, n_components, cc_steps,
                                         **_readback_sizes(readback))
    if not (sorted_runs or row_tables):
        return out
    # components contiguous, linear start ascending within: one stable
    # sort of the combined key (component rank, start < 2^26); the JAX
    # version sorts by the two keys
    c_start = c_xs + c_rows * w
    skey = torch.where(c_valid, asc, torch.full_like(asc, 1 << 30))
    order = torch.sort(skey.long() * (1 << 26) + c_start, dim=1,
                       stable=True).indices
    s_start, s_len, s_comp = (torch.gather(a, 1, order)
                              for a in (c_start, c_len_v, comp_c))
    if sorted_runs:
        out.update(s_start=s_start, s_len=s_len, s_comp=s_comp)
    if row_tables:
        # cv2 enumerates contours in reverse raster order: reverse the ids
        comp_rev = torch.where(s_comp >= 0,
                               n_components[:, None] - 1 - s_comp,
                               torch.full_like(s_comp, -1))
        out.update(zip(TABLE_KEYS, labeling.run_row_tables(
            s_start, s_len, comp_rev, w=w, **_table_sizes(row_tables))))
    return out


#: the row tables' keys in ``finish_components``' output
TABLE_KEYS = ('row_min_x', 'row_max_x', 'row_valid', 'min_y')


def _table_sizes(row_tables):
    """(h, max_det, max_bh) of a ``row_tables`` dict, as ints."""
    return {k: int(row_tables[k]) for k in ('h', 'max_det', 'max_bh')}


def _readback_sizes(readback):
    """(runs, max_det) of a ``readback`` dict, as ints."""
    return {k: int(readback[k]) for k in ('runs', 'max_det')}


def detection_index(run_comp, n_components, max_det):
    """(T, R) int32: each run's detection index in cv2's order,
    ``n_components - 1 - run_comp``, and -1 where the run has no component
    or the index reaches ``max_det`` (``ysmr_tpu``'s ``det_run_idx``
    before its cast)."""
    comp_rev = torch.where(run_comp >= 0, n_components[:, None] - 1 -
                           run_comp, torch.full_like(run_comp, -1))
    return torch.where(comp_rev < max_det, comp_rev,
                       torch.full_like(comp_rev, -1))


def readback_plane(run_comp, n_components, cc_steps, *, runs, max_det):
    """The host-rect batch's readback plane, (T, runs + 2) int16: the
    ``detection_index`` of the wire's first ``runs`` runs, then the
    component count clamped to 32767 and the step count."""
    if not 1 <= runs <= run_comp.shape[1] or max_det < 1:
        raise ValueError('readback_plane: {} of {} runs, {} detections'
                         .format(runs, run_comp.shape[1], max_det))
    det = detection_index(run_comp, n_components, max_det)[:, :runs]
    return torch.cat([det.to(torch.int16),
                      n_components.clamp(max=32767)[:, None].to(torch.int16),
                      cc_steps[:, None].to(torch.int16)], dim=1)


def _wire_args(name, px_runs, run_counts, w, max_runs=None):
    """The wire on the card as the launches take it, or a ValueError."""
    if px_runs.device.type != 'cuda':
        raise ValueError('{}: unsupported device {}'.format(
            name, px_runs.device))
    if px_runs.dim() != 2 or run_counts.shape != px_runs.shape[:1] or \
            run_counts.device != px_runs.device:
        raise ValueError('{}: expects (T, R) runs and (T,) counts on one '
                         'device'.format(name))
    t, r = px_runs.shape
    if not 1 <= w <= 1 << 26 or t > 65535 or \
            (max_runs is not None and r > max_runs):
        raise ValueError('{}: needs 1 <= w <= 2^26, T <= 65535 and R <= {} '
                         '(got w {}, T {}, R {})'.format(
                             name, max_runs, w, t, r))
    return (px_runs.to(_I32).contiguous(), run_counts.to(_I32).contiguous(),
            _build.load_kernels(),
            torch.cuda.current_stream(px_runs.device).cuda_stream)


def _plane(name, a, shape, dtype, device):
    if a.shape != shape or a.dtype != dtype or a.device != device:
        raise ValueError('{}: a {} plane of shape {} on {} expected'.format(
            name, dtype, tuple(shape), device))
    return a.contiguous()


def prepare_runs(px_runs, run_counts, *, w, dilates, weak_init=False,
                 frame_valid=None):
    """The run graph of a batch's wire: each run's initial label, validity,
    windows into the rows above and below for each dilation, and the
    same-row links of the first dilation's windows (``decode_runs``,
    ``run_windows_multi``, ``chain_mask``).

    On a CPU tensor ``prepare_runs_plain``; on a CUDA tensor two launches
    of ``csrc/run_cc.cu`` (the keys, then the prepare kernel; bit-equal),
    or the call raises.

    :param px_runs: (T, R) int32 view of the run wire
    :param run_counts: (T,) valid runs a frame
    :param dilates: one or two dilations (1 for 8-connectivity, 0 for 4)
    :param weak_init: the marker reconstruction's init (marked runs at
        their own index, the others at index + R) instead of the index
    :param frame_valid: None, or (T,) bool: the frames whose runs count
        (the others' counts are taken as 0; the keys launch writes them)
    :return: dict of (T, R) ``init`` int32, ``valid`` bool, ``link`` bool,
        ``wins``, one ``run_windows`` dict a dilation, and ``counts`` (T,)
        int32, the counts the graph was made from (the later steps' input)
    """
    if px_runs.device.type == 'cpu':
        return prepare_runs_plain(px_runs, run_counts, w=w, dilates=dilates,
                                  weak_init=weak_init,
                                  frame_valid=frame_valid)
    name = 'prepare_runs'
    runs, counts, lib, stream = _wire_args(name, px_runs, run_counts, w)
    dilates = tuple(int(d) for d in dilates)
    if len(dilates) not in (1, 2):
        raise ValueError('{}: one or two dilations'.format(name))
    t, r = runs.shape
    dev = runs.device
    nd = len(dilates)
    fv = counts_out = None
    if frame_valid is not None:
        fv = _plane(name, frame_valid, runs.shape[:1], torch.bool, dev)
        counts_out = torch.empty((t,), dtype=_I32, device=dev)
        if not r:   # no launch: nothing else reads the counts
            counts_out = torch.where(fv, counts, torch.zeros_like(counts))
    ends = torch.empty((nd, 4, t, r), dtype=_I32, device=dev)
    oks = torch.empty((nd, 2, t, r), dtype=torch.bool, device=dev)
    link = torch.empty((t, r), dtype=torch.bool, device=dev)
    init = torch.empty((t, r), dtype=_I32, device=dev)
    valid = torch.empty((t, r), dtype=torch.bool, device=dev)
    if t and r:
        # the keys of every slot, and a flag a block of slots
        scratch = torch.empty(lib.ysmr_run_scratch_words(t, r, 0),
                              dtype=_I32, device=dev)
        rc = lib.ysmr_run_prepare(
            runs.data_ptr(), counts.data_ptr(),
            None if fv is None else fv.data_ptr(),
            None if fv is None else counts_out.data_ptr(), ends.data_ptr(),
            oks.data_ptr(), link.data_ptr(), init.data_ptr(),
            valid.data_ptr(), scratch.data_ptr(), t, r, w, nd, dilates[0],
            dilates[-1], int(bool(weak_init)), dev.index, stream)
        _build.check(lib, rc, 'run prepare kernel launch')
        prepare_runs.launches += 1
    wins = [{'lo_up': ends[k, 0], 'hi_up': ends[k, 1], 'lo_dn': ends[k, 2],
             'hi_dn': ends[k, 3], 'ok_up': oks[k, 0], 'ok_dn': oks[k, 1]}
            for k in range(nd)]
    return {'init': init, 'valid': valid, 'wins': wins, 'link': link,
            'counts': counts if fv is None else counts_out}


#: runs a frame that the compact and finish launches of csrc/run_cc.cu take
#: (a frame's tile counts in a block's shared memory)
RUN_CC_MAX_RUNS = 1 << 19

_WIN_KEYS = ('lo_up', 'hi_up', 'lo_dn', 'hi_dn', 'ok_up', 'ok_dn')


def compact_kept_runs(px_runs, run_counts, lab4, win8o, *, w):
    """The double threshold's step between the propagations: the runs the
    4-connected propagation kept (valid, label below R) compacted in
    raster order, and the 8-connected run graph on the compacted table.

    On a CPU tensor ``compact_kept_runs_plain``; on a CUDA tensor two
    launches of ``csrc/run_cc.cu`` (the keep bits, then the compaction;
    bit-equal; R at most ``RUN_CC_MAX_RUNS``), or the call raises.

    :param lab4: (T, R) int32 labels of the 4-connected propagation
    :param win8o: the 8-connected ``run_windows`` dict of the wire's runs
    :return: dict of ``init`` (the index), ``win`` and ``link`` of the
        compacted table, ``c_orig`` (T, R) int32 (the wire index of each
        compacted slot: kept runs first, then the others, each in order)
        and ``n_kept`` (T,) int32
    """
    if px_runs.device.type == 'cpu':
        return compact_kept_runs_plain(px_runs, run_counts, lab4, win8o,
                                       w=w)
    name = 'compact_kept_runs'
    runs, counts, lib, stream = _wire_args(name, px_runs, run_counts, w,
                                           RUN_CC_MAX_RUNS)
    t, r = runs.shape
    dev = runs.device
    lab4 = _plane(name, lab4, runs.shape, _I32, dev)
    planes = [_plane(name, win8o[k], runs.shape,
                     _I32 if k.startswith(('lo', 'hi')) else torch.bool, dev)
              for k in _WIN_KEYS]
    init = torch.empty((t, r), dtype=_I32, device=dev)
    ends = torch.empty((4, t, r), dtype=_I32, device=dev)
    oks = torch.empty((2, t, r), dtype=torch.bool, device=dev)
    link = torch.empty((t, r), dtype=torch.bool, device=dev)
    c_orig = torch.empty((t, r), dtype=_I32, device=dev)
    n_kept = torch.empty((t,), dtype=_I32, device=dev)
    if t and r:
        # each tile's words of keep bits and its count
        scratch = torch.empty(lib.ysmr_run_scratch_words(t, r, 1),
                              dtype=_I32, device=dev)
        vp = ctypes.c_void_p
        rc = lib.ysmr_run_compact(
            runs.data_ptr(), counts.data_ptr(), lab4.data_ptr(),
            (vp * 4)(*(p.data_ptr() for p in planes[:4])),
            (vp * 2)(*(p.data_ptr() for p in planes[4:])),
            init.data_ptr(), ends.data_ptr(), oks.data_ptr(),
            link.data_ptr(), c_orig.data_ptr(), n_kept.data_ptr(),
            scratch.data_ptr(), t, r, w, dev.index, stream)
        _build.check(lib, rc, 'run compact kernel launch')
        compact_kept_runs.launches += 1
    win = {'lo_up': ends[0], 'hi_up': ends[1], 'lo_dn': ends[2],
           'hi_dn': ends[3], 'ok_up': oks[0], 'ok_dn': oks[1]}
    return {'init': init, 'win': win, 'link': link, 'c_orig': c_orig,
            'n_kept': n_kept}


def finish_components(px_runs, run_counts, lab8, c_orig, n_kept, steps4,
                      steps8, *, w, sorted_runs=False, row_tables=None,
                      readback=None):
    """The step after the 8-connected propagation: component ids (the
    ascending raster rank of each component's root run), scattered back to
    wire order, the component and kept-pixel counts, the larger step count
    and, with ``row_tables``, the row tables of the device rects; with
    ``readback``, the host-rect batch's readback plane.

    On a CPU tensor ``finish_components_plain``; on a CUDA tensor two
    launches of ``csrc/run_cc.cu`` (the roots, then the ids with the
    tables' fill and atomics; bit-equal; R at most ``RUN_CC_MAX_RUNS``),
    or the call raises. ``sorted_runs`` has no kernel: on a CUDA tensor it
    raises.

    :param lab8: (T, R) int32 labels of the 8-connected propagation over
        the compacted table
    :param c_orig, n_kept: ``compact_kept_runs``' outputs, or both None
        when the table is the wire's (a single threshold)
    :param steps4: (T,) int32 steps of the 4-connected propagation, or
        None; ``steps8``: those of the 8-connected one
    :param row_tables: None, or a dict of the frame height ``h`` and the
        capacities ``max_det`` and ``max_bh``
    :param readback: None, or a dict of ``runs`` (1 to R: the wire's runs
        the plane holds) and ``max_det`` (as ``row_tables``' where both
        are asked for)
    :return: the ``run_cc_components`` dict
    """
    if px_runs.device.type == 'cpu':
        return finish_components_plain(px_runs, run_counts, lab8, c_orig,
                                       n_kept, steps4, steps8, w=w,
                                       sorted_runs=sorted_runs,
                                       row_tables=row_tables,
                                       readback=readback)
    name = 'finish_components'
    if sorted_runs:
        raise ValueError('{}: the component-sorted runs have no kernel (the '
                         'row tables take their place); they are '
                         'finish_components_plain\'s'.format(name))
    runs, counts, lib, stream = _wire_args(name, px_runs, run_counts, w,
                                           RUN_CC_MAX_RUNS)
    t, r = runs.shape
    dev = runs.device
    lab8 = _plane(name, lab8, runs.shape, _I32, dev)
    if (c_orig is None) != (n_kept is None):
        raise ValueError('{}: c_orig and n_kept go together'.format(name))
    if c_orig is not None:
        c_orig = _plane(name, c_orig, runs.shape, _I32, dev)
        n_kept = _plane(name, n_kept, runs.shape[:1], _I32, dev)
    steps8 = _plane(name, steps8, runs.shape[:1], _I32, dev)
    if steps4 is not None:
        steps4 = _plane(name, steps4, runs.shape[:1], _I32, dev)
    run_comp = torch.empty((t, r), dtype=_I32, device=dev)
    counts_out = torch.empty((3, t), dtype=_I32, device=dev)
    out = {'run_comp': run_comp, 'n_components': counts_out[0],
           'n_px': counts_out[1], 'cc_steps': counts_out[2]}
    tables = [None] * 4
    max_det = max_bh = 0
    if row_tables:
        sizes = _table_sizes(row_tables)
        max_det, max_bh = sizes['max_det'], sizes['max_bh']
        if max_det < 1 or max_bh < 1:
            raise ValueError('{}: row tables of {} detections and {} rows'
                             .format(name, max_det, max_bh))
        shape = (t * max_det, max_bh)
        tables = [torch.empty(shape, dtype=_I32, device=dev),
                  torch.empty(shape, dtype=_I32, device=dev),
                  torch.empty(shape, dtype=torch.bool, device=dev),
                  torch.empty((t * max_det,), dtype=_I32, device=dev)]
        out.update(zip(TABLE_KEYS, tables))
    plane = None
    rb = 0
    if readback:
        sizes = _readback_sizes(readback)
        rb = sizes['runs']
        if not 1 <= rb <= r or sizes['max_det'] < 1 or \
                (row_tables and sizes['max_det'] != max_det):
            raise ValueError('{}: a readback plane of {} of {} runs and {} '
                             'detections (the row tables\' {})'.format(
                                 name, rb, r, sizes['max_det'], max_det))
        max_det = sizes['max_det']
        plane = torch.empty((t, rb + 2), dtype=torch.int16, device=dev)
        out['readback'] = plane
    if t and r:
        # each tile's words of root bits and its count; with the tables
        # each root's row
        scratch = torch.empty(
            lib.ysmr_run_scratch_words(t, r, 2 if row_tables else 1),
            dtype=_I32, device=dev)

        def ptr(a, k=None):
            return None if a is None else (a if k is None else a[k]) \
                .data_ptr()
        rc = lib.ysmr_run_finish(
            runs.data_ptr(), counts.data_ptr(), lab8.data_ptr(),
            ptr(c_orig), ptr(n_kept), ptr(steps4), steps8.data_ptr(),
            run_comp.data_ptr(), ptr(counts_out, 0), ptr(counts_out, 1),
            ptr(counts_out, 2), *(ptr(a) for a in tables), ptr(plane),
            scratch.data_ptr(), t, r, w, max_det, max_bh, rb, dev.index,
            stream)
        _build.check(lib, rc, 'run finish kernel launch')
        finish_components.launches += 1
        if row_tables:
            finish_components.row_table_launches += 1
        if readback:
            finish_components.readback_launches += 1
    return out


#: kernel launches since the counts were last set to 0
prepare_runs.launches = 0
compact_kept_runs.launches = 0
finish_components.launches = 0
#: ... of them with the row tables, and with the readback plane
finish_components.row_table_launches = 0
finish_components.readback_launches = 0


def label_runs(px_runs, run_counts, *, w, connectivity=8, max_iters=64):
    """Connected-component root (min run index) per run; invalid = self.

    :return: ((T, R) int32 roots, (T,) int32 propagation steps)
    """
    g = prepare_runs(px_runs, run_counts, w=w,
                     dilates=(1 if connectivity == 8 else 0,))
    return _make_prop()(g['init'], g['wins'][0], g['link'],
                        max_iters=max_iters)


def keep_marked_runs(px_runs, run_counts, *, w, max_iters=64):
    """Marker reconstruction on runs (binary_propagation semantics).

    A run survives iff its 4-connected mask component contains at least
    one marker pixel (reference track_eval.py:211-214; the encoder splits
    runs at marker transitions, so marker membership is per-run). The
    run graph is ``prepare_runs`` and the propagation
    ``propagate_min_fused``: the CUDA kernels on a CUDA tensor, the plain
    versions on a CPU one.

    :return: (T, R) bool keep flags
    """
    g = prepare_runs(px_runs, run_counts, w=w, dilates=(0,), weak_init=True)
    lab, _ = _make_prop()(g['init'], g['wins'][0], g['link'],
                          max_iters=max_iters)
    return g['valid'] & (lab < px_runs.shape[1])


def _components(px_runs, run_counts, w, double_threshold, max_iters,
                sorted_runs, row_tables, readback, frame_valid, prepare,
                compact, finish):
    prop = _make_prop()
    steps4 = c_orig = n_kept = None
    if double_threshold:
        # both connectivities' windows in one pass; the 8-conn windows are
        # remapped onto the compacted table
        g = prepare(px_runs, run_counts, w=w, dilates=(0, 1),
                    weak_init=True, frame_valid=frame_valid)
        lab4, steps4 = prop(g['init'], g['wins'][0], g['link'],
                            max_iters=max_iters)
        c = compact(px_runs, g['counts'], lab4, g['wins'][1], w=w)
        init8, win8, link8 = c['init'], c['win'], c['link']
        c_orig, n_kept = c['c_orig'], c['n_kept']
    else:
        g = prepare(px_runs, run_counts, w=w, dilates=(1,),
                    frame_valid=frame_valid)
        init8, win8, link8 = g['init'], g['wins'][0], g['link']
    lab8, steps8 = prop(init8, win8, link8, max_iters=max_iters)
    return finish(px_runs, g['counts'], lab8, c_orig, n_kept, steps4, steps8,
                  w=w, sorted_runs=sorted_runs, row_tables=row_tables,
                  readback=readback)


def run_cc_components(px_runs, run_counts, *, w, double_threshold,
                      max_iters=64, sorted_runs=False, row_tables=None,
                      readback=None, frame_valid=None):
    """Full detect labeling on run tables: reconstruction + 8-conn CC.

    Optional marker reconstruction (4-connected, keep mask components that
    contain a marker) -> stable compaction of surviving runs -> 8-connected
    components -> ascending raster-rank component ids. Each step is a
    wrapper that routes a CUDA tensor to its kernel (``prepare_runs``,
    ``propagate_min_fused``, ``compact_kept_runs``, ``finish_components``:
    on the card six launches of ``csrc/run_cc.cu`` around ``csrc/
    run_prop.cu``'s, four with a single threshold); on a CPU tensor it is
    ``run_cc_components_plain``.

    :param sorted_runs: also return the component-sorted run tables (the
        plain route only: on a CUDA tensor the call raises)
    :param row_tables: None, or a dict of the frame height ``h`` and the
        capacities ``max_det`` and ``max_bh``: also return the row tables
        of the device rects, ``labeling.run_row_tables`` of the sorted
        runs with ids reversed to cv2's order (``TABLE_KEYS``)
    :param readback: None, or a dict of ``runs`` and ``max_det``: also
        return ``readback``, the host-rect batch's plane
        (``readback_plane``), which the finish writes
    :param frame_valid: None, or (T,) bool: the runs of the other frames
        do not count (``ysmr_tpu``'s ``rc_eff``; the prepare takes it)
    :return: dict with
        ``run_comp`` (T, R) int32 — ascending component id per ORIGINAL
        wire run (-1 = dropped by reconstruction / invalid),
        ``n_components`` (T,) int32, ``n_px`` (T,) int32 kept pixels per
        frame, and ``cc_steps`` (T,) int32 — the larger step count of the
        two propagations (converged <=> cc_steps < max_iters); with
        ``sorted_runs`` also ``s_start, s_len, s_comp`` (T, R) int32, the
        kept runs ordered by (component id, linear start), padding slots
        with len 0 and component -1 at the end; with ``row_tables`` also
        ``row_min_x, row_max_x`` (T*max_det, max_bh) int32, ``row_valid``
        (T*max_det, max_bh) bool and ``min_y`` (T*max_det,) int32; with
        ``readback`` also ``readback`` (T, runs + 2) int16.
    """
    return _components(px_runs, run_counts, w, double_threshold, max_iters,
                       sorted_runs, row_tables, readback, frame_valid,
                       prepare_runs, compact_kept_runs, finish_components)


def run_cc_components_plain(px_runs, run_counts, *, w, double_threshold,
                            max_iters=64, sorted_runs=False,
                            row_tables=None, readback=None,
                            frame_valid=None):
    """Plain version of ``run_cc_components``: the plain steps around the
    propagation wrapper (the kernel on a CUDA tensor, whose labels the
    plain propagation gives at its fixpoint)."""
    return _components(px_runs, run_counts, w, double_threshold, max_iters,
                       sorted_runs, row_tables, readback, frame_valid,
                       prepare_runs_plain, compact_kept_runs_plain,
                       finish_components_plain)


#: ``csrc/expand_runs.cu``'s runs a chunk and output slots a tile
EXPAND_CHUNK = 2048
EXPAND_TILE = 2048


def expand_runs_plain(px_runs, run_counts, f, double_threshold):
    """Plain version of ``expand_runs``: ``ysmr_tpu``'s expansion, ``lin``
    with no per-pixel gather (one scatter of each run's jump delta, then a
    cumsum over the slots) and, with the double threshold, each pixel's
    marker (run id by a start-offset scatter and cummax, then one
    gather)."""
    t, r = px_runs.shape
    dev = px_runs.device
    runs = px_runs.to(_I32)
    starts = runs & 0x03FFFFFF
    rmark = ((runs >> 26) & 1) > 0
    lens = (runs >> 27) & 0x1F
    iota_r = torch.arange(r, dtype=_I32, device=dev)[None, :]
    lens = torch.where(iota_r < run_counts.to(_I32)[:, None], lens,
                       torch.zeros_like(lens))
    offs = torch.cumsum(lens, dim=1, dtype=_I32) - lens
    t_off = torch.arange(t, dtype=torch.int64, device=dev)[:, None] * f
    # runs that start past the table go to the dump slot t * f
    flat_idx = torch.where((lens > 0) & (offs < f), offs + t_off,
                           torch.full_like(t_off, t * f)).reshape(-1)
    prev_end = torch.cat([torch.ones((t, 1), dtype=_I32, device=dev),
                          (starts + lens)[:, :-1]], dim=1)
    d = torch.ones(t * f + 1, dtype=_I32, device=dev)
    d.index_add_(0, flat_idx, (starts - prev_end).reshape(-1))
    lin_raw = torch.cumsum(d[:t * f].view(t, f), dim=1, dtype=_I32)
    if not double_threshold:
        return lin_raw, torch.zeros((t, f), dtype=torch.bool, device=dev)
    rid = torch.zeros(t * f + 1, dtype=torch.int64, device=dev)
    rid[flat_idx] = iota_r.expand(t, r).reshape(-1).to(torch.int64)
    rid = torch.cummax(rid[:t * f].view(t, f), dim=1).values
    return lin_raw, torch.gather(rmark, 1, rid)


def expand_runs(px_runs, run_counts, f, double_threshold):
    """The run wire expanded to the (T, F) pixel table in raster order, for
    the pixel-table branch (``run cc = off``): each slot's ``lin`` (y*w +
    x) and, with the double threshold, its run's marker bit
    (``ysmr_tpu/pipeline/detect_pixels.py:149-198``). Slots past a frame's
    pixels hold what the plain version's scans leave there (the last run's
    lin continued, its marker); the pixel count masks them.

    On a CUDA tensor ``csrc/expand_runs.cu`` (one call: each chunk of
    EXPAND_CHUNK runs' length sum, a launch skipped where the wire is one
    chunk, then a block a tile of EXPAND_TILE slots; no host sync), for
    the encoder's wires: runs below the count of lengths 1-31. On a CPU
    tensor ``expand_runs_plain``.

    :param px_runs: (T, R) int32 view of the uint32 run wire
    :param run_counts: (T,) int32 runs per frame
    :param f: the pixel-table width
    :return: (lin (T, f) int32, marker (T, f) bool, all False without the
        double threshold)
    """
    if px_runs.device.type == 'cpu':
        return expand_runs_plain(px_runs, run_counts, f, double_threshold)
    name = 'expand_runs'
    if px_runs.device.type != 'cuda':
        raise ValueError('{}: unsupported device {}'.format(
            name, px_runs.device))
    if px_runs.dim() != 2 or px_runs.dtype != _I32 or \
            not px_runs.is_contiguous() or run_counts.dtype != _I32 or \
            run_counts.shape != px_runs.shape[:1] or \
            run_counts.device != px_runs.device or \
            not run_counts.is_contiguous():
        raise ValueError('{}: expects contiguous (T, R) int32 runs and (T,) '
                         'int32 counts on one device'.format(name))
    t, r = px_runs.shape
    dev = px_runs.device
    lin = torch.empty((t, f), dtype=_I32, device=dev)
    marker = torch.empty((t, f), dtype=torch.bool, device=dev)
    # each chunk's length sum (4 bytes a chunk of EXPAND_CHUNK runs)
    sums = torch.empty((t, max(-(-r // EXPAND_CHUNK), 1)), dtype=_I32,
                       device=dev)
    lib = _build.load_kernels()
    rc = lib.ysmr_expand_runs(px_runs.data_ptr(), run_counts.data_ptr(),
                              sums.data_ptr(), lin.data_ptr(),
                              marker.data_ptr(), t, r, f,
                              int(bool(double_threshold)), dev.index,
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, 'expand runs kernel launch')
    expand_runs.launches += 1
    return lin, marker


#: kernel launches since the count was last set to 0
expand_runs.launches = 0


def det_px_from_runs(px_runs, run_counts, comp_rev_run, *, f, max_det):
    """Wire-order per-pixel detection index from per-run component ids.

    Feeds the host-side cv2-exact rect measurement with the pixel-table
    path's ``det_px_idx`` contract: -1 = background, dropped or
    ``>= max_det``. Each run's index is scattered at its first pixel's
    slot and carried over the run by a cumulative max.

    :param px_runs: (T, R) int32 view of the run wire
    :param run_counts: (T,) valid runs per frame
    :param comp_rev_run: (T, R) int32 detection index per run (-1 none)
    :param f: pixel-table width
    :return: (T, f) int32
    """
    t, r = px_runs.shape
    dev = px_runs.device
    lens = (px_runs.to(_I32) >> 27) & 0x1F
    iota_r = torch.arange(r, dtype=_I32, device=dev)[None, :]
    lens = torch.where(iota_r < run_counts.to(_I32)[:, None], lens,
                       torch.zeros_like(lens))
    ends = torch.cumsum(lens, dim=1, dtype=_I32)
    offs = ends - lens
    t_off = torch.arange(t, dtype=torch.int64, device=dev)[:, None] * f
    # empty runs and runs past the table go to the dump slot t * f
    flat_idx = torch.where((lens > 0) & (offs < f), offs + t_off,
                           torch.full_like(t_off, t * f)).reshape(-1)
    rid = torch.zeros(t * f + 1, dtype=torch.int64, device=dev)
    rid[flat_idx] = iota_r.expand(t, r).reshape(-1).to(torch.int64)
    rid = torch.cummax(rid[:t * f].view(t, f), dim=1).values
    g = torch.gather(comp_rev_run.to(_I32), 1, rid)
    active = torch.arange(f, dtype=_I32, device=dev)[None, :] < \
        ends[:, -1:]
    return torch.where(active & (g >= 0) & (g < max_det), g,
                       torch.full_like(g, -1))
