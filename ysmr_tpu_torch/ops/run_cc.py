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
"""

import torch

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


def label_runs(px_runs, run_counts, *, w, connectivity=8, max_iters=64):
    """Connected-component root (min run index) per run; invalid = self.

    :return: ((T, R) int32 roots, (T,) int32 propagation steps)
    """
    geo = _prepare(px_runs, run_counts, w=w)
    win = run_windows(geo, dilate=1 if connectivity == 8 else 0)
    link = chain_mask(geo, win)
    t, r = geo['rows'].shape
    iota = torch.arange(r, dtype=_I32, device=px_runs.device).expand(t, r)
    return _make_prop()(iota.contiguous(), win, link, max_iters=max_iters)


def keep_marked_runs(px_runs, run_counts, *, w, max_iters=64):
    """Marker reconstruction on runs (binary_propagation semantics).

    A run survives iff its 4-connected mask component contains at least
    one marker pixel (reference track_eval.py:211-214; the encoder splits
    runs at marker transitions, so marker membership is per-run). The
    propagation is ``propagate_min_fused``: the CUDA kernel on a CUDA
    tensor, the plain ``propagate_min`` on a CPU one.

    :return: (T, R) bool keep flags
    """
    geo = _prepare(px_runs, run_counts, w=w)
    win = run_windows(geo, dilate=0)
    link = chain_mask(geo, win)
    t, r = geo['rows'].shape
    iota = torch.arange(r, dtype=_I32, device=px_runs.device).expand(t, r)
    init = torch.where(geo['rmark'], iota, iota + r)
    lab, _ = _make_prop()(init, win, link, max_iters=max_iters)
    return geo['valid'] & (lab < r)


def run_cc_components(px_runs, run_counts, *, w, double_threshold,
                      max_iters=64, sorted_runs=False):
    """Full detect labeling on run tables: reconstruction + 8-conn CC.

    Optional marker reconstruction (4-connected, keep mask components that
    contain a marker) -> stable compaction of surviving runs -> 8-connected
    components -> ascending raster-rank component ids.

    :param sorted_runs: also build the component-sorted run tables that
        only the device rect path reads (the host-rect path skips their
        sort)
    :return: dict with
        ``run_comp`` (T, R) int32 — ascending component id per ORIGINAL
        wire run (-1 = dropped by reconstruction / invalid),
        ``n_components`` (T,) int32, ``n_px`` (T,) int32 kept pixels per
        frame, and ``cc_steps`` (T,) int32 — the larger step count of the
        two propagations (converged <=> cc_steps < max_iters); with
        ``sorted_runs`` also ``s_start, s_len, s_comp`` (T, R) int32, the
        kept runs ordered by (component id, linear start), padding slots
        with len 0 and component -1 at the end.
    """
    geo = _prepare(px_runs, run_counts, w=w)
    t, r = geo['rows'].shape
    dev = px_runs.device
    iota = torch.arange(r, dtype=_I32, device=dev).expand(t, r).contiguous()
    prop = _make_prop()
    if double_threshold:
        # both connectivities' windows in one searchsorted pair; the 8-conn
        # windows are remapped onto the compacted table below
        win4, win8o = run_windows_multi(geo, dilates=(0, 1))
        link4 = chain_mask(geo, win4)
        init = torch.where(geo['rmark'], iota, iota + r)
        lab4, steps4 = prop(init, win4, link4, max_iters=max_iters)
        keep = geo['valid'] & (lab4 < r)

        # stable compaction: surviving runs first, raster order preserved
        ckey = torch.where(keep, iota, iota + r)
        c_orig = torch.sort(ckey, dim=1, stable=True).indices
        c_rows, c_xs, c_xe, c_len = (torch.gather(geo[k], 1, c_orig)
                                     for k in ('rows', 'xs', 'xe', 'lens'))
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
    else:
        # valid runs are a prefix, so the compaction is the identity
        c_rows, c_xs = geo['rows'], geo['xs']
        c_len, c_orig = geo['lens'], iota.long()
        c_valid = geo['valid']
        geo8 = geo
        win8 = run_windows(geo8, dilate=1)
        steps4 = None
    link8 = chain_mask(geo8, win8)
    lab8, steps8 = prop(iota, win8, link8, max_iters=max_iters)

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
    n_px = torch.where(c_valid, c_len, torch.zeros_like(c_len)).sum(
        dim=1, dtype=_I32)
    cc_steps = steps8 if steps4 is None else torch.maximum(steps4, steps8)
    out = {'run_comp': run_comp, 'n_components': n_components,
           'n_px': n_px, 'cc_steps': cc_steps}
    if sorted_runs:
        # components contiguous, linear start ascending within: one stable
        # sort of the combined key (component rank, start < 2^26); the JAX
        # version sorts by the two keys
        c_start = c_xs + c_rows * w
        skey = torch.where(c_valid, asc, torch.full_like(asc, 1 << 30))
        order = torch.sort(skey.long() * (1 << 26) + c_start, dim=1,
                           stable=True).indices
        c_len_v = torch.where(c_valid, c_len, torch.zeros_like(c_len))
        out.update(s_start=torch.gather(c_start, 1, order),
                   s_len=torch.gather(c_len_v, 1, order),
                   s_comp=torch.gather(comp_c, 1, order))
    return out


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
