"""Run-graph CC of the PyTorch port (ysmr_tpu_torch/ops/run_cc.py and the
kernel wrapper ops/run_prop.py) against the JAX reference module and scipy.

The same numpy inputs (made from a seed) go through both packages: the
JAX side runs with ``use_pallas=False`` and, for the kernel's contract,
``propagate_min_fused(..., interpret=True)``. Integers must match exactly,
and every propagation must report convergence (before the fixpoint the
labels depend on the schedule).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from test_run_cc import _encode, _partitions_equal
from test_runs_wire import _random_wire
from ysmr_tpu import native as jnative
from ysmr_tpu.ops import labeling as jlb
from ysmr_tpu.ops import run_cc as jrcc
from ysmr_tpu.ops.pallas_run_prop import propagate_min_fused as jfused
from ysmr_tpu_torch.ops import labeling as lb
from ysmr_tpu_torch.ops import run_cc as trcc
from ysmr_tpu_torch.ops.run_prop import propagate_min_fused

torch.set_num_threads(1)

MAX_ITERS = 64


def _t(a):
    """numpy -> torch; the uint32 wire travels as its int32 view."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _wire(seed, t=5, f=2048, h=96, w=128, r=512):
    rng = np.random.default_rng(seed)
    packed, counts = _random_wire(rng, t, f, h, w)
    runs = np.zeros((t, f), np.uint32)
    rcnt = np.zeros(t, np.int32)
    assert jnative.encode_runs_numpy(packed, counts, runs, rcnt, w=w) > 0
    rcnt[-1] = 0  # an empty frame
    return runs[:, :r], rcnt, w


def _random_image_wire(rng, h, w, density, marker_p=0.3, r=1024):
    img = rng.random((h, w)) < density
    marker = (img & (rng.random((h, w)) < marker_p)).astype(np.uint8) * 255
    runs, rcnt = _encode(img, marker=marker, w=w, r=r)
    return img, marker, runs, rcnt


def test_decode_runs_matches_jax():
    runs, rcnt, w = _wire(1)
    ref = jrcc.decode_runs(runs, rcnt, w)
    got = trcc.decode_runs(_t(runs), _t(rcnt), w)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]),
                                      err_msg=k)


def test_decode_runs_bit31_marker_length():
    """A 31-pixel run with the marker set uses bit 31: the int32 view is
    negative, and the masked shift still decodes length 31."""
    word = np.array([[5 | (1 << 26) | (31 << 27), 40 | (3 << 27)]],
                    np.uint32)
    geo = trcc.decode_runs(_t(word), torch.tensor([2], dtype=torch.int32),
                           64)
    assert _np(geo['lens']).tolist() == [[31, 3]]
    assert _np(geo['rmark']).tolist() == [[True, False]]
    assert _np(geo['xs']).tolist() == [[5, 40]]


@pytest.mark.parametrize('seed', [2, 3])
def test_windows_and_chain_match_jax(seed):
    runs, rcnt, w = _wire(seed)
    jgeo = jrcc._prepare(runs, rcnt, w=w)
    tgeo = trcc._prepare(_t(runs), _t(rcnt), w=w)
    jwins = jrcc.run_windows_multi(jgeo, dilates=(0, 1))
    twins = trcc.run_windows_multi(tgeo, dilates=(0, 1))
    for jw, tw in zip(jwins, twins):
        for k in jw:
            np.testing.assert_array_equal(_np(tw[k]), np.asarray(jw[k]),
                                          err_msg=k)
        np.testing.assert_array_equal(
            _np(trcc.chain_mask(tgeo, tw)),
            np.asarray(jrcc.chain_mask(jgeo, jw)))


def _graphs(seed, n, connectivity=8):
    """(init, win, link) as numpy/JAX and torch, for iota and weak inits."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        h = int(rng.integers(3, 30))
        w = int(rng.integers(3, 48))
        img, marker, runs, rcnt = _random_image_wire(
            rng, h, w, rng.uniform(0.2, 0.85))
        if not img.any():
            continue
        dil = 1 if connectivity == 8 else 0
        jgeo = jrcc._prepare(runs, rcnt, w=w)
        jwin = jrcc.run_windows(jgeo, dilate=dil)
        jlink = jrcc.chain_mask(jgeo, jwin)
        tgeo = trcc._prepare(_t(runs), _t(rcnt), w=w)
        twin = trcc.run_windows(tgeo, dilate=dil)
        tlink = trcc.chain_mask(tgeo, twin)
        r = runs.shape[1]
        iota = np.arange(r, dtype=np.int32)[None, :]
        weak = np.where(np.asarray(jgeo['rmark']), iota, iota + r)
        for init in (iota, weak.astype(np.int32)):
            out.append((init, jwin, jlink, _t(init), twin, tlink))
    return out


@pytest.mark.parametrize('connectivity', [4, 8])
def test_propagate_min_matches_jax_and_fused_interpret(connectivity):
    for init, jwin, jlink, tinit, twin, tlink in _graphs(
            5 + connectivity, 8, connectivity):
        ref = np.asarray(jrcc.propagate_min(init, jwin, jlink))
        fused = np.asarray(jfused(init, jwin, jlink, interpret=True))
        lab, steps = trcc.propagate_min(tinit, twin, tlink,
                                        max_iters=MAX_ITERS)
        assert (_np(steps) < MAX_ITERS).all()
        np.testing.assert_array_equal(_np(lab), ref)
        np.testing.assert_array_equal(_np(lab), fused)


def test_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor the kernel wrapper runs the plain version and does
    not count a kernel launch."""
    before = propagate_min_fused.launches
    for init, jwin, jlink, tinit, twin, tlink in _graphs(17, 4):
        lab, steps = propagate_min_fused(tinit, twin, tlink,
                                         max_iters=MAX_ITERS)
        plain, psteps = trcc.propagate_min(tinit, twin, tlink,
                                           max_iters=MAX_ITERS)
        np.testing.assert_array_equal(_np(lab), _np(plain))
        np.testing.assert_array_equal(_np(steps), _np(psteps))
        np.testing.assert_array_equal(
            _np(lab), np.asarray(jrcc.propagate_min(init, jwin, jlink)))
    assert propagate_min_fused.launches == before


def test_wrapper_raises_on_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device is refused."""
    init = torch.zeros((1, 4), dtype=torch.int32, device='meta')
    win = {k: torch.zeros((1, 4), dtype=torch.int32, device='meta')
           for k in ('lo_up', 'hi_up', 'lo_dn', 'hi_dn')}
    win.update({k: torch.zeros((1, 4), dtype=torch.bool, device='meta')
                for k in ('ok_up', 'ok_dn')})
    link = torch.zeros((1, 4), dtype=torch.bool, device='meta')
    with pytest.raises(ValueError):
        propagate_min_fused(init, win, link)


def test_unconverged_steps_report_the_cap():
    """A long chain with a tiny cap stops unconverged and says so."""
    w = 200
    img = np.zeros((1, w), bool)
    img[0, :] = True  # one row: 7 wire runs joined by chain links
    runs, rcnt = _encode(img, w=w, r=16)
    geo = trcc._prepare(_t(runs), _t(rcnt), w=w)
    win = trcc.run_windows(geo, dilate=1)
    link = trcc.chain_mask(geo, win)
    iota = torch.arange(16, dtype=torch.int32)[None, :]
    _, steps = trcc.propagate_min(iota, win, link, max_iters=1)
    assert int(steps[0]) == 1
    lab, steps = trcc.propagate_min(iota, win, link, max_iters=MAX_ITERS)
    assert int(steps[0]) < MAX_ITERS
    assert (_np(lab)[0, :int(rcnt[0])] == 0).all()


@pytest.mark.parametrize('connectivity', [4, 8])
def test_label_runs_fuzz_vs_scipy(connectivity):
    rng = np.random.default_rng(42 + connectivity)
    struct = ndimage.generate_binary_structure(
        2, 2 if connectivity == 8 else 1)
    for _ in range(40):
        h = int(rng.integers(2, 24))
        w = int(rng.integers(2, 40))
        img = rng.random((h, w)) < rng.uniform(0.15, 0.9)
        if not img.any():
            continue
        ref, _ = ndimage.label(img, structure=struct)
        runs, rcnt = _encode(img, w=w)
        lab, steps = trcc.label_runs(_t(runs), _t(rcnt), w=w,
                                     connectivity=connectivity)
        assert (_np(steps) < MAX_ITERS).all()
        geo = {k: _np(v)[0] for k, v in
               trcc.decode_runs(_t(runs), _t(rcnt), w).items()}
        n = int(rcnt[0])
        assert _partitions_equal(_np(lab)[0, :n],
                                 ref[geo['rows'][:n], geo['xs'][:n]])
        np.testing.assert_array_equal(
            _np(lab), np.asarray(jrcc.label_runs(runs, rcnt, w=w,
                                                 connectivity=connectivity)))


@pytest.mark.parametrize('double_threshold', [True, False])
def test_run_cc_components_matches_jax(double_threshold):
    for seed in (4, 6):
        runs, rcnt, w = _wire(seed)
        ref = jrcc.run_cc_components(runs, rcnt, w=w,
                                     double_threshold=double_threshold)
        got = trcc.run_cc_components(_t(runs), _t(rcnt), w=w,
                                     double_threshold=double_threshold)
        assert (_np(got['cc_steps']) < MAX_ITERS).all()
        for k in ('run_comp', 'n_components', 'n_px'):
            np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]),
                                          err_msg=k)


def test_run_cc_components_fuzz_vs_binary_propagation():
    """Kept runs and 8-connected ids against scipy, as in
    tests/test_run_cc.py::test_run_cc_components_end_to_end."""
    rng = np.random.default_rng(11)
    for _ in range(25):
        h = int(rng.integers(4, 28))
        w = int(rng.integers(4, 44))
        img = rng.random((h, w)) < rng.uniform(0.25, 0.75)
        marker = img & (rng.random((h, w)) < 0.2)
        if not img.any():
            continue
        kept_img = ndimage.binary_propagation(marker, mask=img)
        ref8, n_ref = ndimage.label(
            kept_img, structure=ndimage.generate_binary_structure(2, 2))
        runs, rcnt = _encode(img, marker=marker.astype(np.uint8) * 255, w=w)
        out = trcc.run_cc_components(_t(runs), _t(rcnt), w=w,
                                     double_threshold=True)
        out = {k: _np(v)[0] for k, v in out.items()}
        assert out['n_components'] == n_ref
        assert out['n_px'] == int(kept_img.sum())
        geo = {k: _np(v)[0] for k, v in
               trcc.decode_runs(_t(runs), _t(rcnt), w).items()}
        n = int(rcnt[0])
        kept = out['run_comp'][:n] >= 0
        np.testing.assert_array_equal(
            kept, ref8[geo['rows'][:n], geo['xs'][:n]] > 0)
        assert _partitions_equal(
            out['run_comp'][:n][kept],
            ref8[geo['rows'][:n][kept], geo['xs'][:n][kept]])


def _keep_cases():
    """Random images with markers, as tests/test_run_cc.py's
    test_keep_marked_runs_matches_binary_propagation draws them."""
    rng = np.random.default_rng(7)
    for _ in range(40):
        h = int(rng.integers(3, 24))
        w = int(rng.integers(3, 40))
        img = rng.random((h, w)) < rng.uniform(0.2, 0.8)
        marker = img & (rng.random((h, w)) < 0.15)
        if img.any():
            runs, rcnt = _encode(img, marker=marker.astype(np.uint8) * 255,
                                 w=w)
            yield img, marker, runs, rcnt, w


def test_keep_marked_runs_matches_jax_and_binary_propagation():
    """The kept runs: JAX's flags (the whole (T, R) table) and scipy's
    binary_propagation at each run's pixels."""
    for img, marker, runs, rcnt, w in _keep_cases():
        got = _np(trcc.keep_marked_runs(_t(runs), _t(rcnt), w=w))
        np.testing.assert_array_equal(
            got, np.asarray(jrcc.keep_marked_runs(runs, rcnt, w=w)))
        ref = ndimage.binary_propagation(marker, mask=img)
        geo = {k: _np(v)[0] for k, v in
               trcc.decode_runs(_t(runs), _t(rcnt), w).items()}
        n = int(rcnt[0])
        np.testing.assert_array_equal(
            got[0, :n], ref[geo['rows'][:n], geo['xs'][:n]])
        assert not got[0, n:].any()


# ---- the kernel's design (csrc/run_prop.cu), emulated in sequence ----

ROOT = 1 << 31


def _edges(init, win, link, skip_mirrored):
    """The undirected edges the kernel unites in one frame: chain links,
    valid window endpoints (clamped), and i ~ init[i] mod R. With
    ``skip_mirrored`` a lower endpoint that has run i as its own upper
    endpoint is left to that run, as the kernel does."""
    r = len(init)
    clamp = lambda a: np.clip(a, 0, r - 1)
    lo_up, hi_up = clamp(win['lo_up']), clamp(win['hi_up'])
    lo_dn, hi_dn = clamp(win['lo_dn']), clamp(win['hi_dn'])
    edges = []
    for i in range(r):
        if i + 1 < r and link[i]:
            edges.append((i + 1, i))
        if win['ok_up'][i]:
            edges += [(i, lo_up[i]), (i, hi_up[i])]
        if win['ok_dn'][i]:
            for j in (lo_dn[i], hi_dn[i]):
                mirrored = win['ok_up'][j] and i in (lo_up[j], hi_up[j])
                if not (skip_mirrored and mirrored and j != i):
                    edges.append((i, j))
        l = int(init[i])
        edges.append((i, int(clamp(l - r if l >= r else l))))
    return [(int(a), int(b)) for a, b in edges if a != b]


def _unite(fa, a, b):
    """The kernel's union on the tagged forest: a root's entry is ROOT |
    (minimum label of its tree), another's its parent's index."""
    while not fa[a] & ROOT:
        a = fa[a]
    while not fa[b] & ROOT:
        b = fa[b]
    if a == b:
        return
    if a < b:
        a, b = b, a
    va, vb = fa[a], fa[b]
    fa[a] = b
    if va < vb:
        fa[b] = va


def _union_find_labels(init, win, link, rng, skip_mirrored=True):
    """(T, R) labels of the kernel's three phases, frame by frame, with the
    edges in shuffled order."""
    out = np.empty_like(init)
    for f in range(init.shape[0]):
        fwin = {k: np.asarray(v[f]) for k, v in win.items()}
        edges = _edges(init[f], fwin, np.asarray(link[f]), skip_mirrored)
        fa = [ROOT | int(l) for l in init[f]]
        for e in rng.permutation(len(edges)):
            _unite(fa, *edges[e])
        for i in range(init.shape[1]):
            x = i
            while not fa[x] & ROOT:
                x = fa[x]
            out[f, i] = fa[x] & (ROOT - 1)
    return out


def _contract_init(comp, rng):
    """A random init inside the kernel's contract: every run names, mod R,
    a random run of its own component, with a random weak bit (+ R)."""
    t, r = comp.shape
    init = np.empty((t, r), np.int32)
    for f in range(t):
        for c in np.unique(comp[f]):
            members = np.nonzero(comp[f] == c)[0]
            init[f, members] = rng.choice(members, len(members))
    return init + r * (rng.random((t, r)) < 0.5).astype(np.int32)


def _np_win(twin):
    return {k: _np(v) for k, v in twin.items()}


def _chain_graph(n_runs):
    """One image row split into ``n_runs`` wire runs of 31 px, joined by
    chain links only: a path of n_runs - 1 hops."""
    w = 31 * n_runs
    img = np.ones((1, w), bool)
    r = 1 << n_runs.bit_length()
    runs, rcnt = _encode(img, w=w, r=r)
    assert int(rcnt[0]) == n_runs
    geo = trcc._prepare(_t(runs), _t(rcnt), w=w)
    win = trcc.run_windows(geo, dilate=1)
    return geo, win, trcc.chain_mask(geo, win), r


DESIGN_CASES = [('graphs', 4, 31), ('graphs', 8, 32), ('graphs', 8, 33),
                ('contract', 4, 34), ('contract', 8, 35), ('contract', 8, 36),
                ('chain', 8, 37), ('r1', 8, 38), ('all_invalid', 8, 39)]


def _design_inputs(case, connectivity, seed):
    """[(init, win, link)] as torch tensors for one design case."""
    rng = np.random.default_rng(seed)
    if case in ('graphs', 'contract'):
        out = []
        for _, _, _, tinit, twin, tlink in _graphs(seed, 6, connectivity):
            if case == 'contract':
                r = tinit.shape[1]
                iota = torch.arange(r, dtype=torch.int32)[None, :]
                comp = _np(trcc.propagate_min(iota, twin, tlink)[0])
                tinit = _t(_contract_init(comp, rng))
            out.append((tinit, twin, tlink))
        return out
    if case == 'chain':
        _, win, link, r = _chain_graph(100)
        init = torch.arange(r, dtype=torch.int32)[None, :]
        weak = init + r
        weak[0, 70] = 70            # the only marked run, 70 hops in
        return [(init, win, link), (weak.contiguous(), win, link)]
    r = 1 if case == 'r1' else 16
    runs = np.zeros((2, r), np.uint32)
    runs[0, 0] = 3 | (1 << 26) | (2 << 27)
    rcnt = np.array([0 if case == 'all_invalid' else 1, 0], np.int32)
    geo = trcc._prepare(_t(runs), _t(rcnt), w=32)
    win = trcc.run_windows(geo, dilate=1)
    iota = torch.arange(r, dtype=torch.int32).expand(2, r).contiguous()
    return [(iota, win, trcc.chain_mask(geo, win)),
            ((iota + r).contiguous(), win, trcc.chain_mask(geo, win))]


@pytest.mark.parametrize('skip_mirrored', [True, False])
@pytest.mark.parametrize('case,connectivity,seed', DESIGN_CASES)
def test_union_find_design_matches_propagate_min(case, connectivity, seed,
                                                 skip_mirrored):
    """A sequential emulation of the kernel (a union-find over its edge set
    with the minimum carried at the roots, edges in shuffled order) gives
    the plain version's labels: on random run graphs with the pipeline's
    two inits, on random inits of the contract, on a chain of 99 hops (the
    TPU kernel's cap is 64 sweeps), on R = 1 and on frames without runs."""
    rng = np.random.default_rng(seed + 100)
    for tinit, twin, tlink in _design_inputs(case, connectivity, seed):
        plain, steps = trcc.propagate_min(tinit, twin, tlink, max_iters=256)
        assert (_np(steps) < 256).all()
        got = _union_find_labels(_np(tinit), _np_win(twin), _np(tlink), rng,
                                 skip_mirrored)
        np.testing.assert_array_equal(got, _np(plain))
    if case == 'chain':
        assert (_np(plain)[0, :100] == 70).all()


def test_union_find_differs_from_plain_outside_the_contract():
    """An init whose label names a run of another component is outside the
    contract: the plain version reads the path-halving edge in one
    direction and in its own schedule (run 1 reaches label 0 through its
    link before it looks at run 2, and run 2 never looks at run 1), the
    union-find joins the two runs. Pinned so that the difference stays a
    known one."""
    r = 3
    init = np.array([[0, 2, 5]], np.int32)
    zero = np.zeros((1, r), np.int32)
    off = np.zeros((1, r), bool)
    win = {'lo_up': zero, 'hi_up': zero, 'lo_dn': zero, 'hi_dn': zero,
           'ok_up': off, 'ok_dn': off}
    link = np.array([[True, False, False]])
    plain, _ = trcc.propagate_min(_t(init), {k: _t(v) for k, v in win.items()},
                                  _t(link))
    assert _np(plain).tolist() == [[0, 0, 5]]
    got = _union_find_labels(init, win, link, np.random.default_rng(0))
    assert got.tolist() == [[0, 0, 0]]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """The CUDA kernel against the plain version on the card: exact labels,
    every frame converged, one launch counted per call. Runs on a machine
    with an NVIDIA GPU (see README)."""
    dev = _cuda()
    for init, jwin, jlink, tinit, twin, tlink in _graphs(23, 6):
        plain, _ = trcc.propagate_min(tinit, twin, tlink)
        before = propagate_min_fused.launches
        lab, steps = propagate_min_fused(
            tinit.to(dev), {k: v.to(dev) for k, v in twin.items()},
            tlink.to(dev), max_iters=MAX_ITERS)
        torch.cuda.synchronize()
        assert propagate_min_fused.launches == before + 1
        assert (steps.cpu().numpy() < MAX_ITERS).all()
        np.testing.assert_array_equal(lab.cpu().numpy(), _np(plain))


@pytest.mark.cuda
@pytest.mark.parametrize('case,connectivity,seed', DESIGN_CASES)
def test_kernel_matches_plain_on_design_cases_on_cuda(case, connectivity,
                                                      seed):
    """The kernel on the design cases: the plain
    version's labels, 0 steps, and with ``max_iters = 0`` a copy of the
    init. The window planes go in as slices of a wider table, as the
    pipeline's do."""
    dev = _cuda()
    for tinit, twin, tlink in _design_inputs(case, connectivity, seed):
        plain, _ = trcc.propagate_min(tinit, twin, tlink, max_iters=256)
        wide = torch.cat([twin[k] for k in ('lo_up', 'hi_up', 'lo_dn',
                                            'hi_dn')], dim=1).to(dev)
        r = tinit.shape[1]
        win = {k: wide[:, j * r:(j + 1) * r] for j, k in enumerate(
            ('lo_up', 'hi_up', 'lo_dn', 'hi_dn'))}
        win.update(ok_up=twin['ok_up'].to(dev), ok_dn=twin['ok_dn'].to(dev))
        lab, steps = propagate_min_fused(tinit.to(dev), win, tlink.to(dev))
        assert steps.cpu().tolist() == [0] * tinit.shape[0]
        np.testing.assert_array_equal(lab.cpu().numpy(), _np(plain))
        same, _ = propagate_min_fused(tinit.to(dev), win, tlink.to(dev),
                                      max_iters=0)
        np.testing.assert_array_equal(same.cpu().numpy(), _np(tinit))


@pytest.mark.cuda
def test_keep_marked_runs_kernel_matches_cpu_on_cuda():
    """keep_marked_runs through the kernel on the card: the plain run's
    flags on the CPU, one launch a call."""
    dev = _cuda()
    for _, _, runs, rcnt, w in _keep_cases():
        want = _np(trcc.keep_marked_runs(_t(runs), _t(rcnt), w=w))
        before = propagate_min_fused.launches
        got = trcc.keep_marked_runs(_t(runs).to(dev), _t(rcnt).to(dev), w=w)
        assert propagate_min_fused.launches == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want)


# ---- the launches of csrc/run_cc.cu (prepare, compact, finish),
# emulated in sequence on the seeded wires of run_cc_cases.py ----

import run_cc_cases  # noqa: E402

BIG28 = 1 << 28
BIG_I = 1 << 30
M26 = 0x03FFFFFF
PREPARE_CASES = (((0, 1), True), ((1,), False), ((0,), True), ((0,), False))


def _popc(a):
    a = np.asarray(a, np.uint64) & np.uint64(0xFFFFFFFF)
    n = np.zeros(a.shape, np.int64)
    for b in range(32):
        n += ((a >> np.uint64(b)) & np.uint64(1)).astype(np.int64)
    return n


def _magic(w):
    return (2 ** 64 - 1) // w + 1 if w >= 2 else 0


def _row_of(start, w):
    """The kernel's floor(start / w): the high word of start * ceil(2^64 /
    w), in two 32-bit halves of the multiplier."""
    mg = _magic(w)
    if not mg:
        return start.astype(np.int64)
    s = start.astype(np.uint64)
    lo = s * np.uint64(mg & 0xFFFFFFFF)
    hi = s * np.uint64(mg >> 32)
    return ((hi + (lo >> np.uint64(32))) >> np.uint64(32)).astype(np.int64)


def _decode(words, idx, count, w):
    """The kernel's decode of int32 words at run indices ``idx``."""
    words = np.asarray(words, np.int32)
    start = (words & M26).astype(np.int64)
    lens = ((words >> 27) & 0x1F).astype(np.int64)
    valid = (idx < count) & (lens > 0)
    mark = valid & (((words >> 26) & 1) > 0)
    row = _row_of(start, w)
    xs = start - row * w
    return {'row': row, 'xs': xs, 'xe': xs + lens - 1, 'lens': lens,
            'valid': valid, 'mark': mark, 'start': start}


def _bound(keys, lo, hi, q, upper):
    """torch.searchsorted's loop over keys[lo, hi), every query at once
    (``lo`` and ``hi`` arrays or scalars)."""
    lo = np.broadcast_to(np.asarray(lo, np.int64), q.shape).copy()
    hi = np.broadcast_to(np.asarray(hi, np.int64), q.shape).copy()
    while True:
        act = lo < hi
        if not act.any():
            return lo
        mid = lo + ((hi - lo) >> 1)
        key = keys[np.where(act, mid, 0)]
        right = ~(key > q) if upper else ~(key >= q)
        lo = np.where(act & right, mid + 1, lo)
        hi = np.where(act & ~right, mid, hi)


def _lower_below(keys, lo, i, q, steps=4):
    """The kernel's lower bound of q given i, that of a query above q: down
    while the key below is at least q, ``steps`` at most, then a search."""
    for _ in range(steps):
        if i <= lo or keys[i - 1] < q:
            return i
        i -= 1
    return int(_bound(keys, lo, i, np.array([q]), False)[0])


def _upper_above(keys, i, hi, q, steps=4):
    """... and the upper bound of q given i, that of a query below q."""
    for _ in range(steps):
        if i >= hi or keys[i] > q:
            return i
        i += 1
    return int(_bound(keys, i, hi, np.array([q]), True)[0])


def _emulate_prepare(runs, counts, w, dilates, weak, nt=256):
    """The prepare launches: the keys launch (every slot's key_e and
    key_s, a flag a block of ``nt`` slots where a key exceeds the next
    slot's), then blocks of ``nt`` threads covering ``nt - 1`` runs: on a
    frame without flags each block searches for the answers to its least
    and greatest queries and each run within them (with dilations d and
    d + 1 the second's answers stepped from the first's), else each run
    searches [0, R); the link from the next thread of the block."""
    t, r = runs.shape
    nd = len(dilates)
    m = w + 2
    ends = np.zeros((nd, 4, t, r), np.int64)
    oks = np.zeros((nd, 2, t, r), bool)
    link = np.zeros((t, r), bool)
    init = np.zeros((t, r), np.int64)
    valid = np.zeros((t, r), bool)
    idx = np.arange(r)
    for f in range(t):
        me = _decode(runs[f].view(np.int32), idx, counts[f], w)
        base = me['row'] * m
        key_e = np.where(me['valid'], base + me['xe'], BIG28)
        key_s = np.where(me['valid'], base + me['xs'], BIG28)
        down = (key_e[:-1] > key_e[1:]) | (key_s[:-1] > key_s[1:])
        in_order = not down.any()
        q_lo = np.stack([base + off + me['xs'] - d for d in dilates
                         for off in (-m, m)])
        q_hi = np.stack([base + off + me['xe'] + d for d in dilates
                         for off in (-m, m)])
        lo_res = np.zeros_like(q_lo)
        hi_res = np.zeros_like(q_hi)
        for b0 in range(0, r, nt - 1):
            blk = slice(b0, min(r, b0 + nt))   # the block's threads
            rng_lo, rng_hi = (0, r), (0, r)
            if in_order:
                ql, qh = q_lo[:, blk], q_hi[:, blk]
                rng_lo = tuple(int(_bound(key_e, 0, r, np.array([v]),
                                          False)[0])
                               for v in (ql.min(), ql.max()))
                rng_hi = tuple(int(_bound(key_s, 0, r, np.array([v]),
                                          True)[0])
                               for v in (qh.min(), qh.max()))
            own = slice(b0, min(r, b0 + nt - 1))
            lo_res[:, own] = _bound(key_e, *rng_lo, q_lo[:, own], False)
            hi_res[:, own] = _bound(key_s, *rng_hi, q_hi[:, own], True)
            if in_order and nd == 2 and dilates[1] == dilates[0] + 1:
                # the second dilation's answers stepped from the first's
                for k in (2, 3):
                    for j in range(own.start, own.stop):
                        lo_res[k, j] = _lower_below(
                            key_e, rng_lo[0], lo_res[k - 2, j], q_lo[k, j])
                        hi_res[k, j] = _upper_above(
                            key_s, hi_res[k - 2, j], rng_hi[1], q_hi[k, j])
        for k in range(nd):
            lo_up, lo_dn = lo_res[2 * k], lo_res[2 * k + 1]
            hi_up, hi_dn = hi_res[2 * k] - 1, hi_res[2 * k + 1] - 1
            ends[k, :, f] = lo_up, hi_up, lo_dn, hi_dn
            oks[k, 0, f] = me['valid'] & (lo_up <= hi_up)
            oks[k, 1, f] = me['valid'] & (lo_dn <= hi_dn)
        for b0 in range(0, r, nt - 1):
            for i in range(b0, min(r, b0 + nt - 1)):
                j = i + 1    # the next thread's run, i + 1 < r
                same = bool(me['valid'][i]) and j < r and \
                    bool(me['valid'][j]) and me['row'][j] == me['row'][i]
                e, o = ends[0, :, f], oks[0, :, f]
                link[f, i] = same and (
                    me['xs'][j] == me['xe'][i] + 1 or
                    (o[0, i] and o[0, j] and e[1, i] >= e[0, j]) or
                    (o[1, i] and o[1, j] and e[3, i] >= e[2, j]))
        init[f] = np.where(weak & ~me['mark'], idx + r, idx)
        valid[f] = me['valid']
    return ends, oks, link, init, valid


def _tile_words(flags, tile):
    """The bits launches' output for one frame: a bit a slot in 32-slot
    words, each word's bits and the set bits of its tile before it, and
    each tile's count (``tile`` slots a tile)."""
    r = len(flags)
    nw = (r + 31) // 32
    pad = np.zeros(nw * 32, bool)
    pad[:r] = flags
    bits = (pad.reshape(nw, 32).astype(np.uint64) <<
            np.arange(32, dtype=np.uint64)).sum(1)
    cnt = _popc(bits)
    per = tile // 32
    lpre = np.zeros(nw, np.int64)
    tcnt = np.zeros(-(-r // tile), np.int64)
    for k in range(len(tcnt)):
        seg = cnt[k * per:(k + 1) * per]
        lpre[k * per:(k + 1) * per] = np.cumsum(seg) - seg
        tcnt[k] = seg.sum()
    return bits, lpre, tcnt


class _Frame:
    """A second launch's view of a frame's bits: the tile counts scanned
    (shared memory), a slot's count before it and through it from one
    word, and the k-th set bit by two binary searches."""

    def __init__(self, bits, lpre, tcnt, tile):
        self.bits, self.lpre, self.tile = bits, lpre, tile
        self.tpre = np.cumsum(tcnt) - tcnt
        self.total = int(tcnt.sum())

    def before(self, j):
        j = np.asarray(j, np.int64)
        below = (np.uint64(1) << (j & 31).astype(np.uint64)) - np.uint64(1)
        return self.tpre[j // self.tile] + self.lpre[j >> 5] + \
            _popc(self.bits[j >> 5] & below)

    def bit(self, j):
        j = np.asarray(j, np.int64)
        return ((self.bits[j >> 5] >> (j & 31).astype(np.uint64)) &
                np.uint64(1)).astype(bool)

    def through(self, j):
        return self.before(j) + self.bit(j)

    def select(self, k):
        lo, hi = 0, len(self.tpre) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if self.tpre[mid] <= k:
                lo = mid
            else:
                hi = mid - 1
        rest = k - int(self.tpre[lo])
        per = self.tile // 32
        a, b = lo * per, min(len(self.bits), lo * per + per) - 1
        while a < b:
            mid = (a + b + 1) >> 1
            if self.lpre[mid] <= rest:
                a = mid
            else:
                b = mid - 1
        m = int(self.bits[a])
        for _ in range(rest - int(self.lpre[a])):
            m &= m - 1
        return a * 32 + (m & -m).bit_length() - 1


def _slots(r, tile, threads):
    """Each tile's slots in the launches' order: thread-major chunks of
    ``threads`` (a thread's slots u * threads + thread)."""
    for t0 in range(0, r, tile):
        for u in range(tile // threads):
            for th in range(threads):
                j = t0 + u * threads + th
                if j < r:
                    yield t0 // tile, j


def _emulate_compact(runs, counts, w, lab4, win8o, tile=1024, threads=256):
    """The compact launches, frame by frame: the keep bits in tile words
    and counts; then, a tile at a time, each wire run's compacted slot,
    its window remapped through the counts and, once the tile's kept runs
    are placed, its link to the next kept run (the rest of its word, the
    next word or a search of the counts; the tile's own runs' windows as
    placed, a run past the tile's remapped anew)."""
    t, r = runs.shape
    out = {'init': np.tile(np.arange(r), (t, 1)),
           'ends': np.zeros((4, t, r), np.int64),
           'oks': np.zeros((2, t, r), bool),
           'link': np.zeros((t, r), bool),
           'c_orig': np.zeros((t, r), np.int64),
           'n_kept': np.zeros(t, np.int64)}
    idx = np.arange(r)
    for f in range(t):
        words = runs[f].view(np.int32)
        geo = _decode(words, idx, counts[f], w)
        fr = _Frame(*_tile_words(geo['valid'] & (lab4[f] < r), tile), tile)
        kept = fr.total

        def remap(j, c_valid):
            e = [int(np.clip(win8o[k][f, j], 0, r - 1))
                 for k in ('lo_up', 'hi_up', 'lo_dn', 'hi_dn')]
            lo_up, lo_dn = int(fr.before(e[0])), int(fr.before(e[2]))
            hi_up = int(fr.through(e[1])) - 1
            hi_dn = int(fr.through(e[3])) - 1
            return (lo_up, hi_up, lo_dn, hi_dn,
                    c_valid and bool(win8o['ok_up'][f, j]) and
                    lo_up <= hi_up,
                    c_valid and bool(win8o['ok_dn'][f, j]) and
                    lo_dn <= hi_dn)

        placed = {}
        order = list(_slots(r, tile, threads))
        for k0 in range(0, len(order), tile):
            block = order[k0:k0 + tile]
            shared = {}
            for _, j in block:
                keep = bool(fr.bit(j))
                before = int(fr.before(j))
                p = before if keep else kept + j - before
                placed[j] = p
                out['c_orig'][f, p] = j
                o = remap(j, keep)
                out['ends'][:, f, p] = o[:4]
                out['oks'][:, f, p] = o[4:]
                if keep:
                    shared[j] = o
            for tl, j in block:
                p = placed[j]
                if not fr.bit(j) or p + 1 >= kept:
                    out['link'][f, p] = False
                    continue
                rest = int(fr.bits[j >> 5]) & ~((2 << (j & 31)) - 1) & \
                    0xFFFFFFFF
                if rest:
                    j2 = (j & ~31) + (rest & -rest).bit_length() - 1
                else:
                    wd = (j >> 5) + 1
                    m = int(fr.bits[wd]) if wd < len(fr.bits) else 0
                    j2 = wd * 32 + (m & -m).bit_length() - 1 if m else \
                        fr.select(p + 1)
                o, o2 = shared[j], shared.get(j2)
                if o2 is None:
                    assert j2 >= (tl + 1) * tile
                    o2 = remap(j2, True)
                same = geo['row'][j2] == geo['row'][j]
                out['link'][f, p] = same and (
                    geo['xs'][j2] == geo['xe'][j] + 1 or
                    (o[4] and o2[4] and o[1] >= o2[0]) or
                    (o[5] and o2[5] and o[3] >= o2[2]))
        out['n_kept'][f] = kept
    return out


#: a root row the roots launch never wrote (the scratch's garbage)
_UNWRITTEN = -(1 << 20)


def _emulate_finish(runs, counts, w, lab8, c_orig, n_kept, tables=None,
                    tile=1024, threads=256):
    """The finish launches, frame by frame. Roots: root bits in tile
    words and counts, each root's row, and the frame's flag (a valid wire
    run after an invalid slot or a later row, a label past its slot).
    Ids: each slot's rank at its clamped label, the scatter to wire order
    and the pixel count; with ``tables`` (h, max_det, max_bh), for an id
    below max_det, the x extremes at the row less the root's row (the
    root at the label, else the rank's root by a search), merged within
    a warp's 32 slots into the last lane of each stretch of one entry,
    the root's row as min_y; in a flagged frame the components' least
    rows first, then a run's updates against them. (The tables' fill,
    a frame ahead of its updates, changes no bit.)"""
    t, r = runs.shape
    idx = np.arange(r)
    out = {'run_comp': np.zeros((t, r), np.int64),
           'n_components': np.zeros(t, np.int64),
           'n_px': np.zeros(t, np.int64)}
    if tables is not None:
        _, max_det, max_bh = tables
        out.update(row_min_x=np.full((t, max_det, max_bh), BIG_I, np.int64),
                   row_max_x=np.full((t, max_det, max_bh), -BIG_I, np.int64),
                   row_valid=np.zeros((t, max_det, max_bh), bool),
                   min_y=np.full((t, max_det), BIG_I, np.int64))
    for f in range(t):
        words = runs[f].view(np.int32)
        wire = _decode(words, idx, counts[f], w)
        orig = idx if c_orig is None else c_orig[f]
        geo = _decode(words[orig], orig, counts[f], w)
        valid = geo['valid'] if c_orig is None else idx < n_kept[f]
        lab = lab8[f]
        roots = valid & (lab == idx)
        prev_ok = np.concatenate([[True], wire['valid'][:-1]])
        prev_row = np.concatenate([[0], wire['row'][:-1]])
        flag = bool((wire['valid'] & (idx > 0) &
                     (~prev_ok | (prev_row > wire['row']))).any() or
                    (valid & (lab > idx)).any())
        root_row = np.full(r, _UNWRITTEN, np.int64)
        root_row[roots] = geo['row'][roots]
        fr = _Frame(*_tile_words(roots, tile), tile)
        n_comp = fr.total
        labc = np.clip(lab, 0, r - 1)
        asc = fr.through(labc) - 1
        at_root = fr.bit(labc)
        for _, p in _slots(r, tile, threads):
            out['run_comp'][f, orig[p]] = asc[p] if valid[p] else -1
        out['n_px'][f] = np.where(valid, geo['lens'], 0).sum()
        out['n_components'][f] = n_comp
        if tables is None:
            continue

        def entry(p, y0):
            i = n_comp - 1 - asc[p]
            return i * max_bh + min(max(geo['row'][p] - y0, 0), max_bh - 1)

        def update(e, lo, hi):
            i, rel = divmod(e, max_bh)
            out['row_min_x'][f, i, rel] = min(out['row_min_x'][f, i, rel], lo)
            out['row_max_x'][f, i, rel] = max(out['row_max_x'][f, i, rel], hi)
            out['row_valid'][f, i, rel] = True

        order = [p for _, p in _slots(r, tile, threads)]
        live = [p for p in order if valid[p] and asc[p] >= 0 and
                n_comp - 1 - asc[p] < max_det]
        if flag:
            for p in live:
                i = n_comp - 1 - asc[p]
                out['min_y'][f, i] = min(out['min_y'][f, i], geo['row'][p])
            for p in live:
                update(entry(p, out['min_y'][f, n_comp - 1 - asc[p]]),
                       geo['xs'][p], geo['xe'][p])
            continue
        live = set(live)
        for w0 in range(0, len(order), 32):
            # a warp's 32 slots: each run's entry, merged into the lanes
            # after it with its entry, one update a stretch's last lane
            lanes = order[w0:w0 + 32]
            ent = []
            for p in lanes:
                e = -1
                if p in live:
                    y0 = root_row[labc[p]] if at_root[p] else \
                        root_row[fr.select(int(asc[p]))]
                    assert y0 != _UNWRITTEN
                    e = entry(p, y0)
                    if at_root[p] and labc[p] == p:
                        out['min_y'][f, n_comp - 1 - asc[p]] = geo['row'][p]
                ent.append(e)
            lo = [geo['xs'][p] for p in lanes]
            hi = [geo['xe'][p] for p in lanes]
            for o in (1, 2, 4, 8, 16):
                same = [k >= o and ent[k - o] == ent[k]
                        for k in range(len(lanes))]
                lo = [min(v, lo[k - o]) if same[k] else v
                      for k, v in enumerate(lo)]
                hi = [max(v, hi[k - o]) if same[k] else v
                      for k, v in enumerate(hi)]
            for k, e in enumerate(ent):
                if e >= 0 and (k + 1 == len(ent) or ent[k + 1] != e):
                    update(e, lo[k], hi[k])
    if tables is not None:
        for k in ('row_min_x', 'row_max_x', 'row_valid'):
            out[k] = out[k].reshape(t * max_det, max_bh)
        out['min_y'] = out['min_y'].reshape(-1)
    return out


def _case_wire(case):
    runs, counts, w = run_cc_cases.run_case(case)
    return runs, counts, w, _t(runs), _t(counts)


@pytest.mark.parametrize('case', run_cc_cases.CASES)
def test_prepare_design_matches_plain(case):
    """The prepare launches' design (the keys and the blocks' order flags;
    on a frame in order each block's searches within the answers to its
    least and greatest queries, else torch's binary search over the
    frame; blocks of 256 threads covering 255 runs for the link) gives the
    plain version's planes, for one and two dilations and both inits."""
    runs, counts, w, truns, tcounts = _case_wire(case)
    for dilates, weak in PREPARE_CASES:
        want = trcc.prepare_runs_plain(truns, tcounts, w=w, dilates=dilates,
                                       weak_init=weak)
        ends, oks, link, init, valid = _emulate_prepare(runs, counts, w,
                                                        dilates, weak)
        for k, win in enumerate(want['wins']):
            for j, key in enumerate(('lo_up', 'hi_up', 'lo_dn', 'hi_dn')):
                np.testing.assert_array_equal(ends[k, j], _np(win[key]),
                                              err_msg=key)
            for j, key in enumerate(('ok_up', 'ok_dn')):
                np.testing.assert_array_equal(oks[k, j], _np(win[key]))
        np.testing.assert_array_equal(link, _np(want['link']))
        np.testing.assert_array_equal(init, _np(want['init']))
        np.testing.assert_array_equal(valid, _np(want['valid']))


#: tile sizes of the design tests: the kernels' (1024 slots, 256
#: threads) and small tiles, so that the cases' frames span many tiles
TILES = ((1024, 256), (64, 16))


@pytest.mark.parametrize('tile', TILES)
@pytest.mark.parametrize('case', run_cc_cases.CASES)
def test_compact_design_matches_plain(case, tile):
    """The compact launches' design (keep bits in tile words and counts,
    the scanned tile counts, the slot of each wire run, windows remapped
    through the counts, the link to the next kept run from the tile's
    placed runs or anew) gives the plain compaction."""
    runs, counts, w, truns, tcounts = _case_wire(case)
    g = trcc.prepare_runs_plain(truns, tcounts, w=w, dilates=(0, 1),
                                weak_init=True)
    lab4, _ = trcc.propagate_min(g['init'], g['wins'][0], g['link'],
                                 max_iters=256)
    want = trcc.compact_kept_runs_plain(truns, tcounts, lab4, g['wins'][1],
                                        w=w)
    got = _emulate_compact(runs, counts, w, _np(lab4),
                           {k: _np(v) for k, v in g['wins'][1].items()},
                           *tile)
    for j, key in enumerate(('lo_up', 'hi_up', 'lo_dn', 'hi_dn')):
        np.testing.assert_array_equal(got['ends'][j], _np(want['win'][key]))
    for j, key in enumerate(('ok_up', 'ok_dn')):
        np.testing.assert_array_equal(got['oks'][j], _np(want['win'][key]))
    for key in ('init', 'link', 'c_orig', 'n_kept'):
        np.testing.assert_array_equal(got[key], _np(want[key]), err_msg=key)


def _case_height(runs, counts, w):
    """A frame height the case's valid runs lie in (the row tables'
    ``h``): one past their greatest row."""
    t, r = runs.shape
    geo = _decode(runs.view(np.int32), np.arange(r)[None, :],
                  counts[:, None], w)
    return int(geo['row'][geo['valid']].max(initial=0)) + 1


def _finish_inputs(case):
    """The finish's inputs of a case: the double threshold's (8-connected
    labels over the compaction) and the single threshold's, each with the
    propagation's labels converged, after one step (labels that name no
    root), and random labels (some past their slot)."""
    runs, counts, w, truns, tcounts = _case_wire(case)
    g = trcc.prepare_runs_plain(truns, tcounts, w=w, dilates=(0, 1),
                                weak_init=True)
    lab4, steps4 = trcc.propagate_min(g['init'], g['wins'][0], g['link'],
                                      max_iters=256)
    c = trcc.compact_kept_runs_plain(truns, tcounts, lab4, g['wins'][1],
                                     w=w)
    s = trcc.prepare_runs_plain(truns, tcounts, w=w, dilates=(1,))
    rng = np.random.default_rng(5)
    out = []
    for init, win, link, c_orig, n_kept, st4 in (
            (c['init'], c['win'], c['link'], c['c_orig'], c['n_kept'],
             steps4),
            (s['init'], s['wins'][0], s['link'], None, None, None)):
        for iters in (256, 1, None):
            if iters is None:
                lab = torch.from_numpy(rng.integers(
                    -2, runs.shape[1] + 2, runs.shape).astype(np.int32))
                steps = torch.zeros(runs.shape[0], dtype=torch.int32)
            else:
                lab, steps = trcc.propagate_min(init, win, link,
                                                max_iters=iters)
            out.append((lab, c_orig, n_kept, st4, steps))
    return runs, counts, w, truns, tcounts, out


#: the row tables' capacities of the design tests: (max_det, max_bh), ids
#: past max_det dropped where max_det is 3
TABLE_SIZES = ((64, 8), (64, 1), (3, 8))


@pytest.mark.parametrize('tile', TILES)
@pytest.mark.parametrize('case', run_cc_cases.CASES)
def test_finish_design_matches_plain(case, tile):
    """The finish launches' design (root bits in tile words and counts,
    the roots' rows and the frame's flag; the scanned tile counts, each
    slot's rank at its label, the scatter; the row tables' updates at the
    row less the root's row, or the components' least rows first in a
    flagged frame) gives the plain ids, counts and row tables (the sorted
    runs through ``labeling.run_row_tables``), after the compaction and
    on the wire's table, with converged, one-step and random labels, with
    a table of 8 rows and of 1 and with ids past max_det."""
    runs, counts, w, truns, tcounts, inputs = _finish_inputs(case)
    h = _case_height(runs, counts, w)
    for lab, c_orig, n_kept, st4, st8 in inputs:
        args = (None if c_orig is None else _np(c_orig),
                None if n_kept is None else _np(n_kept))
        for sizes in (None,) + TABLE_SIZES:
            tables = None if sizes is None else \
                dict(h=h, max_det=sizes[0], max_bh=sizes[1])
            want = trcc.finish_components_plain(
                truns, tcounts, lab, c_orig, n_kept, st4, st8, w=w,
                row_tables=tables)
            got = _emulate_finish(runs, counts, w, _np(lab), *args,
                                  None if sizes is None else (h,) + sizes,
                                  *tile)
            for key in got:
                np.testing.assert_array_equal(
                    got[key], _np(want[key]),
                    err_msg='{} {}'.format(key, sizes))


@pytest.mark.parametrize('case', run_cc_cases.CASES)
def test_finish_row_tables_are_component_stats_runs(case):
    """The plain finish's row tables are ``component_stats_runs``' over the
    plain sorted runs with the ids reversed (the dense path's former
    composition), on every case, with 8 rows and 1 and ids past max_det;
    with the sorted runs asked for too, those are unchanged."""
    runs, counts, w, truns, tcounts, inputs = _finish_inputs(case)
    h = _case_height(runs, counts, w)
    for lab, c_orig, n_kept, st4, st8 in inputs[:1] + inputs[3:4]:
        srt = trcc.finish_components_plain(truns, tcounts, lab, c_orig,
                                           n_kept, st4, st8, w=w,
                                           sorted_runs=True)
        n = srt['n_components']
        comp_rev = torch.where(srt['s_comp'] >= 0,
                               n[:, None] - 1 - srt['s_comp'],
                               torch.full_like(srt['s_comp'], -1))
        for max_det, max_bh in TABLE_SIZES:
            tables = dict(h=h, max_det=max_det, max_bh=max_bh)
            got = trcc.finish_components_plain(
                truns, tcounts, lab, c_orig, n_kept, st4, st8, w=w,
                sorted_runs=True, row_tables=tables)
            want = lb.component_stats_runs(
                srt['s_start'], srt['s_len'], comp_rev, w=w, h=h,
                max_det=max_det, max_bh=max_bh)
            for key in trcc.TABLE_KEYS:
                np.testing.assert_array_equal(_np(got[key]), _np(want[key]),
                                              err_msg=key)
            for key in srt:
                np.testing.assert_array_equal(_np(got[key]), _np(srt[key]),
                                              err_msg=key)


def test_row_tables_need_rows_below_h():
    """Pinned: the plain row tables decode a component's first row from
    ``bit_length(h - 1)`` bits, so a valid run at or below row ``h`` (past
    the encoder's contract, start < h w) makes them differ from the
    kernel's design, which takes the root's row whole; with every row
    below ``h`` they agree, at any larger ``h``."""
    runs, counts, w, truns, tcounts, inputs = _finish_inputs('blobs')
    lab, c_orig, n_kept, st4, st8 = inputs[0]
    h = _case_height(runs, counts, w)
    args = (_np(c_orig), _np(n_kept))
    for hh, same in ((h, True), (4 * h, True), (h // 4, False)):
        tables = dict(h=hh, max_det=64, max_bh=8)
        want = trcc.finish_components_plain(
            truns, tcounts, lab, c_orig, n_kept, st4, st8, w=w,
            row_tables=tables)
        got = _emulate_finish(runs, counts, w, _np(lab), *args,
                              (hh, 64, 8))
        assert all(np.array_equal(got[k], _np(want[k]))
                   for k in trcc.TABLE_KEYS) == same, hh


def test_select_bit_design_finds_each_set_bit():
    """The search for a frame's k-th set bit (the last tile, then the last
    word, whose count before it is at most k; then the bit in the word)
    over random bits with empty words and tiles, at tile sizes 1024, 64
    and 32."""
    rng = np.random.default_rng(11)
    for r, dens in ((1, 1.0), (31, 0.5), (700, 0.02), (2500, 0.3),
                    (4096, 0.001)):
        flags = rng.random(r) < dens
        flags[r // 3:r // 2] = False
        for tile in (1024, 64, 32):
            fr = _Frame(*_tile_words(flags, tile), tile)
            want = np.nonzero(flags)[0]
            assert fr.total == len(want)
            assert [fr.select(k) for k in range(len(want))] == want.tolist()


def test_stepped_bounds_equal_searches():
    """The prepare launch's step from one dilation's answer to the next
    dilation's (down from the lower bound of q + 1, up from the upper
    bound of q - 1) gives the search's answer on keys that do not
    decrease, runs of equal keys included, within 0, 1 and 4 steps."""
    rng = np.random.default_rng(9)
    for _ in range(200):
        keys = np.sort(rng.integers(0, 40, int(rng.integers(1, 60))))
        lo, hi = sorted(rng.integers(0, len(keys) + 1, 2))
        for q in range(-2, 43):
            want_lo = int(_bound(keys, lo, hi, np.array([q]), False)[0])
            want_hi = int(_bound(keys, lo, hi, np.array([q]), True)[0])
            i_lo = int(_bound(keys, lo, hi, np.array([q + 1]), False)[0])
            i_hi = int(_bound(keys, lo, hi, np.array([q - 1]), True)[0])
            for steps in (0, 1, 4):
                assert _lower_below(keys, lo, i_lo, q, steps) == want_lo
                assert _upper_above(keys, i_hi, hi, q, steps) == want_hi


def test_magic_division_is_floor_division():
    """The kernels' row: the high word of start * ceil(2^64 / w), against
    floor division for starts up to 2^26 - 1 and widths 1 to 2^26."""
    rng = np.random.default_rng(3)
    starts = np.concatenate([rng.integers(0, 1 << 26, 4000),
                             [0, 1, (1 << 26) - 1]])
    for w in [1, 2, 3, 7, 31, 32, 33, 922, 1228, 4095, 65537,
              (1 << 26) - 1, 1 << 26]:
        s = np.concatenate([starts, np.arange(1, 40) * w - 1,
                            np.arange(1, 40) * w]) % (1 << 26)
        np.testing.assert_array_equal(_row_of(s, w), s // w)


@pytest.mark.parametrize('double_threshold', [True, False])
def test_run_cc_components_match_jax_on_cases(double_threshold):
    """``run_cc_components`` against ysmr_tpu's on every seeded wire of
    run_cc_cases.py that the encoder can write (stale padding, a padded
    frame, a full table, edges, one row, no markers, all markers, one and
    two columns), the sorted run tables included. On runs of length 0
    below a count or out of raster order (``zero_length``,
    ``unordered``) the packages' window searches differ: ysmr_tpu merges
    the key rows as if sorted, the port bisects them as
    ``torch.searchsorted`` does; the kernels follow the port's plain
    version there too (the design tests above)."""
    for case in run_cc_cases.WIRE_CASES:
        runs, counts, w, truns, tcounts = _case_wire(case)
        ref = jrcc.run_cc_components(runs, counts, w=w,
                                     double_threshold=double_threshold)
        got = trcc.run_cc_components(truns, tcounts, w=w,
                                     double_threshold=double_threshold,
                                     sorted_runs=True)
        for k in ('run_comp', 'n_components', 'n_px', 's_start', 's_len',
                  's_comp'):
            np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]),
                                          err_msg='{} {}'.format(case, k))


@pytest.mark.parametrize('double_threshold', [True, False])
def test_run_cc_row_tables_match_jax_on_cases(double_threshold):
    """``run_cc_components`` with ``row_tables`` (the dense path's call)
    against ysmr_tpu's ``run_cc_components`` followed by its
    ``component_stats_runs`` on each frame's sorted runs, ids reversed as
    the JAX pipeline reverses them, on every wire the encoder can write,
    with ids past max_det and a one-row table too. Exact: every table is
    integer."""
    for case in run_cc_cases.WIRE_CASES:
        runs, counts, w, truns, tcounts = _case_wire(case)
        h = _case_height(runs, counts, w)
        ref = jrcc.run_cc_components(runs, counts, w=w,
                                     double_threshold=double_threshold)
        n = np.asarray(ref['n_components'])
        s_comp = np.asarray(ref['s_comp'])
        comp_rev = np.where(s_comp >= 0, n[:, None] - 1 - s_comp, -1)
        for max_det, max_bh in TABLE_SIZES:
            got = trcc.run_cc_components(
                truns, tcounts, w=w, double_threshold=double_threshold,
                row_tables=dict(h=h, max_det=max_det, max_bh=max_bh))
            per = [jlb.component_stats_runs(
                jnp.asarray(ref['s_start'][i]), jnp.asarray(ref['s_len'][i]),
                jnp.asarray(comp_rev[i].astype(np.int32)), w=w, h=h,
                max_det=max_det, max_bh=max_bh, cv2_centers=True)
                for i in range(runs.shape[0])]
            for key in trcc.TABLE_KEYS:
                want = np.concatenate([np.asarray(p[key]) for p in per])
                np.testing.assert_array_equal(
                    _np(got[key]), want,
                    err_msg='{} {} {}'.format(case, key, max_det))
            for key in ('run_comp', 'n_components', 'n_px'):
                np.testing.assert_array_equal(_np(got[key]),
                                              np.asarray(ref[key]))


def test_run_cc_wrappers_take_plain_versions_on_cpu():
    """On a CPU tensor each wrapper is its plain version and counts no
    launch; ``run_cc_components`` is ``run_cc_components_plain``."""
    names = ('prepare_runs', 'compact_kept_runs', 'finish_components')
    before = [getattr(trcc, n).launches for n in names]
    runs, counts, w, truns, tcounts = _case_wire('blobs')
    for double in (True, False):
        kw = dict(w=w, double_threshold=double, sorted_runs=True)
        got = trcc.run_cc_components(truns, tcounts, **kw)
        want = trcc.run_cc_components_plain(truns, tcounts, **kw)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(_np(got[k]), _np(want[k]))
    g = trcc.prepare_runs(truns, tcounts, w=w, dilates=(0, 1),
                          weak_init=True)
    want = trcc.prepare_runs_plain(truns, tcounts, w=w, dilates=(0, 1),
                                   weak_init=True)
    for k in ('init', 'valid', 'link'):
        np.testing.assert_array_equal(_np(g[k]), _np(want[k]))
    assert [getattr(trcc, n).launches for n in names] == before


def test_run_cc_wrappers_refuse_other_devices():
    """No silent fallback: a wire neither on the CPU nor on a CUDA device
    is refused by each wrapper."""
    runs = torch.zeros((2, 8), dtype=torch.int32, device='meta')
    counts = torch.zeros((2,), dtype=torch.int32, device='meta')
    plane = torch.zeros((2, 8), dtype=torch.int32, device='meta')
    win = {k: plane if k[:2] in ('lo', 'hi') else plane.bool()
           for k in ('lo_up', 'hi_up', 'lo_dn', 'hi_dn', 'ok_up', 'ok_dn')}
    with pytest.raises(ValueError):
        trcc.prepare_runs(runs, counts, w=8, dilates=(1,))
    with pytest.raises(ValueError):
        trcc.compact_kept_runs(runs, counts, plane, win, w=8)
    with pytest.raises(ValueError):
        trcc.finish_components(runs, counts, plane, None, None, None,
                               counts, w=8)
