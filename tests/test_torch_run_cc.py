"""Run-graph CC of the PyTorch port (ysmr_tpu_torch/ops/run_cc.py and the
kernel wrapper ops/run_prop.py) against the JAX reference module and scipy.

The same numpy inputs (made from a seed) go through both packages: the
JAX side runs with ``use_pallas=False`` and, for the kernel's contract,
``propagate_min_fused(..., interpret=True)``. Integers must match exactly,
and every propagation must report convergence (before the fixpoint the
labels depend on the schedule).
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from test_run_cc import _encode, _partitions_equal
from test_runs_wire import _random_wire
from ysmr_tpu import native as jnative
from ysmr_tpu.ops import run_cc as jrcc
from ysmr_tpu.ops.pallas_run_prop import propagate_min_fused as jfused
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
