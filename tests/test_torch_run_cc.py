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


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """The CUDA kernel against the plain version on the card: exact labels,
    every frame converged, one launch counted per call. Runs on a machine
    with an NVIDIA GPU (see README)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    dev = torch.device('cuda')
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
