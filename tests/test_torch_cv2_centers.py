"""cv2 centers of the PyTorch port (ysmr_tpu_torch/ops/cv2_centers.py)
against the JAX package's ops/cv2_centers.py and the pure-Python cv2
oracle, on the fuzz generators of tests/test_cv2_centers.py.

Tolerance: none. Centers, ``ok`` flags and the inverse-sqrt table are
bit-equal to JAX's on every input, and equal to the oracle's f32 center
for every simple (not self-touching) component.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cv2_centers import (is_degenerate, random_blob, tables_from_blobs,
                              thin_rod)
from ysmr_tpu.ops import cv2_centers as jcc
from ysmr_tpu.ops import cv2_exact as oracle
from ysmr_tpu_torch.ops import cv2_centers as tcc
from ysmr_tpu_torch.ops import labeling as lb

torch.set_num_threads(1)

R = 24   # rows of the table: the generators' blobs are at most 21 tall
MAX_EDGE_W = 256


def _blobs(gen, n, seed):
    rng = np.random.default_rng(seed)
    make = random_blob if gen == 'mixed' else thin_rod
    return [make(rng, max_side=20) if gen == 'mixed' else make(rng)
            for _ in range(n)]


def _tables(blobs, r=R):
    rmin, rmax, rvalid, min_y = tables_from_blobs(blobs)
    return rmin[:, :r], rmax[:, :r], rvalid[:, :r], min_y


def _port(rmin, rmax, rvalid, min_y):
    """Corners from the port's hull (the pipeline's source of them)."""
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (rmin, rmax, rvalid, min_y)]
    *_, cl, cr, _ = lb._hull_edge_data(*t)
    isq = tcc.inv_sqrt_table(MAX_EDGE_W, rmin.shape[1])
    cx, cy, ok = tcc.cv2_centers_from_tables(t[0], t[1], t[2], t[3], cl, cr,
                                             isq, max_bh=rmin.shape[1])
    return cx.numpy(), cy.numpy(), ok.numpy()


def _jax(rmin, rmax, rvalid, min_y):
    tab = jcc.inv_sqrt_table(MAX_EDGE_W, rmin.shape[1])
    out = jcc.cv2_centers_standalone(
        jnp.asarray(rmin), jnp.asarray(rmax), jnp.asarray(rvalid),
        jnp.asarray(min_y), tab, max_bh=rmin.shape[1])
    return [np.asarray(o) for o in out]


def test_inv_sqrt_table_bit_equal():
    np.testing.assert_array_equal(
        tcc.inv_sqrt_table(MAX_EDGE_W, R).numpy(),
        np.asarray(jcc.inv_sqrt_table(MAX_EDGE_W, R)))


@pytest.mark.parametrize('gen,seed', [('mixed', 7), ('rod', 8),
                                      ('mixed', 21)])
def test_centers_bit_equal_to_jax_and_oracle(gen, seed):
    blobs = _blobs(gen, 80, seed)
    tabs = _tables(blobs)
    cx, cy, ok = _port(*tabs)
    jx, jy, jok = _jax(*tabs)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(cx, jx)
    np.testing.assert_array_equal(cy, jy)
    assert ok.all()
    bad = []
    for i, (xs, ys) in enumerate(blobs):
        (rcx, rcy), _, _ = oracle.rect_from_component_pixels(xs, ys)
        if not (np.float32(rcx) == cx[i] and np.float32(rcy) == cy[i]) \
                and not is_degenerate(xs, ys):
            bad.append((i, float(rcx), float(rcy), cx[i], cy[i]))
    assert not bad, bad[:5]


def test_line_point_and_wide_components():
    blobs = [(np.array([40]), np.array([50])),
             (np.arange(30, 45), np.full(15, 60)),
             (np.full(12, 33), np.arange(20, 32)),
             (np.arange(10, 22), np.arange(40, 52)),
             (np.tile(np.arange(0, 400), 2),
              np.concatenate([np.full(400, 10), np.full(400, 11)]))]
    tabs = _tables(blobs)
    cx, cy, ok = _port(*tabs)
    jx, jy, jok = _jax(*tabs)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(cx[ok], jx[ok])
    np.testing.assert_array_equal(cy[ok], jy[ok])
    assert ok[:4].all() and not ok[4]
    for i in range(4):
        (rcx, rcy), _, _ = oracle.rect_from_component_pixels(*blobs[i])
        assert np.float32(rcx) == cx[i] and np.float32(rcy) == cy[i]


def test_chunks_and_empty_components_do_not_change_results(monkeypatch):
    """Chunking over components is invisible, and all-invalid slots (the
    padding of a dense batch) give JAX's outputs too."""
    blobs = _blobs('mixed', 40, 3)
    rmin, rmax, rvalid, min_y = _tables(blobs)
    rmin[5], rmax[5], rvalid[5], min_y[5] = 1 << 30, -(1 << 30), False, 0
    ref = _port(rmin, rmax, rvalid, min_y)
    jx, jy, jok = _jax(rmin, rmax, rvalid, min_y)
    np.testing.assert_array_equal(ref[2], jok)
    np.testing.assert_array_equal(ref[0][jok], jx[jok])
    monkeypatch.setattr(tcc, '_CHUNK', 7)
    got = _port(rmin, rmax, rvalid, min_y)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
