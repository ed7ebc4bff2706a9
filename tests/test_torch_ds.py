"""Double-single arithmetic of the PyTorch port (ysmr_tpu_torch/ops/ds.py)
against the JAX package's ops/ds.py and a float64 oracle.

Tolerances and why:
- against JAX run op by op (no ``jit``): bit-equal, since both run the
  same IEEE float32 operations in the same order;
- against JAX under ``jit``: XLA:CPU contracts products and sums into fmas,
  which changes the lo halves; the double-single values (hi + lo in
  float64) agree to 2^-40 relative, far inside what the filter bank and
  the area comparisons need;
- against float64: two_sum and two_prod are exact; add, mul and div carry
  ~2^-44 relative error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ysmr_tpu.ops import ds as jds
from ysmr_tpu_torch.ops import ds

torch.set_num_threads(1)

N = 4000


def _pairs(seed):
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-3, 4, (4, N))
    v = (rng.choice([-1.0, 1.0], (4, N)) * mag).astype(np.float32)
    # lo halves below half an ulp of their hi halves
    v[1] = (v[0].astype(np.float64) * rng.uniform(-2 ** -25, 2 ** -25, N)
            ).astype(np.float32)
    v[3] = (v[2].astype(np.float64) * rng.uniform(-2 ** -25, 2 ** -25, N)
            ).astype(np.float32)
    return v


def _ds64(h, l):
    return np.asarray(h, np.float64) + np.asarray(l, np.float64)


OPS = {
    'two_sum': (lambda m, v: m.two_sum(v[0], v[2]), 2),
    'quick_two_sum': (lambda m, v: m.quick_two_sum(v[0], v[1]), 2),
    'two_prod': (lambda m, v: m.two_prod(v[0], v[2]), 2),
    'add': (lambda m, v: m.add(v[0], v[1], v[2], v[3]), 4),
    'sub': (lambda m, v: m.sub(v[0], v[1], v[2], v[3]), 4),
    'mul': (lambda m, v: m.mul(v[0], v[1], v[2], v[3]), 4),
    'div_by_f32': (lambda m, v: m.div_by_f32(v[0], v[1], v[2]), 3),
}


@pytest.mark.parametrize('name', sorted(OPS))
def test_ops_bit_equal_to_jax_op_by_op(name):
    fn, _ = OPS[name]
    v = _pairs(1)
    got = fn(ds, [torch.from_numpy(a) for a in v])
    ref = fn(jds, [jnp.asarray(a) for a in v])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize('name', sorted(OPS))
def test_ops_close_to_jitted_jax(name):
    fn, _ = OPS[name]
    v = _pairs(2)
    gh, gl = fn(ds, [torch.from_numpy(a) for a in v])
    rh, rl = jax.jit(lambda *a: fn(jds, a))(*[jnp.asarray(a) for a in v])
    np.testing.assert_array_equal(gh.numpy(), np.asarray(rh))
    got, ref = _ds64(gh.numpy(), gl.numpy()), _ds64(rh, rl)
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -40,
                               atol=np.abs(ref).max() * 2.0 ** -60)


def test_error_free_transformations_exact():
    v = _pairs(3)
    a, b = (torch.from_numpy(x) for x in (v[0], v[2]))
    s, e = ds.two_sum(a, b)
    np.testing.assert_array_equal(_ds64(s.numpy(), e.numpy()),
                                  v[0].astype(np.float64) + v[2])
    p, e = ds.two_prod(a, b)
    np.testing.assert_array_equal(_ds64(p.numpy(), e.numpy()),
                                  v[0].astype(np.float64) * v[2])


def test_add_mul_div_accuracy_vs_float64():
    v = _pairs(4)
    t = [torch.from_numpy(a) for a in v]
    x, y = _ds64(v[0], v[1]), _ds64(v[2], v[3])
    for got, want in ((ds.add(*t), x + y), (ds.mul(*t), x * y),
                      (ds.div_by_f32(t[0], t[1], t[2]), x / v[2])):
        g = _ds64(got[0].numpy(), got[1].numpy())
        np.testing.assert_allclose(g, want, rtol=2.0 ** -43,
                                   atol=np.abs(want).max() * 2.0 ** -60)


@pytest.mark.parametrize('w', [1, 7, 60])
def test_dot_tree_matches_jax_and_float64(w):
    """The pairwise tree (odd element folded into slot 0 first) in JAX's
    order: bit-equal to JAX op by op, within 2^-40 of the float64 dot."""
    rng = np.random.default_rng(w)
    gh = rng.normal(size=(3, 2, w)).astype(np.float32)
    gl = (gh * rng.uniform(-2 ** -25, 2 ** -25, gh.shape)).astype(np.float32)
    wh = rng.normal(size=(5, 1, 1, w)).astype(np.float32)
    wl = np.zeros_like(wh)
    got = ds.dot_tree(*(torch.from_numpy(a) for a in (gh, gl, wh, wl)))
    ref = jds.dot_tree(*(jnp.asarray(a) for a in (gh, gl, wh, wl)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    want = (_ds64(gh, gl)[None] * wh.astype(np.float64)).sum(-1)
    np.testing.assert_allclose(_ds64(got[0].numpy(), got[1].numpy()), want,
                               rtol=2.0 ** -40, atol=2.0 ** -40)
