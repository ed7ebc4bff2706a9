"""The port's twin of __graft_entry__.py (ysmr_tpu_torch/graft_entry.py) on
the CPU: ``entry(device='cpu')``'s step on the example frames against
``__graft_entry__.entry()``'s jitted step (mask and ids equal, positions
within 2e-4 px, the frames-mode GSFF residue of
tests/test_torch_track_bacteria.py::test_frames_mode_rows_match_jax), and
``dryrun_multichip(4, device='cpu')`` on a 4-entry CPU mesh, its
pipeline leg (``track_bacteria`` through the dense-assignment gate,
``track_videos_sharded`` on two clips) included; both default to ``cuda``
and raise without a GPU."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from ysmr_tpu_torch import graft_entry

torch.set_num_threads(1)


def test_entry_matches_jax_entry():
    jfn, (jframes, jstate) = __graft_entry__.entry()
    _, ref = jax.jit(jfn)(jframes, jstate)
    fn, (frames, state) = graft_entry.entry(device='cpu')
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    new_state, got = fn(frames, state)
    assert got['mask'].shape == tuple(np.shape(ref['mask']))
    assert int(got['mask'].sum()) > 100
    for key in ('mask', 'ids', 'det_col', 'n_det'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got['pos'].numpy(), np.asarray(ref['pos']),
                               rtol=0, atol=2e-4)
    assert int(new_state['next_id']) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            graft_entry.entry()


def test_dryrun_multichip_on_a_cpu_mesh():
    rows = graft_entry.dryrun_multichip(4, device='cpu')
    # the pipeline leg: track_videos_sharded wrote rows for both clips
    assert sorted(rows) == ['a.avi', 'b.avi'] and all(rows.values()), rows
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            graft_entry.dryrun_multichip(4)


def test_dryrun_pipeline_leg_on_a_two_entry_cpu_mesh():
    """The pipeline leg alone: track_bacteria through the dense-assignment
    gate (shut: the CPU counts one device) and track_videos_sharded with
    the two clips split over a 2-entry mesh, rows for both."""
    from ysmr_tpu_torch.parallel import sharding as shd
    rows = graft_entry._dryrun_pipeline_entries(
        shd.make_mesh(2, device='cpu'), 'cpu')
    assert sorted(rows) == ['a.avi', 'b.avi'] and all(rows.values()), rows
