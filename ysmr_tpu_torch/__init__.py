"""ysmr_tpu_torch — the PyTorch and CUDA port of ysmr_tpu.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and never ``jax`` or ``ysmr_tpu``. The ported slice is stage 1,
``track_bacteria``, in both transfer modes, on each wire (run-length or
pixels), with or without luminosity, on the host-rect and the device-rect
paths; every Pallas kernel of ysmr_tpu has a hand-written CUDA counterpart
under ``csrc/``. See ROADMAP.md for what is still to port.
"""

from ysmr_tpu_torch.__version__ import VERSION, __version__  # noqa: F401
from ysmr_tpu_torch.pipeline.track_bacteria import track_bacteria  # noqa: F401

__all__ = ['track_bacteria', 'VERSION', '__version__']
