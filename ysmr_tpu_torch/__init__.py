"""ysmr_tpu_torch — the PyTorch and CUDA port of ysmr_tpu.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and never ``jax`` or ``ysmr_tpu``. The ported slice is stage 1 in
its default configuration: host decode and threshold, the run-length wire,
run-graph connected components on the GPU (hand-written CUDA kernel
``csrc/run_prop.cu``), cv2-exact rects and the float64 tracker on the host,
and ``_list.csv``. See ROADMAP.md for what is still to port.
"""

from ysmr_tpu_torch.__version__ import VERSION, __version__  # noqa: F401
from ysmr_tpu_torch.pipeline.track_bacteria import track_bacteria  # noqa: F401

__all__ = ['track_bacteria', 'VERSION', '__version__']
