"""ysmr_tpu_torch — the PyTorch and CUDA port of ysmr_tpu.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and never ``jax`` or ``ysmr_tpu``. The public API is the JAX
package's: ``ysmr`` and ``analyse`` (stages 1-4, ``python -m
ysmr_tpu_torch``), the pipeline stages and the plot functions; the entry
points that pick a device take ``device='cuda'`` (raising without a GPU)
or ``device='cpu'``. Stage 1, ``track_bacteria``, runs in both transfer
modes, on each wire (run-length or pixels), with or without luminosity, on
the host-rect and the device-rect paths; every Pallas kernel of ysmr_tpu
has a hand-written CUDA counterpart under ``csrc/``. matplotlib is
imported only when a plot is drawn. See ROADMAP.md for what is still to
port.
"""

from ysmr_tpu_torch.__version__ import VERSION, __version__  # noqa: F401
from ysmr_tpu_torch.main import analyse, ysmr  # noqa: F401
from ysmr_tpu_torch.pipeline.annotate import annotate_video  # noqa: F401
from ysmr_tpu_torch.pipeline.evaluate import evaluate_tracks  # noqa: F401
from ysmr_tpu_torch.pipeline.select import select_tracks  # noqa: F401
from ysmr_tpu_torch.pipeline.track_bacteria import track_bacteria  # noqa: F401
from ysmr_tpu_torch.plot_functions import (angle_distribution_plot,  # noqa: F401
                                           large_xy_plot, rose_graph,
                                           violin_plot)

__all__ = ['ysmr', 'analyse', 'track_bacteria', 'select_tracks',
           'evaluate_tracks', 'annotate_video', 'angle_distribution_plot',
           'large_xy_plot', 'rose_graph', 'violin_plot', 'VERSION',
           '__version__']
