"""Version of ysmr_tpu_torch, the PyTorch and CUDA port of ysmr_tpu."""

VERSION = (0, 1, 0)

__version__ = '.'.join(map(str, VERSION))
