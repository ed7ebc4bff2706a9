"""Host utilities: files, logging, CSV and xlsx writers (copies of ysmr_tpu.utils)."""
