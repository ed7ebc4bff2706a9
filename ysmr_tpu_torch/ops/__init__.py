"""Ops: run-graph connected components (PyTorch + CUDA) and host helpers."""
