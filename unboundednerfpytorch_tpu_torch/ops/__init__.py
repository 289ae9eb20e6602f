"""Compute ops: counterparts of ``unboundednerfpytorch_tpu/ops`` in PyTorch,
with the TPU kernels of ``ops/pallas`` ported to CUDA under ``ops/cuda``."""
