"""Hand-written CUDA kernels for Hopper (sources in ``../../csrc/``), their
wrappers, launch counters and plain PyTorch versions. Nothing is compiled
when these modules are imported: a kernel is built at its first launch."""
