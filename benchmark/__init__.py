"""The benchmark of unboundednerfpytorch_tpu_torch on one H100: see run.py."""
