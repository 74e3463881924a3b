"""The benchmark of the PyTorch/CUDA port `bppp_tpu_torch` (see run.py)."""
