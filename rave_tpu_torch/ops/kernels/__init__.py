"""Hand-written CUDA kernels (sources in rave_tpu_torch/csrc), their plain twins and build."""
