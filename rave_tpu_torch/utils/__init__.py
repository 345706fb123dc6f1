"""The weight bridge from the JAX package's parameter trees, checkpoints and
run discovery, metrics logging, and per-step random seeds."""
