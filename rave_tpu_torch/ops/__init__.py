"""PQMF filter design and analysis/synthesis, and the hand-written kernels."""
