"""Dual-mode (offline / streaming) convolution runtime with static delay algebra."""
