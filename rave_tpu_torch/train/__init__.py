"""The v2 training step: schedules, train state, the three step programs
and the receptive-field probe (PyTorch port of rave_tpu/train/)."""
