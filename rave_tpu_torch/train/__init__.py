"""Training: schedules, train state, the three step programs, the
receptive-field probe and PCA, the training loop (`loop.train`) and evaluation
(PyTorch port of rave_tpu/train/)."""
