"""The training data path: the ARS store and its metadata, decode and
preprocess, the numpy transforms, datasets and the split, the threaded host
loader, and the device-resident pipeline (PyTorch port of rave_tpu/data/)."""
