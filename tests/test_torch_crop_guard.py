"""The valid-signal crop's guard (`train/analysis.py::valid_crop`), on the CPU.

The multiband loss is taken over `RAVE.multiband`'s bands, n_signal / n_band
frames of each channel under every input. The crop is rave_tpu's
(`crop_frames`: the receptive field over n_band * channels under PQMF
input, over the channels alone under mel and raw input), and so is the
guard under PQMF input. Under mel input rave_tpu's guard compares a crop
in samples with n_signal and lets through a crop that leaves the loss no
frame (ROADMAP C12, hybrid's field of 21759 + 21503 samples against 8192
band frames); the port's counts band frames and raises, naming C12:

  * `compose(["hybrid"])` at its receptive field raises, through the
    function and through `cli train` (a tiny hybrid on a tiny store, its
    field measured by the probe);
  * wherever rave_tpu's guard raises, the port's does, and wherever both
    pass, the crop is rave_tpu's, for PQMF input (mono, stereo) and mel.
"""
import io
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from rave_tpu_torch import cli
from rave_tpu_torch.config import compose
from rave_tpu_torch.train.analysis import crop_dim, crop_frames, valid_crop

HYBRID_RF = (21759, 21503)  # compose(["hybrid"])'s receptive field (ROADMAP C12)
SR, N_SIGNAL = 22050, 16384
TINY_HYBRID = ["sampling_rate=22050", "capacity=2", "discriminator.capacity=2",
               "latent_size=4", "n_mels=16", "mel_n_fft=512", "mel_hop=128",
               "encoder.ratios=[4]", "ratios=[4,4,2]", "dilations=[[1],[1],[1]]",
               "distance.scales=[512,256]"]


def rave_tpu_guard_passes(cfg, rf, n_signal, channels) -> bool:
    """rave_tpu/train/loop.py:165-175's test, as it stands."""
    crop = crop_frames(cfg, rf, channels)
    return crop[0] + crop[1] < n_signal * channels // crop_dim(cfg, channels)


def test_hybrid_crop_raises_naming_c12():
    cfg = compose(["hybrid"])
    assert cfg.input_mode == "mel" and cfg.train.valid_signal_crop
    assert rave_tpu_guard_passes(cfg, HYBRID_RF, cfg.data.n_signal, 1)  # the fault
    with pytest.raises(ValueError, match="C12"):
        valid_crop(cfg, HYBRID_RF, cfg.data.n_signal)


@pytest.mark.parametrize("names,channels", [(["v2"], 1), (["v2"], 2), (["v2_small"], 1),
                                            (["hybrid"], 1), (["hybrid"], 2)])
def test_agrees_with_rave_tpu_where_it_can(names, channels):
    """Over a grid of fields and clip lengths: under PQMF input the port's
    guard is rave_tpu's; under mel input it raises wherever rave_tpu's does,
    and past that only where the crop leaves no band frame. Where it passes,
    the crop is rave_tpu's."""
    cfg = compose(names)
    for n_signal in (4096, 16384, 65536, 131072):
        for rf in ((0, 0), (511, 767), (4095, 2047), (20000, 20000), (21759, 21503),
                   (70000, 70000)):
            theirs = rave_tpu_guard_passes(cfg, rf, n_signal, channels)
            band_frames = n_signal // cfg.n_band
            crop = crop_frames(cfg, rf, channels)
            ours = crop[0] + crop[1] < band_frames
            if cfg.input_mode == "pqmf":
                assert ours == theirs, (n_signal, rf)
            else:
                assert ours <= theirs, (n_signal, rf)
            if ours:
                assert valid_crop(cfg, rf, n_signal, channels) == crop
            else:
                with pytest.raises(ValueError, match="no valid signal") as raised:
                    valid_crop(cfg, rf, n_signal, channels)
                assert ("C12" in str(raised.value)) == (cfg.input_mode != "pqmf")


def test_cli_train_hybrid_with_the_crop_raises(tmp_path):
    """`cli train --config hybrid` with the crop on: the probe measures the
    tiny hybrid's field (6014 samples, under n_signal: rave_tpu would train
    on a NaN loss), which leaves none of the 1024 band frames."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        (tmp_path / "corpus").mkdir()
        t = np.arange(52 * N_SIGNAL) / SR
        x = 0.3 * np.sin(2 * np.pi * 220 * t)
        wavfile.write(tmp_path / "corpus" / "a.wav", SR, (x * 32767).astype(np.int16))
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            assert cli.main(["preprocess", "--input_path", str(tmp_path / "corpus"),
                             "--output_path", str(tmp_path / "db"), "--num_signal",
                             str(N_SIGNAL), "--sampling_rate", str(SR), "--workers", "1"]) == 0
            args = ["train", "--device", "cpu", "--config", "hybrid", "--name", "c12",
                    "--db_path", str(tmp_path / "db"), "--out_path", str(tmp_path / "runs"),
                    "--batch", "2", "--n_signal", str(N_SIGNAL), "--workers", "1",
                    "--max_steps", "1", "--no_progress"]
            for o in TINY_HYBRID:
                args += ["--override", o]
            with pytest.raises(ValueError, match="C12"):
                cli.main(args)
    finally:
        torch.set_num_threads(n)
