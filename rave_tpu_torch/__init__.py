"""rave_tpu_torch — the PyTorch/CUDA port of rave_tpu.

The port works in PyTorch's channels-first layout: waveforms are
`[B, n_channels, T]` and latents `[B, D, T_lat]`. The JAX package
(`rave_tpu`, channels-last) is the numerical reference it is tested
against; this package imports nothing of it, and never jax or flax. The entry
points build on the GPU unless the caller passes `device="cpu"`.

  - rave_tpu_torch.config  : the configuration (model, critic, distance,
                             train and data fields) and its presets: v2,
                             v3, causal, the latent families, and the v2
                             variants (noise synth, raw output, mel input)
  - rave_tpu_torch.ops     : PQMF filter design and analysis/synthesis; the
                             kaiser resampler; the noise synth's DSP;
                             STFT, the v1 audio distance, GAN losses; the
                             fused dilated residual unit kernel, fp32 and
                             bf16 (and its autograd.Function)
  - rave_tpu_torch.nn      : dual-mode (offline / streaming) convolutions
                             with static delay algebra, the GRU
  - rave_tpu_torch.models  : v2 encoder/generator blocks (the noise synth),
                             PQMF modules, the mel front-end, RAVE;
                             the multi-period and multi-scale critics
  - rave_tpu_torch.factory : build_rave, build_discriminator,
                             build_audio_distance, build_gan_loss
  - rave_tpu_torch.train   : schedules, train state (two Adams, EMA), the
                             three step programs (with train.bf16,
                             bf16_dis and remat), the receptive-field probe
                             and PCA, the training driver (loop.train) and
                             evaluation
  - rave_tpu_torch.data    : the ARS store, preprocess, transforms,
                             datasets (the HTTP one and its server), the
                             threaded host loader, the C++ sampler and
                             its loader, and the device-resident pipeline
  - rave_tpu_torch.parallel: data parallelism over torchrun's processes
                             (the process group, the global batch's
                             collectives) and the multi-process worker
  - rave_tpu_torch.export  : the `.rtpu` artifact (manifest, weights,
                             `torch.export` step programs), ExportedRAVE,
                             export_model and generate
  - rave_tpu_torch.utils   : weight bridge from rave_tpu parameter trees,
                             checkpoints, metrics logging, per-step seeds
                             and normal and uniform draws from a seed tensor
  - rave_tpu_torch.cli     : `python -m rave_tpu_torch.cli preprocess |
                             train | train_prior | import_torch | eval |
                             export | generate | export_onnx |
                             remote_dataset`
"""
from rave_tpu_torch.version import __version__

__all__ = ["__version__"]
