"""The v2 training step, in its three programs.

PyTorch port of rave_tpu/train/steps.py (reference rave/model.py:288-424):

  * gen, pre-warmup  : reconstruction and regularization only;
  * gen, adversarial : plus feature matching and the adversarial term, the
                       encoder frozen (run without a graph);
  * dis              : the critic's loss, the generator run without a graph.

`pick_phase` chooses the program per global step, as in the JAX package.
A step is its device program between host work, as the JAX step is one
compiled program over donated state: the host fills the schedules' values
at the global step (the generator's learning rate, the regularization's
beta) into `state.schedule`'s 0-d tensors, the program reads them there
and updates the model, the critic, both Adams and the EMA in place (the
gradients zeroed in place, so they keep their addresses), and the host
advances the global step. `train/graphs.py::TrainGraphs` serves the
programs as CUDA graphs; the steps here run them eagerly.
Layouts are the port's: waveforms [B, C, T], band frames [B, C*M, T/M].
What the JAX package draws from its "noise" rng (the variational eps, the
wasserstein reference sample, the augmentation noise, the codebooks'
sample rows, the noise synth's uniforms) comes from `draws` (`draw_noise`'s result) or else from
`generator`, so a test can hand both packages the same numbers. It is drawn
before the autoencode pass, so that `train.remat`'s recompute sees the same
noise: `torch.utils.checkpoint` restores the global generators, not an
explicit one.

The discrete family's codebooks train in all three programs, the critic's
and the warmed generator's too (the JAX critic step runs `_autoencode` with
`train=True` and keeps the new codebooks, :250-270). Their training call
returns the new state, and the step assigns it after its backward, so the
remat recompute sees the codebooks and picks the codes the forward did.

The precision options are the JAX package's casts, written out (not
`torch.autocast`, whose op lists would compute something else):
`train.bf16` runs the model in bfloat16 with fp32 latents, outputs and loss
targets (`autoencode`); `train.bf16_dis` runs the critic on a bfloat16
input and upcasts its features at the loss. The weights stay fp32 masters,
cast per op by the modules, so their gradients and the Adams are fp32.
`train.remat` recomputes the generator step's autoencode pass in the
backward, as `jax.checkpoint` does (rave_tpu/train/steps.py:212-213).

Under data parallelism (a process group of W ranks, parallel/mesh.py) a
step computes what the JAX step computes over the global batch of W*B
rows: it runs inside `mesh.sharded_batch()`, where the ops that couple
rows reduce over every rank and `draw_noise` draws at the global shape
and keeps the rank's rows; the gradients are averaged over the ranks
before both optimizers, and the returned metrics are the global batch's.

The steps put the model in training mode (`model.train()`, the JAX
package's `train=True` model): AdaIN is the identity there, and v1's
BatchNorm normalizes by the batch and folds its statistics into the
running averages, in all three programs (the JAX steps make every
non-`params` collection mutable, :45), the critic's and the frozen
encoder's passes too; `train.remat`'s recompute folds nothing in again.
GeneratorV1 adds its noise branch only once warmed up (the branch's
parameters then get a zero gradient before, as JAX's). Validation, eval
and export run the model in eval mode.

Kept exactly as in the JAX package: the feature-matching weight is applied
twice (once into the term, once in the weighted sum: the reference does);
the first `num_skipped_features` feature maps of each critic are left out
of feature matching; with `valid_signal_crop` only the band frames are
cropped; real and fake go through the critic in one batch and are split
back in halves; critic steps skip the reconstruction distances unless
`train.dis_full_metrics`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from rave_tpu_torch.config import RaveConfig
from rave_tpu_torch.factory import build_audio_distance, build_gan_loss
from rave_tpu_torch.models.blocks import BatchNorm1d, LatentDraws
from rave_tpu_torch.ops.dsp import mean_difference
from rave_tpu_torch.parallel import mesh
from rave_tpu_torch.train.schedules import (
    beta_factor, gen_lr_schedule, quantize_enabled, warmed_up,
)
from rave_tpu_torch.train.state import TrainState, update_ema


def autoencode(model, x: torch.Tensor, draws: LatentDraws, warmed: bool, bf16: bool = False,
               quantize: bool = True) -> Dict[str, torch.Tensor]:
    """The full pass of a step (rave_tpu/train/steps.py:36-87), with the
    latent family's training call on its `draws`: the discrete RVQ runs
    when `quantize`, returning its codebooks' new state as "updates" (None
    for the other families) without writing it; the noise synth filters
    `draws.uniform`. The multiband loss's pair: the decoder's band frames,
    or under raw output PQMF analysis of its waveform; the encoder's band
    frames, or under another input (or `bf16`) PQMF analysis of x. With
    `bf16`, the casts of the JAX package's `_autoencode` (:48-77): the
    encoder and decoder in bfloat16, the latent and the reparametrization
    (the RVQ too) in fp32, the decoder's output back to fp32 before
    synthesis, and the multiband loss target analysed from the fp32
    waveform."""
    x_enc = model.transform_input(x.to(torch.bfloat16) if bf16 else x)
    z = model.encoder(x_enc, warmed_up=warmed)
    zs, reg, updates = model.encoder.reparametrize(z.float() if bf16 else z, draws,
                                                   quantize=quantize, train=True)
    y_mb = model.decode_multiband(zs.to(torch.bfloat16) if bf16 else zs, draws.uniform, warmed)
    if bf16:
        y_mb = y_mb.float()
    y_raw = model.synthesize(y_mb)[..., : x.shape[-1]]
    y_bands = y_mb if model.output_mode == "pqmf" else model.multiband(y_raw)
    x_bands = x_enc if model.input_mode == "pqmf" and not bf16 else model.multiband(x)
    return {"x_bands": x_bands, "y_bands": y_bands[..., : x_bands.shape[-1]], "y_raw": y_raw,
            "reg": reg, "updates": updates}


@contextlib.contextmanager
def frozen_batch_stats(model):
    """`model`'s BatchNorm1d layers fold nothing into their running
    statistics inside the block."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm1d)]
    for m in norms:
        m.frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.frozen = False


def draw_noise(cfg: RaveConfig, x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> LatentDraws:
    """What the model draws for a pass over waveform `x` [B, C, T], from
    `generator` in this order: eps, noise, init_idx, expire_idx, uniform
    (`LatentDraws`; normals and uniforms in x's dtype, latents [B,
    latent_size, T / decimation]; the noise synth's uniforms last, so the
    other draws are those of a model without it). The discrete sample rows
    are drawn on every call, as the JAX package draws them on every
    training call, whether or not a code expires. Under
    `mesh.sharded_batch()` x is this rank's rows of the global batch: the
    draws are made at the global batch and the rank keeps its rows (the
    sample rows index the global batch's vectors)."""
    lat = cfg.latent
    B, T = x.shape[0] * mesh.batch_shards(), x.shape[-1] // cfg.decimation()

    def normal(channels):
        return mesh.rank_rows(torch.randn((B, channels, T), generator=generator,
                                          device=x.device, dtype=x.dtype))

    def rows():
        return torch.randint(0, B * T, (lat.num_quantizers, lat.codebook_size),
                             generator=generator, device=x.device)

    draws = LatentDraws()
    if lat.family in ("variational", "wasserstein"):
        draws.eps = normal(cfg.latent_size)
    if lat.family in ("wasserstein", "discrete") and lat.noise_augmentation:
        draws.noise = normal(lat.noise_augmentation)
    if lat.family == "discrete":
        draws.init_idx, draws.expire_idx = rows(), rows()
    shape = cfg.noise_shape(x.shape[1], B, T)
    if shape is not None:
        draws.uniform = mesh.rank_rows(torch.rand(shape, generator=generator, device=x.device,
                                                  dtype=x.dtype))
    return draws


def crop(arr: torch.Tensor, frames: Tuple[int, int]) -> torch.Tensor:
    """Drop `frames` = (left, right) frames of the time axis."""
    left, right = frames
    return arr[..., left : arr.shape[-1] - right]


def split_features(features: List[List[torch.Tensor]]):
    """Real/fake halves of the critic's features over the batch axis."""
    real = [[f.chunk(2, dim=0)[0] for f in scale] for scale in features]
    fake = [[f.chunk(2, dim=0)[1] for f in scale] for scale in features]
    return real, fake


class TrainSteps(dict):
    """{'gen': gen_step, 'dis': dis_step}, the eager steps. A step is its
    device program between host work, both in `run(which, state, x, warmed,
    draws, generator, quantize, execute)`: the draws (`draw_noise` where none
    are given), the schedules' values filled into `state.schedule` from the
    global step, the program, the global step advanced. `programs[which]
    (state, x, draws, warmed, quantize)` is the device program alone: it
    reads its inputs, the schedule's tensors and the state, and writes the
    state in place. `run` calls it directly, or through `execute(which,
    program, state, x, draws, warmed, quantize)` where given: `TrainGraphs`
    (train/graphs.py) serves it so as a CUDA graph."""

    def __init__(self, cfg: RaveConfig, programs: dict, run):
        super().__init__(gen=self.gen, dis=self.dis)
        self.cfg, self.programs, self.run = cfg, programs, run

    def gen(self, state: TrainState, x: torch.Tensor, warmed: bool,
            draws: Optional[LatentDraws] = None, generator: Optional[torch.Generator] = None,
            quantize: bool = True) -> dict:
        return self.run("gen", state, x, warmed, draws, generator, quantize)

    def dis(self, state: TrainState, x: torch.Tensor, draws: Optional[LatentDraws] = None,
            generator: Optional[torch.Generator] = None, quantize: bool = True) -> dict:
        return self.run("dis", state, x, True, draws, generator, quantize)


def build_train_steps(cfg: RaveConfig, crop_frames: Tuple[int, int] = (0, 0)) -> TrainSteps:
    """{'gen': gen_step, 'dis': dis_step} (a `TrainSteps`); each updates a
    `TrainState` in place, advances its global step and returns the step's
    metrics. Mel input (`hybrid`, `v2_with_augs`) with `train.bf16` raises
    ValueError: the JAX package's step takes the mel front-end's rfft of
    bfloat16 frames, which its `jnp.fft.rfft` refuses
    (rave_tpu/models/rave.py:60-61), so that step has no reference result
    (ROADMAP C14)."""
    if cfg.train.bf16 and cfg.input_mode == "mel":
        raise ValueError("train.bf16 with mel input (input_mode 'mel') is not a step of the "
                         "reference: rave_tpu's mel front-end takes jnp.fft.rfft of bfloat16 "
                         "frames, which raises (ROADMAP C14); train it in float32")
    distance = build_audio_distance(cfg)
    gan_loss = build_gan_loss(cfg)
    t = cfg.train
    weights = dict(t.weights)
    gen_lr = gen_lr_schedule(t.gen_lr, t.lr_end_factor, t.phase_1_duration)
    band_crop = crop_frames if t.valid_signal_crop else (0, 0)

    def set_schedule(state: TrainState) -> None:
        """The schedules at `state.step` into `state.schedule` (host work)."""
        state.schedule.fill(gen_lr(state.step),
                            beta_factor(state.step, t.beta_initial, t.beta_target,
                                        t.beta_warmup_len, t.beta_log_warmup))

    def losses_and_metrics(out, critic, x, warmed: bool, beta: torch.Tensor,
                           gen_metrics: bool = True):
        metrics: Dict[str, object] = {}
        loss_gen: Dict[str, torch.Tensor] = {}
        if gen_metrics:
            mb = distance(crop(out["x_bands"], band_crop), crop(out["y_bands"], band_crop))
            for k, v in mb.items():
                loss_gen[f"multiband_{k}"] = weights.get("multiband_audio_distance", 1.0) * v
            for k, v in distance(x, out["y_raw"]).items():
                loss_gen[f"fullband_{k}"] = weights.get("audio_distance", 1.0) * v
            loss_gen["regularization"] = out["reg"] * beta
            metrics["beta_factor"] = beta.clone()
            metrics["regularization_raw"] = out["reg"]

        loss_dis = x.new_zeros(())
        if warmed:
            xy = torch.cat([x, out["y_raw"]], dim=0)
            if t.bf16_dis:  # the critic in bf16, its features back to fp32 at the loss
                features = [[f.float() for f in scale] for scale in critic(xy.to(torch.bfloat16))]
            else:
                features = critic(xy)
            real, fake = split_features(features)
            fm_total = adv_total = dis_total = pred_real = pred_fake = 0.0
            for sr, sf in zip(real, fake):
                pairs = list(zip(sr[t.num_skipped_features:], sf[t.num_skipped_features:]))
                fm = sum(mean_difference(a, b, norm="L1", relative=t.feature_matching_relative)
                         for a, b in pairs) / max(len(pairs), 1)
                fm_total = fm_total + fm
                d, a = gan_loss(sr[-1], sf[-1])
                dis_total = dis_total + d
                adv_total = adv_total + a
                pred_real = pred_real + sr[-1].mean()
                pred_fake = pred_fake + sf[-1].mean()
            fm_total = fm_total / len(real)
            loss_gen["feature_matching"] = weights.get("feature_matching", 20.0) * fm_total
            loss_gen["adversarial"] = weights.get("adversarial", 1.0) * adv_total
            loss_dis = dis_total
            metrics["pred_real"] = pred_real
            metrics["pred_fake"] = pred_fake

        total_gen = 0.0
        for k, v in loss_gen.items():
            total_gen = total_gen + v * weights.get(k, 1.0)
            metrics[k] = v
        if gen_metrics:
            metrics["loss_gen"] = total_gen
        metrics["loss_dis"] = loss_dis
        return total_gen, loss_dis, metrics

    def detached(metrics):
        return {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}

    def gen_program(state, x, draws, warmed, quantize):
        state.model.train()
        params = list(state.model.parameters())
        state.gen_opt.zero_grad(set_to_none=False)  # in place: the gradients keep their addresses
        if t.remat:  # the recompute folds no batch statistics in a second time
            out = checkpoint(autoencode, state.model, x, draws, warmed, t.bf16, quantize,
                             use_reentrant=False, preserve_rng_state=False,
                             context_fn=lambda: (contextlib.nullcontext(),
                                                 frozen_batch_stats(state.model)))
        else:
            out = autoencode(state.model, x, draws, warmed, t.bf16, quantize)
        total, _, metrics = losses_and_metrics(out, state.discriminator, x, warmed,
                                               state.schedule.beta)
        total.backward(inputs=params)  # the generator's gradients only, not the critic's
        for p in params:
            if p.grad is None:  # the frozen encoder: a zero gradient, as JAX's is
                p.grad = torch.zeros_like(p)
        mesh.average_gradients(params)
        for group in state.gen_opt.param_groups:
            group["lr"] = state.schedule.gen_lr
        state.gen_opt.step()
        if out["updates"] is not None:  # the codebooks, once, after the backward
            state.model.encoder.commit(out["updates"])
        metrics["gen_lr"] = state.schedule.gen_lr.clone()
        if state.ema is not None:
            update_ema(state.ema, state.model, t.ema)
        return mesh.mean_over_ranks(detached(metrics))

    def dis_program(state, x, draws, warmed, quantize):
        state.model.train()
        with torch.no_grad():  # the codebooks still train, as in the JAX critic step
            out = autoencode(state.model, x, draws, True, t.bf16, quantize)
        state.dis_opt.zero_grad(set_to_none=False)
        _, loss_dis, metrics = losses_and_metrics(out, state.discriminator, x, True,
                                                  state.schedule.beta,
                                                  gen_metrics=t.dis_full_metrics)
        loss_dis.backward()
        mesh.average_gradients(state.discriminator.parameters())
        state.dis_opt.step()
        if out["updates"] is not None:
            state.model.encoder.commit(out["updates"])
        return mesh.mean_over_ranks(detached(metrics))

    programs = {"gen": gen_program, "dis": dis_program}

    def run(which: str, state: TrainState, x: torch.Tensor, warmed: bool,
            draws: Optional[LatentDraws] = None, generator: Optional[torch.Generator] = None,
            quantize: bool = True, execute=None) -> dict:
        with mesh.sharded_batch():
            if draws is None:
                draws = draw_noise(cfg, x, generator)
            set_schedule(state)
            if execute is None:
                metrics = programs[which](state, x, draws, warmed, quantize)
            else:
                metrics = execute(which, programs[which], state, x, draws, warmed, quantize)
        state.step += 1
        return metrics

    return TrainSteps(cfg, programs, run)


def pick_phase(cfg: RaveConfig, step: int) -> Tuple[str, bool, bool]:
    """(which, warmed, quantize) for this global step: after the warmup every
    `update_discriminator_every`-th step trains the critic."""
    w = warmed_up(step, cfg.train.phase_1_duration)
    q = quantize_enabled(step, cfg.train.warmup_quantize)
    if w and step % cfg.train.update_discriminator_every == 0:
        return "dis", w, q
    return "gen", w, q
