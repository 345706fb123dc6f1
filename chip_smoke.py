#!/usr/bin/env python3
"""Drive rave_tpu_torch's serving paths and training steps once on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, `nvcc` and no
jax. Phases, each printing one line (any failure raises and exits non-zero):

  1. device  : the card, from `nvidia-smi` (name, power limit);
  2. build   : csrc/dilated_unit.cu compiled by nvcc for sm_90a;
  3. kernel  : the fused dilated unit against its plain PyTorch version at
               every (C, T, d, pad) of the v2 forward at B=16 x 131072
               samples, fp32 with TF32 off, and at each C a ragged length
               (T - 21: no whole 128-frame tile, padded for TMA's 16-byte
               rows) and B=1 (a grid that fills few SMs), and the centered
               shapes at B=2 (phase 11's validation and eval batches); then
               the unit shapes of phase 21's forwards that v2's do not
               cover (`variant_unit_cases`: C = 48, 64, 128, 256, 512, whose
               output passes and, in bf16, input chunks are partial, up to
               C=64 at T=131072), centered at B=16, with a ragged length and
               B=1 at each new C; max relative error <= 1e-4; both times by
               CUDA events;
  4. kernel_bf16 : the bf16 variant at the 22 unit shapes of a B=8 step
               (centered and causal), the 11 centered ones at B=16, the
               ragged and B=1 shapes of phase 3, and the variants' shapes of
               phase 3 at B=8; the referee is the plain
               version in fp32 on the same bf16 inputs and weights: the
               kernel may be no further from it than 1.1x the plain bf16
               version, and within 1e-2 of the plain bf16;
               (kernel and plain times are device times: `cuda_ms`);
  5. offline : compose(["v2"]) at full width with seeded random weights:
               (a) B=16 x 131072 samples, finite, the right shape, exactly
               22 kernel launches per forward, and the realtime factor;
               (b) B=1 x 65536, GPU (kernel) against CPU (plain) <= 1e-3;
  6. stream  : (run after phase 20) compose(["v2","causal"]), 32 blocks of
               block_size() through step_encode -> step_decode against the
               causal offline encode/decode of the same signal (delay 0) <=
               1e-3, and the eager p50 time per block; then the same pair
               served by `graphed_stream` (a CUDA graph per block shape)
               beside an eager twin (a copy of the model, its steps called
               directly) over 32 blocks with `init_stream_state` halfway
               (`model_lockstep`): outputs and stream buffers bit-equal, the
               served p50 under the block's budget;
  7. grad    : the wrapper raises on float64, on mixed fp32/bf16, on C % 8
               in fp32 and C % 16 in bf16, and on a halo wider than a TMA
               box, with autograd recording or not;
               the gradient's kernel (`dilated_unit_backward`: dx, dw1,
               dw2) against its plain closed form at every (C, T, d) of
               UNIT_SHAPES and VARIANT_UNITS, centered and causal, at B=8
               and B=1, and a ragged T per width (`grad_cases`), taken at
               the kernel's side of leaky'(h)'s kink (`backward_row`): fp32
               each within 1e-4 of its max, the kernel's h too; bf16 by the
               rule of phase 4 against the plain fp32 closed form; two calls
               bit-equal at every shape; at the centered v2 and variant
               shapes at B=8 the Function's gradients bit-equal to the
               kernel's, its y within the forward's rules, device ms of
               fwd+bwd (Function and plain autograd) and of the backward
               alone (kernel and plain); at the 11 v2 shapes the device
               kernels of one call (torch.profiler: exactly 5) and the
               weight gradients' kernel's ms beside cuDNN's weight
               gradients of the same two convolutions and their bound;
  8. train   : compose(["v2"]) at full width, B = data.batch = 8 x
               data.n_signal = 131072, fp32: the receptive field (and the
               valid-signal crop) from the port's probe, then pre-warmup
               generator steps, and adversarial generator and critic steps
               picked by pick_phase past phase_1_duration; exactly 22
               kernel launches per step and 22 / 11 / 0 of the gradient's
               kernel in a pre-warmup / adversarial / critic step (the
               encoder runs frozen past the warmup, the critic step's
               generator pass without a graph), finite losses, the params of what
               trains moved, the global step; mean ms per step per phase
               after one warm step, and peak memory. Then the same seeded
               weights at B=1 x 131072, one pre-warmup generator step and
               one critic step on the GPU (kernel) and on the CPU (plain):
               losses within 1e-4; gradients against a float64 CPU run no
               further than max(1e-3, twice the CPU float32 run's own
               distance from it) (v2's log-spectral loss leaves float32
               gradients ~3% from float64 on any device: PERF.md);
  9. train_bf16 : the same with train.bf16 and train.bf16_dis (the CLI's
               `--bf16`): 22 bf16 launches and no fp32 launch per step. Then
               at B=1 x 131072 from the same weights, bf16 against fp32 on
               the card for a pre-warmup generator step (at v2's
               log_epsilon and at 1e-3) and a critic step: losses within 5%,
               the global relative L2 distance of the gradients under the
               bounds of GRAD_BF16_BOUND (their reasons are in PERF.md);
               then v2_small and v2_nopqmf at full width with the same flags
               (`VARIANT_BF16`, without the valid-signal crop): 2 pre-warmup
               and 2 of each warmed program, their 22 bf16 launches per step,
               ms and peak, and at B=1 the pre-warmup step (log_epsilon 1e-3)
               and the critic step bf16 against fp32 under the same bounds;
               hybrid (mel input) with train.bf16 refused, as rave_tpu cannot
               take that step (ROADMAP C14);
 10. remat   : one fp32 pre-warmup step at B=8 x 131072 with and without
               train.remat from the same state and noise, cuDNN
               deterministic, after one warm step: losses equal to 1e-6,
               gradients to 1e-5 (global relative L2), 44 launches (forward
               and recompute) against 22, 22 of the gradient's kernel each,
               a lower peak memory, and the step again without remat from
               the same state bit-equal to the first;
 10b. train_graph : v2's three training programs as CUDA graphs
               (train/graphs.py::TrainGraphs) against the eager steps, in
               fp32, under train.bf16 + bf16_dis and under train.remat, at
               B=8 x 131072 under cuDNN's deterministic algorithms
               (`graph_lockstep`): phase 8's schedule (5 pre-warmup steps,
               then 4 cycles of the critic's period) twice from seed 0, the
               eager steps and the graphed ones, each step on the same draws;
               every step's metrics, and after the runs every parameter,
               gradient, buffer, Adam moment, step count and learning rate
               and EMA tensor bit-equal; each program warmed up by one
               eager step (which makes its gradients and Adam states),
               captured at the next (the wrappers count the launches that a
               warm-up or a capture makes: those of the eager twin, 22
               forward and 22 / 11 / 0 of the gradient's kernel, 44 forward
               in a remat pre-warmup step) and replayed at later steps (no
               Python runs, the wrappers count none); then one more replay
               of each program profiled by torch.profiler, whose unit
               launches counted in the card's trace (a weight preparation
               per forward call, a `wgrad_wgmma_kernel` per gradient call)
               must be the eager step's; the graphed pre-warmup step's wall
               (its replays) under the eager one in fp32 and bf16. Printed:
               every program's eager and graphed walls, one more step of
               each program timed and profiled in fp32 and bf16 (device
               busy and its share of the wall; the eager trace's launches
               held to the wrappers' count), the peak memory of each run.
               Phases 20 and 15 at their ends, and 14, 21 (hybrid) and 22
               in their steps, run their family's programs through
               `TrainGraphs` the same way (`family_lockstep`: 3 pre-warmup
               steps, 3 cycles of a critic step every other step, a
               `graphs` line each), bit-equal to the eager steps, a replay
               of each program traced;
 11. loop    : the training driver through the port's command line, in
               process (`rave_tpu_torch.cli.main`): a seeded corpus of .wav
               tones, chirps and noise (104 records of 131072 samples, 2 of
               them the validation split) -> `preprocess` -> `train --config
               v2` at B=8 x 131072 with the device-resident dataset,
               pre-warmup, adversarial and critic steps, validation before
               and after the warmup, periodic and final checkpoints -> a
               second `train` with more steps that resumes -> a `--bf16
               --device_data off` run of all three programs through the
               threaded host loader (`threaded_loader`: the loop's rule
               takes the C++ sampler there, which phase 17 runs) -> `eval`
               twice. Each step, validation and checkpoint save of the
               training loop is observed in process (it ends in a synchronize and
               records its time and its launches of each variant; every
               run prints that its steps run as CUDA graphs, and the runs
               capture graphs and replay them, the resumed run its own after
               the restore): exactly
               22 launches of the step's variant per step that runs Python
               (none in a replay) and 22 fp32 per
               validation or eval batch, and the gradient kernel's per step
               as phase 8 (none in validation or eval, one per unit in the
               receptive-field probe); finite losses; the PCA buffers set
               by the pre-warmup validation; the run dir's files and
               checkpoints; the resumed state bit-equal to its checkpoint
               and its first batch the one an unbroken device pipeline makes
               at that step; eval finite and the same twice. Prints loop ms
               per step by phase against phase `train`'s bare steps, the
               device-data batch's device ms, the checkpoint's seconds and
               MB, and the peak memory;
 12. export  : phase 11's run through the port's command line: `export
               --streaming --ema_weights` and `export --stereo --sr 88200`
               (manifests: the latent size truncated from the run's
               fidelity buffer, ratios, latency, stream batch and rate, the
               step programs exported on the card; export seconds and MiB);
               `generate` of a seeded 30 s wav (ragged against the block):
               exactly 22 launches, the written wav within 1/32767 of
               `ExportedRAVE.forward` on the same input and seed; the
               artifact on the card against the same artifact on the CPU
               (plain unit) on a 3 s clip, offline and 8 streaming blocks,
               <= 1e-3; in lockstep over 16 blocks with a `reset_stream`
               halfway (`run_lockstep`), the artifact's served streaming
               forward (a CUDA graph replay), its eager twin (the step
               program called directly), `forward_step.pt2`
               (`torch.export.load`) called directly and through
               `StepGraphs`: the served outputs and state bit-equal to the
               eager twin's, the .pt2 within 1e-5 of the served ones (outputs
               and state), the served .pt2 bit-equal to the direct one, the
               served p50s (forward and .pt2) under the block's budget; the
               stereo artifact's served forward likewise against its eager
               twin. Prints generate's realtime factor end to end
               and for the bare forward, the streaming p50 per block (served,
               served .pt2, eager, .pt2 eager, the model's bare steps) against
               the block's budget, the peak memory, and the
               unit at the 30 s forward's 11 centered shapes at B=1 against
               its plain version (phase 3's machinery);
 13. prior   : the latent prior (run after phase 12, on phase 11's run and
               store), TF32 off: (a) the stock prior (prior_v1.gin: resolution
               32, res_size 512, skp_size 256, 10 layers) at latent_size 16
               (512 channels) at B=8 over the 128 latent frames of the 262144
               samples train_prior takes at v2's decimation: the forward on
               the card against the CPU (1e-3), 64 chained `step` calls
               against the offline logits (1e-4), one Adam step (ms, peak
               memory); (b) `cli train_prior --smoke_test --n_signal 524288`
               (2 steps, a decoded sample and a save after each; the loop's
               16-step run keeps most of its 128 dimensions, whose diagonal
               shift needs more than the default 128 frames): exactly 11 launches (one v2
               half) per `encode_latents` and per `decode_latents`, 44 in
               all, the latent size it chose; (c) `cli export --prior` (11
               launches: its smoke decode) and `cli generate --prior_seconds
               5` (11: one decode; the wav's length), `sample_prior(argmax=True)`
               on the card against the CPU (the card's chain fed to the CPU's
               prior gives the card's codes, float32 ties aside), `prior_step.pt2`
               and both served steps (the artifact's graph of the step, the
               .pt2 through `StepGraphs`) bit-equal to the eager step over 32
               steps, and the p50 of a prior step, served, served .pt2, eager
               and .pt2, each under one latent frame's period
               (2048 / 44100 s = 46.44 ms: a live prior makes a frame per
               block); (d) the unit at every shape (b) and (c) gave it, as
               recorded there (the encoder's at B=8 x 524288 samples, the
               decoders' at B=1 over the validation sample's frames (128
               less the shift's D - 1), 8 and 108 latent frames), against
               its plain version (1e-4), one `encode_latents` batch of (b)
               and the decode of a prior sample on the card against the CPU
               (1e-3). Work in build/prior, deleted at its end;
 14. v1     : compose(["v1"]) at full width (capacity 64, latent 128, 16
               bands, ratios 4.4.4.2, BatchNorm, the noise synth on, the
               multiscale critic at capacity 64), TF32 off; v1 has no
               DilatedUnit, so every count of (a)-(d) is 0: (a) the forward
               at B=16 x 131072 in eval mode (BatchNorm on its running
               statistics), timed, and at B=1 x 65536 the card against the
               CPU (1e-3); (b) v1 causal streamed through step_encode and
               step_decode against the offline pass past the delays (1e-3);
               (c) one step of each program at B=8 x 131072 after a warm
               one (ms, peak memory), the three programs eager and through
               `TrainGraphs` under deterministic cuDNN (`family_lockstep`,
               bit-equal, BatchNorm's running statistics included), the first step
               of each at B=1 on the card against the CPU (losses and
               BatchNorm's running statistics 1e-4); (d) `cli train
               --config v1` on phase 11's store, resumed once (bit-equal,
               the running statistics included), `cli export --streaming`,
               `cli generate` of a 30 s
               file, the artifact on the card against the CPU (1e-3),
               `forward_step.pt2` bit-equal to the served steps over 16
               blocks, the served forward (and (b)'s causal model through
               `graphed_stream`) bit-equal to the eager steps across a
               reset, the served streaming p50s (forward, .pt2) under the
               46.44 ms budget, the eager ones printed; (e) `cli export_onnx
               --verify` of a 2-step `--config
               onnx` run (0 launches) and of phase 11's v2 run (its live
               forward's 22 launches exactly, the kernel held against its
               plain version at each shape they gave it, 1e-4), each verify
               within 1e-4, both `--skip_stablehlo`; (f) `cli export_onnx`
               of the v2 run at B=1 and at B=16 x 131072 (the portable
               programs, kept for phase 22b). Work in build/v1, deleted at
               the end;
 15. spectral : compose(["v2", "spectral_discriminator"]) at full width (the
               multiscale critic beside EncodecConvNets on the complex STFTs at
               4096..256, capacity 32), TF32 off: at B=8 x 131072 a warm and
               a timed step of each program in fp32 and under `train.bf16` +
               `bf16_dis` (22 launches of the step's variant each, ms, peak
               memory), and one warm and one timed adversarial generator step
               of v2 with `distance.kind` `encodec`, `instantaneous` and
               `distance.num_mels=64` (22 each; 396 launches in all, 132 bf16);
               then the first step of each fp32 program and of each distance
               at B=1 x 65536 on the card against the CPU (every loss term
               within 1e-4, the instantaneous distance's phase terms too: the
               weighted form damps the near-silent bins whose phase cuFFT and
               the CPU could wrap apart), and the critic alone, forward and backward on the 16-row
               real+fake batch (device ms: whole, its multiscale and its
               spectral part; fp32 and bf16) beside its forward FLOP;
 16. import : a reference checkpoint at full width: v2's seeded weights (an
               orthogonal latent PCA, a mean, a fidelity curve) written under
               the reference's names as a `.ckpt` by tools/torch_reference_ckpt.py
               beside a `config.gin` that includes configs/v2.gin; `cli
               import_torch --config config.gin` (0 launches), `cli export
               --streaming` (11: its smoke decode) and `cli generate` of a 30 s
               file (22: one forward, at v2's B=1 shapes), counted from 0
               before the import; the imported model's encode-decode and its
               artifact's forward against the source weights' (the same
               weights saved as a port run and exported alike) within 1e-5
               (the weight norm re-decomposed in float32); the artifact's
               served forward bit-equal to its eager twin over 16 blocks
               across a reset, its served streaming p50s per 2048-sample
               block (forward, `.pt2`) under its 46.44 ms, the eager ones
               printed; the unit against its plain version at each shape the
               path gave it (1e-4). Work in build/import, deleted at the end;
 17. native : the C++ sampler (csrc/ars_pipeline.cc, built by g++ into
               build/kernels/) on phase 11's store: B=8 x 131072 with the
               phase mangle and the dither against its numpy twin
               `sample_plain` (max abs err <= 1e-6) and its host ms per
               batch; then `cli train --device_data off` in process, fp32
               and `--bf16`, 8 steps each (the three programs), fed by the
               native loader (its batches counted), its steps as CUDA graphs,
               observed as phase 11's runs: exactly 22 launches of the step's
               variant per step and
               per validation batch; loop ms per step against the bare step,
               printed beside phase 11's threaded host-loader figures. Work in
               build/native, deleted at the end;
 18. remote : `cli remote_dataset` on a free localhost port, a process of
               its own, killed on the way out: `get_dataset("http://...")`
               through `Loader` gives 3 batches of B=8 x 131072 bit-equal to
               the same `Loader` over the local store (ms per batch over
               HTTP and locally), 3 v2 steps on them through `TrainGraphs`
               (a warm-up step, a capture and its replay, a replay; 22
               wrapper launches in each of the first two, none in the
               replay, finite losses), and `train` on the URL raises
               FileNotFoundError (ROADMAP C20);
 19. parallel : `python -m torch.distributed.run --nproc_per_node 2 -m
               rave_tpu_torch.parallel.mpworker --full`: v2 at full width
               (at `distance.log_epsilon=1e-3`: at v2's 1e-7 the float32
               pre-warmup gradient is rounding noise in many elements,
               ROADMAP C4, and Adam's first update, lr * sign(g), parts two
               summation orders by 5% in the next loss), two ranks of B=4 x
               131072 on one card with gloo, pre-warmup, adversarial and
               critic steps under cuDNN's deterministic algorithms; the
               ranks' parameters and buffers bit-equal (a digest); against
               one process running the same steps on the global batch of 8
               from the same seeded weights and draws, step 0's loss within
               1e-4 and step 0's averaged generator gradient within
               DP_GRAD_TOL (relative L2 over all parameters; the later
               losses are printed, not held: after Adam's sign-driven first
               update they part by rounding noise, ROADMAP C21); exactly 22
               launches per step on every
               rank; the unit against its plain version at the 11 centered
               B=4 shapes of those steps (1e-4); then a 2-rank `cli train
               --device_data off` (B=1 per rank: one validation record each)
               for 4 steps and resumed to 6: the native loader, validation in
               lockstep every 2 steps, one checkpoint per validation written
               by rank 0, the steps eager by the loop's rule (gloo's
               collectives cannot be captured; rank 0 says so). The workers
               run beside the two `cli train` runs (the 2-rank worker beside
               the first, the one process beside the resume): their step ms are
               taken under that load. A dead rank fails the phase. Work in
               build/parallel, deleted at the end;
 20. discrete : compose(["discrete"]) at full width (capacity 96, latent 128,
               16 x 1024 codes, 128 noise channels, ratios 4.4.2.2), TF32
               off: the unit at the shapes only it reaches (C=768, T=256,
               d 1 and 3, at B=16 and B=8) against its plain version
               (1e-4); the forward at B=16 x 131072 (22 launches, timed) and
               at B=1 x 65536 the card against the CPU (encoder 1e-3; fed the
               card's latent, the CPU's quantizers pick the card's codes, float32
               ties aside: `check_codes`; the decode of one index tensor
               1e-3); at B=8 x
               131072 the k-means step timed alone, then pre-warmup,
               adversarial and critic steps (22 launches each, every
               program updating the codebooks), `codebook_health`, and the
               first step of each program at B=1 on the card against the
               CPU (losses 1e-3); `cli train --config discrete` on phase
               11's store resumed once (the restored state, codebooks and
               `inited` included, bit-equal to its checkpoint; health logged
               at each validation) and `cli eval`; `cli export --streaming`
               and `cli generate` of a 30 s file (22 launches), the artifact
               on the card against the CPU (latents 1e-3 and `check_codes`, the
               decode of one index tensor 1e-3), `forward_step.pt2` bit-equal to
               the served steps over 16 blocks, the served forward bit-equal
               to its eager twin across a reset, the served p50s (forward,
               .pt2) under the 1024-sample block's 23.22 ms; then v2 + wasserstein and
               v2 + spherical: one generator step each at B=8 x 131072 (22
               launches), the first step at B=1 and the artifact's codec
               halves (`EncodeSide`, `DecodeSide`) of the stepped model on
               the card against the CPU (1e-3); the `cli train` run's
               portable program at B=1 x 131072 (kept for phase 22b); the
               phase aims at ~60 s;
 21. variants : v2_small (capacity 48, ratios 4.2.2.2, the noise synth with
               32 bands), v2_nopqmf (capacity 64, raw-waveform output,
               decoder ratios 8.8.8.4) and hybrid (mel input, hop 256,
               encoder ratios 2.2.2, a 2-layer GRU at the decoder's input)
               at full width, TF32 off, each: (a) the forward at B=16 x
               131072 with exactly 22, 22 and 14 launches, each unit's
               (C, T, dilation) as VARIANT_UNITS lists them, timed, and at
               B=1 x 65536 the card against the CPU (1e-3) on the same
               weights and draws (the variational eps, the noise synth's
               uniforms); (b) blocks of block_size() streamed through
               step_encode and step_decode against the offline encode and
               decode past the delays (1e-3; the noise synth's offline
               draws shifted by its lag), and 16 streaming forward blocks
               through `graphed_stream` beside the model's steps
               (`model_lockstep`): bit-equal, the served p50 under the
               block's budget (`v2_small`'s 512 samples: 11.61 ms); (c) the
               receptive-field crop, one step of each program at B=8 x
               131072 after a warm one (launches exact, ms, peak memory),
               hybrid's three programs also eager and through `TrainGraphs`
               under deterministic cuDNN (`family_lockstep`, bit-equal), and
               the first step of each at B=1 x 65536 on the card against the
               CPU (losses 1e-4); (d) `cli train --config <preset>` 3 steps
               (the three programs) on phase 11's store with the device
               dataset (v2_nopqmf's RandomCompress off for it), `cli export
               --streaming`, `cli generate` of a 30 s file (a forward's
               launches), the artifact on the card against the CPU (3 s clip
               offline, 8 streaming blocks; 1e-3) and `forward_step.pt2`
               against the served steps over 16 blocks (1e-5), the served
               forward bit-equal to its eager twin across a reset, the served
               p50s (forward, .pt2) under the block's budget, the eager ones
               printed. hybrid trains without the valid-signal
               crop (ROADMAP C12). Work in build/variants, deleted at the end;
 22. v3     : compose(["v3"]) at full width (capacity 96, latent 128, ratios
               4.4.4.2, Snake, AdaIN before each residual unit, the descript
               critic with periods 2, 3, 5, 7, 11 and FFT sizes 2048, 1024,
               512), TF32 off. Its Snake units bypass the kernel, as the JAX
               package gates its Pallas kernel to leaky ReLU: every count of
               this phase is 0. (a) the forward at B=16 x 131072 in training
               mode and at B=8 in eval mode with learned AdaIN statistics
               (AdaIN holds 8 batch slots), timed; at B=1 x 65536 in eval
               mode the card against the CPU (1e-3), the transfer acting;
               (b) the receptive-field probe, then fp32 and `train.bf16` +
               `bf16_dis` steps of the three programs at B=8 x 131072 (ms
               per step, peak memory), the fp32 programs also eager and
               through `TrainGraphs` under deterministic cuDNN
               (`family_lockstep`, bit-equal), the first step of each
               program at B=1 on
               the card against the CPU (losses 1e-3), and the critic alone,
               forward and backward on the 16-row real+fake batch, device ms
               split between its MPDs and MRDs; (c) `cli train --config v3` on
               phase 11's store resumed once (bit-equal, AdaIN included),
               AdaIN's calls recorded with the mode (training in the steps,
               eval in validation, eval and the probe), `cli eval` twice,
               equal; (d) `cli export --streaming`, `cli generate` of a 30 s
               file, the AdaIN attributes (learn a target, learn a source,
               transfer) on the card against the CPU call by call from the
               CPU's state (1e-3), then free-running from a fresh state on
               the card and on the CPU, each against its own fixed kernels in
               float64: the card's outputs with cuDNN off no further than 3x
               the CPU's, and the card as it serves (cuDNN) with no growth
               of the error over the 8 transfer blocks past the stream's
               reach (the receptive field's left side plus the delay, from
               the transfer's start: no block read sees the learning
               segments), later half against earlier half; the transfer
               moving the output, `forward_step.pt2` bit-equal to the served
               steps over 16 blocks while the target learns (AdaIN's state
               included), the served forward bit-equal to its eager twin
               over those blocks (a reset halfway) and 4 more with the
               target's learning off and reset, the cuDNN-off stream served
               by a graph captured with cuDNN off (one more capture), the
               resets bringing the identity back, the served streaming p50s
               (forward, .pt2) under the 46.44 ms budget; (e) discrete_v3: the
               B=16 forward, the k-means step apart, one step of each program
               at B=8, B=1 losses card vs CPU (1e-3) and `check_codes`;
               (f) the `cli train` run's portable program at B=1 x 131072
               (no unit node; kept for phase 22b); work in build/v3,
               deleted at the end;
 22b. portable : the portable full graph (export/portable.py) of the runs
               phases 14 (the loop's v2 run, at B=1 and at B=16 x 131072),
               20 and 22 train (at B=1 x 131072), each written by `cli
               export_onnx`
               on the card with the live forward's output on a seeded
               input and seed (`portable_case`, TF32 off); the registered
               op `rave_tpu_torch::dilated_unit` (csrc/unit_op.cc, built by
               g++ in a thread after phase 2) at every v2 unit shape of B=16
               and B=1 x 131072, bit-equal to `fused_dilated_unit` and within
               1e-4 of the plain version; then every program in one process
               that imports torch and never the port
               (tools/torch_portable_run.py, its `sys.modules` checked): the
               `.ts` within 1e-5 of the live forward, the `.pt2` within 1e-5
               of the `.ts`, the op library's launches one per unit node per
               call, and one profiled call's device kernels: a
               `prepare_weights_f32` per unit (22 for v2 and discrete, 0 for
               v3) and a `unit_kernel` per fused plan, two per split one; ms
               per forward and the realtime factor printed beside phase 5's;
 23. host   : the port's Python-free artifact host (csrc/rtpu_host.cc,
               built by g++ against the installed torch in a thread started
               after phase 1, beside the phases that work the card; the
               build's seconds printed) on the artifacts phases 12, 13, 20 and
               22 wrote (kept in build/host/artifacts when their phases
               delete their work), every streaming command of it served by
               one captured CUDA graph per step program (each command's
               `steps:` line: one capture, a replay per block, the capture's
               seconds): `info` of each (side by side) against
               its manifest, on cuda:0 and the card's name, with the
               served path's backend flags and the TorchScript executor's
               profiling and
               optimizations off; 32 blocks of v2 (phase 12's centered mono
               artifact) through `encode`, its latents bit-equal to the
               Python artifact's eager stream (the step called directly)
               from the initial state on the same seeds, then `decode` of
               them and `forward`, each wav within 1/32767 of the eager
               stream's output; `encode` and `forward` of the discrete
               artifact (1024-sample blocks) likewise (these five host
               commands run side by side, before the eager streams they are
               held to); v3's AdaIN in three
               processes (learn the target, learn the source, transfer,
               the state carried by `--save-state` / `--load-state`)
               against one eager stream with the same fills, wavs within
               1/32767; `prior` (dithered) on phase 13's artifact bit-equal
               to `sample_prior` on the card; `bench 128` of each streaming
               artifact: the graph's p50 per block (upload, step, fetch,
               synchronize) under the block's budget (v2 and v3 46.44 ms,
               discrete 23.22 ms), the interpreter's eager p50 on the same
               blocks beside it, the graph's outputs and final state
               bit-equal to the eager ones, and the Python artifact's served
               and eager p50s as phases 12, 20 and 22 timed them (blocks on
               the card, nothing fetched); every saved state's bit
               equality with the eager stream's recorded; 0 unit launches;
 24. the kernels' JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Each phase that streams also prints a `graphs` line: the CUDA graphs it
captured and replayed, and per family the served, served .pt2, eager and
.pt2 eager p50s against the block's budget.

Per-shape details go to build/chip_smoke.json; the loop and export phases
work in build/loop (corpus, db, run dirs, artifacts, generated wavs), the
prior phase in build/prior, the v1 phase in build/v1, the import phase in
build/import, the native phase in build/native, the remote phase in
build/remote, the parallel phase in build/parallel, the discrete phase in
build/discrete, the variants phase in
build/variants, the v3 phase in build/v3 and the host phase in build/host
(each deleted at its end; the host's binary stays in build/host).
"""
from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "rave_tpu_torch/csrc/dilated_unit.cu"
KERNEL_REPLACES = "rave_tpu/ops/kernels/dilated_unit.py:75"
# the gradient's kernel replaces `_bwd` of the custom_vjp (XLA's recompute, no Pallas in it)
KERNEL_BWD_REPLACES = "rave_tpu/ops/kernels/dilated_unit.py:132"
# device kernels of one call of the gradient: the weights' preparation, g, dh, dx, dw1 and dw2
BWD_KERNELS = 5
# the decoder's units in every preset that has them: an adversarial generator step's
# gradient launches (the encoder runs frozen, without a graph)
DECODER_UNITS = 11
SAMPLE_RATE = 44100
KERNEL_TOL, MODEL_TOL = 1e-4, 1e-3
LOSS_TOL, GRAD_FLOOR = 1e-4, 1e-3  # GPU vs CPU step: loss; gradient bound's floor
BF16_MARGIN, BF16_TOL = 1.1, 1e-2  # bf16 kernel vs the fp32 referee; vs plain bf16
BF16_LOSS_TOL = 0.05  # bf16 step losses against fp32 (rave_tpu's tests/test_train.py:140)
# bf16 vs fp32 step gradients, global relative L2 (their reasons: PERF.md, section 6)
GRAD_BF16_BOUND = {"gen": 2.0, "gen_eps1e-3": 0.2, "dis": 0.05}
REMAT_LOSS_TOL, REMAT_GRAD_TOL = 1e-6, 1e-5
# (C, T, dilations) of the residual units at B=16 x 131072 samples; each
# shape runs once in the encoder and once in the decoder of a forward
UNIT_SHAPES = [(96, 8192, (1, 3, 9)), (192, 2048, (1, 3, 9)), (384, 512, (1, 3, 9)),
               (768, 128, (1, 3))]
BATCH, N_SIGNAL = 16, 131072
TRAIN_BATCH = 8  # data.batch of the v2 preset: the unit shapes above at half the batch
# the H100's peaks (NVIDIA's data sheet, SXM, dense): fp32 at fp32 accuracy on
# the tensor cores is 3xTF32, a third of TF32's 495 TFLOP/s
PEAK_FLOPS = {"fp32": 495e12 / 3, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12
SLEEP_CYCLES_PER_CALL = 1_000_000  # ~0.6 ms of the card's clock per timed call (cuda_ms)
AUTOGRAD_SLEEP_CYCLES = 5_000_000  # ~3 ms per timed forward + backward under autograd
# the loop phase: 104 records (2 in the validation split); a short warmup and a critic
# step every other step, so that a few steps run all three programs
LOOP_RECORDS, LOOP_FILES = 104, 4
LOOP_SCHEDULE = ["train.phase_1_duration=6", "train.update_discriminator_every=2",
                 "train.ema=0.999"]  # EMA on: validation and `eval --ema_weights` use it
LOOP_STEPS, LOOP_RESUME_STEPS = 12, 16
LOOP_BF16_STEPS, LOOP_BF16_WARMUP = 10, 4  # three or four steps of each program
LOOP_VAL_EVERY, LOOP_SAVE_EVERY = 6, 8
EVAL_METRICS = ("spectral_distance", "waveform_l1", "frechet_mel_distance")
LOOP_VAL_BATCH = 2  # the validation split of LOOP_RECORDS records, in one batch
# the export phase: generate's file, the card-vs-CPU clip and block counts
EXPORT_SECONDS, CLIP_SECONDS, GENERATE_SEED = 30.0, 3.0, 5
CPU_STREAM_BLOCKS, PROGRAM_BLOCKS, PROGRAM_TOL = 8, 16, 1e-5


def rel_err(a, b, floor: float = 1e-12) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(floor))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def refuses(call, error) -> bool:
    """True when `call()` raises `error` (a check that the wrapper refuses
    an input; any other exception propagates)."""
    try:
        call()
    except error:
        return True
    return False


def cuda_ms(fn, iters: int, sleep_cycles: int = SLEEP_CYCLES_PER_CALL) -> float:
    """Mean device milliseconds per call, by CUDA events, after two warm
    calls. The card first sleeps (`sleep_cycles` per call) while the host
    queues all the calls, so a call whose host work outlasts its device
    work is timed by the latter: this is the device's time per call, not
    the host's, as long as the sleep outlasts the host's queueing."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def unit_bound(rows, batch: int, dtype: str, backward: bool = False) -> dict:
    """The least time the card could take for the units of `rows` (one
    launch each): per launch the larger of its bytes (x read and y written
    once, both weights read once) over the HBM rate and its FLOP, 2 (K+1)
    C^2 T B, over the peak for the type; summed over the launches. With
    `backward`, forward and backward together: x and the output's gradient
    read, y and dx written, the weights read and their gradients written,
    and three times the forward's FLOP (y, dx and dw)."""
    elem = 4 if dtype == "fp32" else 2
    acts, weights, work = (4, 2, 3) if backward else (2, 1, 1)
    bytes_s = ops_s = bound_s = 0.0
    for r in rows:
        C, T, K = r["C"], r["T"], 3
        b = (acts * batch * C * T + weights * (K + 1) * C * C) * elem / HBM_BYTES_PER_S
        o = work * 2 * (K + 1) * C * C * T * batch / PEAK_FLOPS[dtype]
        bytes_s, ops_s, bound_s = bytes_s + b, ops_s + o, bound_s + max(b, o)
    return {"bound_ms": bound_s * 1e3, "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "bytes_ms": bytes_s * 1e3, "ops_ms": ops_s * 1e3}


def reset_counts() -> None:
    """Every launch count of the unit's kernels to 0: the forward's (both
    variants) and the gradient's."""
    from rave_tpu_torch.ops.kernels import dilated_unit as du

    du.launches = du.launches_bf16 = du.launches_backward = du.launches_backward_bf16 = 0


def bwd_per_step(phase: str, units: int) -> int:
    """The gradient kernel's launches in one step of `phase` of a model with
    `units` fused units per forward: every unit in a pre-warmup generator
    step, the decoder's in an adversarial one, none in a critic step (its
    generator pass runs without a graph)."""
    if units == 0:
        return 0
    return {"gen_prewarmup": units, "gen_adversarial": DECODER_UNITS, "dis": 0}[phase]


def unit_bwd_bound(rows, batch: int, dtype: str) -> dict:
    """The least time the card could take for the gradient alone of the units
    of `rows` (one launch each), as `unit_bound`: bytes x and gy read, dx
    written, the weights read and their gradients written; FLOP those the
    gradient needs from x, the weights and gy: h again (2 K C^2 T B: its
    sign is leaky'(h), and dw2 reads leaky(h)), dh (2 C^2 T B), dx (2 K C^2
    T B), dw2 (2 C^2 T B) and dw1 (2 K C^2 T B)."""
    elem = 4 if dtype == "fp32" else 2
    bytes_s = ops_s = bound_s = 0.0
    for r in rows:
        C, T, K = r["C"], r["T"], 3
        b = (3 * batch * C * T + 2 * (K + 1) * C * C) * elem / HBM_BYTES_PER_S
        o = 2 * (3 * K + 2) * C * C * T * batch / PEAK_FLOPS[dtype]
        bytes_s, ops_s, bound_s = bytes_s + b, ops_s + o, bound_s + max(b, o)
    return {"bound_ms": bound_s * 1e3, "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "bytes_ms": bytes_s * 1e3, "ops_ms": ops_s * 1e3}


def unit_weights(C: int, gen, dtype):
    import torch

    w1 = torch.randn(C, C, 3, device="cuda", generator=gen) / math.sqrt(3 * C)
    w2 = torch.randn(C, C, device="cuda", generator=gen) / math.sqrt(C)
    return w1.to(dtype), w2.to(dtype)


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port has no CPU fallback here")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build() -> dict:
    from rave_tpu_torch.ops.kernels import build, dilated_unit

    t0 = time.perf_counter()
    lib = build.build("dilated_unit")
    dilated_unit.smem_limit()  # loads the library and binds it
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    info = {"seconds": seconds, "library": str(lib.relative_to(ROOT)), "nvcc": build.nvcc(),
            "flags": " ".join(build.NVCC_FLAGS), "ptxas": ptxas}
    print(f"build: {KERNEL_SOURCE} -> {info['library']} by {info['nvcc']} "
          f"[{info['flags']}] in {seconds:.2f} s; ptxas: {' | '.join(ptxas[:6])}", flush=True)
    return info


def kernel_cases(batch: int, modes) -> list:
    """(case, B, C, T, d, mode) of the kernel phases: every v2 unit shape at
    `batch` in each mode; then, at each C and its widest dilation, centered,
    a ragged length (T - 21) at `batch` and the main length at B=1."""
    cases = [("main", batch, C, T, d, mode) for C, T, dils in UNIT_SHAPES for d in dils
             for mode in modes]
    for C, T, dils in UNIT_SHAPES:
        cases += [("ragged", batch, C, T - 21, dils[-1], "centered"),
                  ("b1", 1, C, T, dils[-1], "centered")]
    return cases


def kernel_row(gen, case: str, B: int, C: int, T: int, d: int, mode: str) -> dict:
    """The fp32 kernel against its plain version on one seeded shape: the
    error (<= KERNEL_TOL) and both device times."""
    import torch

    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels.dilated_unit import (
        fused_dilated_unit, fused_dilated_unit_reference, kernel_plan,
    )

    x = torch.randn(B, C, T, device="cuda", generator=gen)
    w1, w2 = unit_weights(C, gen, torch.float32)
    left, right = get_padding(3, 1, d, mode)
    args = (x, w1, w2, d, left, right)
    with torch.inference_mode():
        y_k = fused_dilated_unit(*args)
        y_p = fused_dilated_unit_reference(*args)
        torch.cuda.synchronize()
        err, abs_err = rel_err(y_k, y_p), float((y_k - y_p).abs().max())
        check(bool(torch.isfinite(y_k).all()) and y_k.shape == x.shape,
              f"kernel output not finite or of shape {tuple(y_k.shape)} at {B, C, T, d, mode}")
        check(err <= KERNEL_TOL, f"kernel vs plain at B={B} C={C} T={T} d={d} {mode}: "
                                 f"rel err {err:.3e} > {KERNEL_TOL}")
        ms = cuda_ms(lambda: fused_dilated_unit(*args), 20)
        plain_ms = cuda_ms(lambda: fused_dilated_unit_reference(*args), 20)
    flop = 2 * 4 * C * C * T * B
    return {"case": case, "B": B, "C": C, "T": T, "d": d, "mode": mode,
            "plan": kernel_plan(B, C, T, 3, d, left, False)._asdict(),
            "rel_err": err, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms, "tflops": flop / ms / 1e9,
            "plain_tflops": flop / plain_ms / 1e9}


def phase_kernel() -> list:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    # the loop's validation and eval batches: the 2 clips of the validation split
    val_cases = [("val", LOOP_VAL_BATCH, C, T, d, "centered") for C, T, dils in UNIT_SHAPES
                 for d in dils]
    rows = [kernel_row(gen, *case) for case in kernel_cases(BATCH, ("centered", "causal"))
            + val_cases + variant_unit_cases(BATCH)]
    worst = max(r["rel_err"] for r in rows)
    print(f"kernel: {len(rows)} shapes, max rel err {worst:.2e} <= {KERNEL_TOL}; "
          f"kernel/plain ms: {shape_summary(rows)}", flush=True)
    return rows


def shape_summary(rows) -> str:
    return "; ".join(f"{'' if r['case'] == 'main' else r['case'] + ' '}B{r['B']} {r['C']}x{r['T']} "
                     f"d{r['d']} {r['mode'][:4]} {r['ms']:.3f}/{r['plain_ms']:.3f}" for r in rows)


def phase_kernel_bf16() -> list:
    import torch

    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels.dilated_unit import (
        fused_dilated_unit, fused_dilated_unit_reference, kernel_plan,
    )

    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = []
    cases = (kernel_cases(TRAIN_BATCH, ("centered", "causal"))
             + [c for c in kernel_cases(BATCH, ("centered",)) if c[0] == "main"]
             + variant_unit_cases(TRAIN_BATCH))
    for case, B, C, T, d, mode in cases:
        x = torch.randn(B, C, T, device="cuda", generator=gen).bfloat16()
        w1, w2 = unit_weights(C, gen, torch.bfloat16)
        left, right = get_padding(3, 1, d, mode)
        args = (x, w1, w2, d, left, right)
        with torch.inference_mode():
            y_k = fused_dilated_unit(*args)
            y_p = fused_dilated_unit_reference(*args)
            y_32 = fused_dilated_unit_reference(x.float(), w1.float(), w2.float(), d, left, right)
            torch.cuda.synchronize()
            check(y_k.dtype == torch.bfloat16 and bool(torch.isfinite(y_k).all())
                  and y_k.shape == x.shape,
                  f"bf16 kernel output {y_k.dtype}, {tuple(y_k.shape)} or not finite at "
                  f"{B, C, T, d, mode}")
            err_k, err_p = rel_err(y_k, y_32), rel_err(y_p, y_32)
            err_kp = rel_err(y_k, y_p)
            check(err_k <= BF16_MARGIN * err_p and err_kp <= BF16_TOL,
                  f"bf16 kernel at B={B} C={C} T={T} d={d} {mode}: {err_k:.3e} from the fp32 "
                  f"referee (plain bf16 {err_p:.3e}), {err_kp:.3e} from plain bf16")
            ms = cuda_ms(lambda: fused_dilated_unit(*args), 20)
            plain_ms = cuda_ms(lambda: fused_dilated_unit_reference(*args), 20)
        rows.append({"case": case, "B": B, "C": C, "T": T, "d": d, "mode": mode,
                     "plan": kernel_plan(B, C, T, 3, d, left, True)._asdict(),
                     "rel_err_fp32": err_k, "plain_rel_err_fp32": err_p, "rel_err_plain": err_kp,
                     "max_abs_err": float((y_k.float() - y_p.float()).abs().max()),
                     "ms": ms, "plain_ms": plain_ms})
    worst = max(r["rel_err_plain"] for r in rows)
    ratio = max(r["rel_err_fp32"] / r["plain_rel_err_fp32"] for r in rows)
    summary = shape_summary(rows)
    print(f"kernel_bf16: {len(rows)} shapes; from the fp32 referee at most {ratio:.2f}x the plain "
          f"bf16's error (<= {BF16_MARGIN}); from plain bf16 <= {worst:.2e} (<= {BF16_TOL}); "
          f"kernel/plain bf16 ms: {summary}", flush=True)
    return rows


def phase_offline() -> dict:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.models.blocks import LatentDraws
    from rave_tpu_torch.ops.kernels import dilated_unit

    cfg = compose(["v2"])
    cpu_model = build_rave(cfg, seed=0, device="cpu").eval()
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    T_lat = N_SIGNAL // cfg.decimation()
    draws = LatentDraws(eps=torch.randn(BATCH, cfg.latent_size, T_lat, device="cuda",
                                        generator=gen))
    with torch.inference_mode():
        model(x, draws)  # warm (cuDNN heuristics, allocator)
        torch.cuda.synchronize()
        reset_counts()
        y = model(x, draws)
        torch.cuda.synchronize()
        launches = dilated_unit.launches
        check(tuple(y.shape) == (BATCH, 1, N_SIGNAL), f"output shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), "offline output is not finite")
        check(launches == 22 and dilated_unit.launches_bf16 == 0,
              f"{launches} kernel launches ({dilated_unit.launches_bf16} bf16) in one forward, "
              f"expected 22 fp32")
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x, draws)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / iters
        rtf = BATCH * N_SIGNAL / SAMPLE_RATE / sec

        # (b) the same weights and eps at B=1 x 65536: kernel on the GPU, plain on the CPU
        n = 65536
        xb = torch.randn(1, 1, n, generator=torch.Generator().manual_seed(2)) * 0.1
        eb = LatentDraws(eps=torch.randn(1, cfg.latent_size, n // cfg.decimation(),
                                         generator=torch.Generator().manual_seed(3)))
        y_cpu = cpu_model(xb, eb)
        y_gpu = model(xb.cuda(), eb.to("cuda")).cpu()
        err = rel_err(y_gpu, y_cpu)
        check(err <= MODEL_TOL, f"GPU vs CPU forward rel err {err:.3e} > {MODEL_TOL}")
    out = {"launches": launches, "forward_ms": sec * 1e3, "realtime_factor": rtf,
           "gpu_vs_cpu_rel_err": err}
    print(f"offline: v2 B={BATCH} x {N_SIGNAL}, {launches} kernel launches per forward, "
          f"{sec * 1e3:.2f} ms per forward = {rtf:.1f}x realtime; B=1 x {n} GPU vs CPU "
          f"rel err {err:.2e} <= {MODEL_TOL}", flush=True)
    return out


def phase_stream() -> dict:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.nn.streaming import init_stream_state

    cfg = compose(["v2", "causal"])
    model = build_rave(cfg, stream_batch=1, seed=4, device="cuda").eval()
    check(model.encode_delay == 0 and model.decode_delay == 0, "causal delays are not 0")
    block, n_blocks, D = cfg.block_size(), 32, cfg.latent_size
    x = torch.randn(1, 1, block * n_blocks, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5)) * 0.1
    with torch.inference_mode():
        init_stream_state(model, 1)
        zs, ys, times = [], [], []
        for i in range(n_blocks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z = model.step_encode(x[..., i * block:(i + 1) * block])
            y = model.step_decode(z[:, :D])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            zs.append(z)
            ys.append(y)
        z_st, y_st = torch.cat(zs, -1), torch.cat(ys, -1)
        z_off = model.encode(x)
        y_off = model.decode(z_off[:, :D])
        z_err, y_err = rel_err(z_st, z_off), rel_err(y_st, y_off)
        check(y_st.shape == y_off.shape == x.shape, f"stream shape {tuple(y_st.shape)}")
        check(bool(torch.isfinite(y_st).all()), "streaming output is not finite")
        check(z_err <= MODEL_TOL and y_err <= MODEL_TOL,
              f"stream vs offline rel err z {z_err:.3e}, y {y_err:.3e} > {MODEL_TOL}")
    p50 = statistics.median(times) * 1e3
    budget = block / SAMPLE_RATE * 1e3
    reset_graph_counts()
    served = model_lockstep(model, cfg, x, n_blocks)
    check(served["graph_bit_equal"], f"stream: graphed_stream not bit-equal to the model's steps "
                                     f"({served['graph_max_rel_err']:.3e})")
    check(served["p50_ms"]["graph"] < budget, f"stream: served p50 {served['p50_ms']} over the "
                                              f"{budget:.2f} ms budget")
    out = {"block": block, "blocks": n_blocks, "block_ms_p50": p50, "block_budget_ms": budget,
           "z_rel_err": z_err, "y_rel_err": y_err, "served": served,
           "graphs": graphs_line("stream", {"v2_causal": served["p50_ms"]},
                                 {"v2_causal": budget})}
    print(f"stream: v2 causal, {n_blocks} blocks of {block} samples, p50 {p50:.3f} ms per "
          f"block eager, {served['p50_ms']['graph']:.3f} ms served by graphed_stream, bit-equal "
          f"to the eager steps over {n_blocks} blocks across a reset (budget {budget:.2f} ms); "
          f"vs offline rel err z {z_err:.2e}, y {y_err:.2e} <= {MODEL_TOL}", flush=True)
    return out


def grad_cases() -> list:
    """(case, B, C, T, d, mode) of phase `grad`'s backward checks: every (C, T,
    d) of UNIT_SHAPES and VARIANT_UNITS, centered and causal, at B=8 and B=1;
    then at each width its longest T and widest dilation there, ragged (T - 21),
    centered, at B=8 and B=1."""
    shapes = sorted({(C, T, d) for C, T, dils in UNIT_SHAPES for d in dils}
                    | {(C, T, d) for units in VARIANT_UNITS.values() for C, T, dils in units
                       for d in dils})
    cases = [("main" if B == TRAIN_BATCH else "b1", B, C, T, d, mode) for C, T, d in shapes
             for B in (TRAIN_BATCH, 1) for mode in ("centered", "causal")]
    widest = {}
    for C, T, d in shapes:
        widest[C] = max(widest.get(C, (0, 0)), (T, d))
    return cases + [("ragged", B, C, T - 21, d, "centered") for C, (T, d) in sorted(widest.items())
                    for B in (TRAIN_BATCH, 1)]


def backward_row(gen, case: str, B: int, C: int, T: int, d: int, mode: str, dtype) -> dict:
    """The gradient's kernel (`_backward`, all three gradients) against its plain
    version on one seeded shape. leaky'(h) jumps at h = 0, and the kernel's h
    and the plain h differ by their rounding, so the plain version is taken at
    the kernel's side of the kink (its recomputed g as `g_sign`), the kernel's
    g is held to the plain g, and every h whose side differs must lie within
    that rounding of 0 (KERNEL_TOL of max |h| in fp32, BF16_TOL in bf16).
    fp32: dx, dw1, dw2 within KERNEL_TOL; bf16: no further from the fp32
    referee (the plain version on the same bf16 numbers in fp32, at the same
    side) than BF16_MARGIN x the plain bf16 version, and within BF16_TOL of it."""
    import torch
    import torch.nn.functional as F

    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels import dilated_unit as du

    left, right = get_padding(3, 1, d, mode)
    x = torch.randn(B, C, T, device="cuda", generator=gen).to(dtype)
    w1, w2 = unit_weights(C, gen, dtype)
    gy = torch.randn(B, C, T, device="cuda", generator=gen).to(dtype)
    args = (x, w1, w2, gy, d, left, right)
    *got, g_k = du.backward_kernel_with_g(*args)
    want = du.fused_dilated_unit_backward_reference(*args, g_sign=g_k)
    again = du._backward(*args, (True, True, True))
    torch.cuda.synchronize()
    where = f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} B={B} C={C} T={T} d={d} {mode}"
    check(all(bool(torch.isfinite(a).all()) and a.dtype == dtype and a.shape == b.shape
              for a, b in zip(got, want)), f"gradient kernel not finite, or not {dtype}, at {where}")
    # the weight gradients' splits are added in a fixed order: the same bits every call
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"two calls of the gradient kernel differ at {where}")
    h = F.conv1d(F.pad(du._leaky(x.float()), (left, right)), w1.float(), dilation=d)
    flips = (g_k > 0) != (h > 0)
    kink = float(h[flips].abs().max() / h.abs().max()) if bool(flips.any()) else 0.0
    keys = ("dx", "dw1", "dw2")
    errs = {k: rel_err(a, b) for k, a, b in zip(keys, got, want)}
    row = {"case": case, "B": B, "C": C, "T": T, "d": d, "mode": mode, "flips": int(flips.sum()),
           "flip_h_max": kink, **{f"{k}_rel_err": v for k, v in errs.items()},
           "max_abs_err": max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, want))}
    if dtype == torch.float32:
        row["g_rel_err"] = rel_err(g_k, du._leaky(h))
        check(kink <= KERNEL_TOL and max(errs.values()) <= KERNEL_TOL
              and row["g_rel_err"] <= KERNEL_TOL,
              f"gradient kernel vs plain at {where}: {errs}, g {row['g_rel_err']:.3e}, "
              f"{row['flips']} sides of the kink differ at |h| <= {kink:.3e} max (<= {KERNEL_TOL})")
    else:
        ref = du.fused_dilated_unit_backward_reference(
            *(t.float() for t in (x, w1, w2, gy)), d, left, right, g_sign=g_k)
        check(kink <= BF16_TOL, f"bf16 gradient kernel at {where}: {row['flips']} sides of the "
                                f"kink differ at |h| <= {kink:.3e} max (<= {BF16_TOL})")
        for k, a, b, r in zip(keys, got, want, ref):
            e_k, e_p = rel_err(a, r), rel_err(b, r)
            row[f"{k}_rel_err_fp32"], row[f"{k}_plain_rel_err_fp32"] = e_k, e_p
            check(e_k <= BF16_MARGIN * e_p and errs[k] <= BF16_TOL,
                  f"bf16 gradient kernel {k} at {where}: {e_k:.3e} from the fp32 referee "
                  f"(plain bf16 {e_p:.3e}), {errs[k]:.3e} from plain bf16")
    if case == "main" and mode == "centered":  # the times of a B=8 training step's units
        fwd_bwd_ms, plain_fwd_bwd_ms = function_ms(x, w1, w2, gy, d, left, right)
        row.update(fwd_bwd_ms=fwd_bwd_ms, plain_fwd_bwd_ms=plain_fwd_bwd_ms,
                   bwd_ms=cuda_ms(lambda: du._backward(*args, (True, True, True)), 10),
                   plain_bwd_ms=cuda_ms(
                       lambda: du.fused_dilated_unit_backward_reference(*args), 10))
        if (C, T, d) in {(c, t, e) for c, t, dils in UNIT_SHAPES for e in dils}:  # v2's
            row.update(inputs=args, **wgrad_library(x, w1, w2, gy, d, left, right))
    return row


def wgrad_kernels(rows) -> None:
    """For each row's `inputs`, one `_backward` call's device kernels and the
    weight gradients' kernel's device ms per call, from one torch.profiler
    session over 5 calls of each after a warm one. The calls run on one
    stream, so their kernels run in launch order: the session's kernels, by
    start, must be BWD_KERNELS per call, each call's the weights'
    preparation, three launches of `unit_kernel` and one of
    `wgrad_wgmma_kernel`. Fills `kernels_per_call` and `wgrad_ms`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rave_tpu_torch.ops.kernels import dilated_unit as du

    calls = 5
    for r in rows:
        du._backward(*r["inputs"], (True, True, True))
    torch.cuda.synchronize()
    for attempt in range(2):  # a session that recorded no device event is run again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for r in rows:
                for _ in range(calls):
                    du._backward(*r["inputs"], (True, True, True))
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                          and not e.is_user_annotation), key=lambda e: e.time_range.start)
        if kernels:
            break
    check(len(kernels) == BWD_KERNELS * calls * len(rows),
          f"the gradient's {calls * len(rows)} calls ran {len(kernels)} device kernels, not "
          f"{BWD_KERNELS} each")
    want = {"prepare_weights_bwd": 1, "unit_kernel": 3, "wgrad_wgmma_kernel": 1}
    for i, r in enumerate(rows):
        mine = kernels[i * BWD_KERNELS * calls:(i + 1) * BWD_KERNELS * calls]
        for c in range(calls):
            names = [e.name for e in mine[c * BWD_KERNELS:(c + 1) * BWD_KERNELS]]
            check(all(sum(k in n for n in names) == m for k, m in want.items()),
                  f"a gradient call at C={r['C']} T={r['T']} d={r['d']} ran {names}")
        r["kernels_per_call"] = len(mine) / calls
        r["wgrad_ms"] = sum(e.time_range.end - e.time_range.start for e in mine
                            if "wgrad_wgmma_kernel" in e.name) / 1e3 / calls


def wgrad_library(x, w1, w2, gy, d, left, right) -> dict:
    """cuDNN's weight gradients of the unit's two convolutions on these inputs
    (`aten.convolution_backward` with output_mask (False, True, False): dw1
    from the padded leaky(x) and dh, dw2 from g and gy, in the inputs' type,
    TF32 off in fp32: a yardstick the port never calls), by `cuda_ms`; and
    their bound, 2 (K + 1) C^2 T B FLOP over the type's peak."""
    import torch
    import torch.nn.functional as F

    from rave_tpu_torch.ops.kernels import dilated_unit as du

    # the plain gradient's dh and g in the inputs' type, for cuDNN's weight gradients
    h = F.conv1d(F.pad(du._leaky(x), (left, right)), w1, dilation=d)
    g = du._leaky(h)
    dh = du._leaky_grad(g, F.conv1d(gy, w2.t()[:, :, None]))
    a = F.pad(du._leaky(x), (left, right))
    conv_bwd = torch.ops.aten.convolution_backward

    def library():
        conv_bwd(dh, a, w1, None, [1], [0], [d], False, [0], 1, [False, True, False])
        conv_bwd(gy, g, w2[:, :, None], None, [1], [0], [1], False, [0], 1, [False, True, False])

    B, C, T = x.shape
    flop = 2 * (w1.shape[2] + 1) * C * C * T * B
    peak = PEAK_FLOPS["bf16" if x.dtype == torch.bfloat16 else "fp32"]
    return {"library_wgrad_ms": cuda_ms(library, 10), "wgrad_bound_ms": flop / peak * 1e3}


def function_ms(x, w1, w2, gy, d, left, right) -> tuple:
    """Device ms of forward plus backward (all three gradients): the
    autograd.Function (both kernels), then plain autograd through the plain
    version (cuDNN). Checks on the way that the Function's gradients are
    `_backward`'s to the bit, and its y within the forward kernel's rules."""
    import torch

    from rave_tpu_torch.ops.kernels import dilated_unit as du

    leaves = [t.detach().requires_grad_() for t in (x, w1, w2)]

    def fwd_bwd(fn):
        y = fn(*leaves, d, left, right)
        return (y, *torch.autograd.grad(y, leaves, gy))

    y, *grads = fwd_bwd(du.fused_dilated_unit)
    y_p = fwd_bwd(du.fused_dilated_unit_reference)[0]
    check(all(torch.equal(a, b) for a, b in zip(grads, du._backward(
        x, w1, w2, gy, d, left, right, (True, True, True)))),
        f"the Function's gradients are not the gradient kernel's at C={x.shape[1]} d={d}")
    err = rel_err(y.detach(), y_p.detach())
    if x.dtype == torch.float32:
        check(err <= KERNEL_TOL, f"Function y vs plain at C={x.shape[1]} d={d}: {err:.3e}")
    else:
        check(err <= BF16_TOL, f"bf16 Function y vs plain at C={x.shape[1]} d={d}: {err:.3e}")
    # autograd's host work per call (the Function's Python, the allocations,
    # ~10-30 launches) can outlast a call's device work: a longer sleep
    sleep = AUTOGRAD_SLEEP_CYCLES
    return (cuda_ms(lambda: fwd_bwd(du.fused_dilated_unit), 10, sleep),
            cuda_ms(lambda: fwd_bwd(du.fused_dilated_unit_reference), 10, sleep))


def phase_grad() -> dict:
    import torch

    from rave_tpu_torch.ops.kernels.dilated_unit import fused_dilated_unit

    # what the kernel does not take must raise on the card, with autograd
    # recording or not: no call quietly runs the plain version
    f32, f64, b16 = torch.float32, torch.float64, torch.bfloat16
    refusals = [(8, f64, f64, 1, TypeError), (16, b16, f32, 1, TypeError),
                (12, f32, f32, 1, ValueError), (24, b16, b16, 1, ValueError),
                (8, f32, f32, 60, ValueError)]  # (C, dtype of x, of the weights, dilation, error)
    for C, x_dtype, w_dtype, d, error in refusals:
        w1 = torch.zeros(C, C, 3, device="cuda", dtype=w_dtype)
        w2 = torch.zeros(C, C, device="cuda", dtype=w_dtype)
        for grad in (False, True):
            x = torch.zeros(1, C, 16, device="cuda", dtype=x_dtype, requires_grad=grad)
            check(refuses(lambda: fused_dilated_unit(x, w1, w2, d, d, d), error),
                  f"the wrapper took C={C} x {x_dtype}, w {w_dtype}, d={d} (grad {grad}) "
                  f"instead of raising {error}")

    gen = torch.Generator(device="cuda").manual_seed(10)
    t0 = time.perf_counter()
    out = {name: [backward_row(gen, *case, dtype) for case in grad_cases()]
           for dtype, name in ((f32, "fp32"), (b16, "bf16"))}
    v2 = {(C, T, d) for C, T, dils in UNIT_SHAPES for d in dils}
    for name, rs in list(out.items()):
        timed = [r for r in rs if "bwd_ms" in r]
        v2_rows = [r for r in timed if "inputs" in r]
        wgrad_kernels(v2_rows)
        for r in v2_rows:
            r.pop("inputs")
            check(r["kernels_per_call"] == BWD_KERNELS,
                  f"one {name} call of the gradient ran {r['kernels_per_call']} device kernels "
                  f"at C={r['C']} T={r['T']} d={r['d']}, not {BWD_KERNELS}")
        # the 11 centered v2 shapes at B=8, each once: half a training step's units
        out[name + "_v2"] = [r for r in timed if (r["C"], r["T"], r["d"]) in v2]
        worst = max(max(r[f"{k}_rel_err"] for k in ("dx", "dw1", "dw2")) for r in rs)
        flips = sum(r["flips"] for r in rs)
        summary = "; ".join(f"{r['C']}x{r['T']} d{r['d']} {r['fwd_bwd_ms']:.3f}/"
                            f"{r['plain_fwd_bwd_ms']:.3f} (bwd {r['bwd_ms']:.3f}/"
                            f"{r['plain_bwd_ms']:.3f}; wgrad {r['wgrad_ms']:.4f}/"
                            f"{r['library_wgrad_ms']:.4f}/{r['wgrad_bound_ms']:.4f})"
                            for r in out[name + "_v2"])
        print(f"grad {name}: {len(refusals)} refusals raised with and without autograd; the "
              f"gradient kernel at {len(rs)} shapes, two calls bit-equal at each, dx/dw1/dw2 "
              f"max rel err from plain {worst:.2e} (at the kernel's side of the kink; {flips} "
              f"sides differ, all at |h| <= {max(r['flip_h_max'] for r in rs):.1e} max); "
              f"{BWD_KERNELS} device kernels per call; v2 at B={TRAIN_BATCH}, fwd+bwd ms "
              f"Function/plain (bwd kernel/plain; weight gradients kernel/cuDNN/bound): "
              f"{summary}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def _grad_errors(grads, ref) -> dict:
    """Per tensor: max abs difference over the reference's max (or 1e-4 where
    that is smaller: the hinge loss's last-bias gradients cancel to zero)."""
    return {n: rel_err(grads[n], ref[n].to(grads[n].dtype), floor=1e-4) for n in ref}


def _grad_distance(grads, ref) -> float:
    """Global relative L2 distance over every tensor: |g - ref| / |ref|."""
    num = sum(float((grads[n].double() - ref[n].double()).square().sum()) for n in ref)
    den = sum(float(ref[n].double().square().sum()) for n in ref)
    return math.sqrt(num / den)


def _train_run(cfg, crop, x, bf16: bool, per_step: int = 22, prewarmup: int = 5,
               cycles: int = 4) -> dict:
    """`prewarmup` pre-warmup generator steps, then `cycles` *
    update_discriminator_every steps picked by pick_phase past the warmup,
    from seed 0, on the card: the kernel launches of each step (`per_step`
    of the expected variant, none of the other; the gradient kernel's
    `bwd_per_step` of the same variant), finite losses, moved
    params, the global step; ms per step per phase (mean after the first)
    and the peak memory."""
    import torch

    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, pick_phase

    t = cfg.train
    steps = build_train_steps(cfg, crop)
    state = create_train_state(cfg, seed=0, device="cuda")
    noise = torch.Generator(device="cuda").manual_seed(7)
    snapshot = lambda m: [p.detach().clone() for p in m.parameters()]  # noqa: E731
    moved = lambda m, before: sum(not torch.equal(p, q)  # noqa: E731
                                  for p, q in zip(m.parameters(), before))
    gen0, dis0 = snapshot(state.model), snapshot(state.discriminator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {"gen_prewarmup": [], "gen_adversarial": [], "dis": []}
    last, launches, launches_bwd, bwd_by_phase = {}, 0, 0, {}
    kind = "bf16" if bf16 else "fp32"

    def one_step(which: str, warmed: bool) -> None:
        nonlocal launches, launches_bwd
        step = state.step
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        if which == "dis":
            m = steps["dis"](state, x, generator=noise)
        else:
            m = steps["gen"](state, x, warmed, generator=noise)
        torch.cuda.synchronize()
        name = "dis" if which == "dis" else ("gen_adversarial" if warmed else "gen_prewarmup")
        times[name].append(time.perf_counter() - t1)
        n_bf16 = dilated_unit.launches_bf16
        n_kind = n_bf16 if bf16 else dilated_unit.launches - n_bf16
        check(n_kind == per_step and dilated_unit.launches == per_step,
              f"{dilated_unit.launches} kernel launches ({n_bf16} bf16) in a {kind} {name} "
              f"step, expected {per_step} {kind}")
        launches += n_kind
        n_bwd, want_bwd = dilated_unit.launches_backward, bwd_per_step(name, per_step)
        n_bwd_bf16 = dilated_unit.launches_backward_bf16
        check(n_bwd == want_bwd and n_bwd_bf16 == (n_bwd if bf16 else 0),
              f"{n_bwd} gradient kernel launches ({n_bwd_bf16} bf16) in a {kind} {name} step, "
              f"expected {want_bwd} {kind}")
        launches_bwd += n_bwd
        bwd_by_phase[name] = n_bwd
        check(state.step == step + 1, f"global step {state.step} after step {step}")
        bad = [k for k, v in m.items() if not math.isfinite(float(v))]
        check(not bad, f"{kind} {name} step: non-finite {bad}")
        last[name] = {k: float(v) for k, v in m.items()}

    for _ in range(prewarmup):
        one_step("gen", False)
    check(moved(state.model, gen0) > 0, "pre-warmup steps moved no generator param")
    check(moved(state.discriminator, dis0) == 0, "pre-warmup steps moved the critic")
    state.step = t.phase_1_duration
    dis1 = snapshot(state.discriminator)
    for _ in range(cycles * t.update_discriminator_every):
        which, warmed, _ = pick_phase(cfg, state.step)
        one_step(which, warmed)
    check(len(times["dis"]) >= 2 and len(times["gen_adversarial"]) >= 2, f"phases {times}")
    check(moved(state.discriminator, dis1) > 0, "critic steps moved no critic param")
    check(state.step == t.phase_1_duration + cycles * t.update_discriminator_every,
          "global step")
    check(all(p.dtype == torch.float32 for p in state.model.parameters()), "masters not fp32")
    return {"ms_per_step": {k: statistics.mean(v[1:]) * 1e3 for k, v in times.items()},
            "steps": {k: len(v) for k, v in times.items()}, "launches_per_step": per_step,
            "launches": launches, "launches_backward": launches_bwd,
            "launches_backward_per_step": bwd_by_phase,
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "last_metrics": last}


def _step_once(cfg, crop, which: str, x, eps, device="cuda", dtype=None):
    """One pre-warmup generator step ("gen") or critic step ("dis") of `cfg`
    from the seed-0 state: (metrics, {name: gradient on the CPU})."""
    from rave_tpu_torch.models.blocks import LatentDraws
    from rave_tpu_torch.train.state import create_train_state, make_optimizers
    from rave_tpu_torch.train.steps import build_train_steps

    steps = build_train_steps(cfg, crop)
    st = create_train_state(cfg, seed=0, device=device)
    if dtype is not None:
        st.model.to(dtype)
        st.discriminator.to(dtype)
        st.gen_opt, st.dis_opt = make_optimizers(cfg, st.model, st.discriminator)
    if which == "dis":
        st.step = cfg.train.phase_1_duration
    x, d = x.to(device, dtype or x.dtype), LatentDraws(eps=eps.to(device, dtype or eps.dtype))
    m = steps["gen"](st, x, False, draws=d) if which == "gen" else steps["dis"](st, x, draws=d)
    module = st.model if which == "gen" else st.discriminator
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.cpu() for n, p in module.named_parameters()})


def _b1_inputs(cfg):
    import torch

    N = cfg.data.n_signal
    xb = torch.randn(1, 1, N, generator=torch.Generator().manual_seed(8)) * 0.1
    eb = torch.randn(1, cfg.latent_size, N // cfg.decimation(),
                     generator=torch.Generator().manual_seed(9))
    return xb, eb


def phase_train() -> dict:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.analysis import crop_frames, receptive_field

    cfg = compose(["v2"])
    B, N = cfg.data.batch, cfg.data.n_signal
    t0 = time.perf_counter()
    rf = receptive_field(cfg, device="cuda")
    crop = crop_frames(cfg, rf)
    probe_s = time.perf_counter() - t0
    x = torch.randn(B, 1, N, device="cuda", generator=torch.Generator(device="cuda").manual_seed(6))
    x = x * 0.1
    reset_counts()
    run = _train_run(cfg, crop, x, bf16=False)

    # the same seeded weights at B=1: GPU (kernel) against CPU (plain), and a
    # float64 CPU run as the referee of both float32 gradients
    xb, eb = _b1_inputs(cfg)
    compare = {}
    for which in ("gen", "dis"):
        (m_gpu, g_gpu), (m_cpu, g_cpu), (_, g_64) = (
            _step_once(cfg, crop, which, xb, eb, device, dtype)
            for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                                  ("cpu", torch.float64)))
        loss_err = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-2) for k in m_cpu)
        gpu_vs_64, cpu_vs_64 = _grad_errors(g_gpu, g_64), _grad_errors(g_cpu, g_64)
        gpu_vs_cpu = _grad_errors(g_gpu, g_cpu)
        bound = max(GRAD_FLOOR, 2 * max(cpu_vs_64.values()))
        compare[which] = {"loss_rel_err": loss_err, "grad_gpu_vs_cpu": max(gpu_vs_cpu.values()),
                          "grad_gpu_vs_f64": max(gpu_vs_64.values()),
                          "grad_cpu_vs_f64": max(cpu_vs_64.values()), "grad_bound": bound,
                          "grad_gpu_vs_f64_median": statistics.median(gpu_vs_64.values()),
                          "grad_cpu_vs_f64_median": statistics.median(cpu_vs_64.values()),
                          "grad_gpu_vs_f64_global": _grad_distance(g_gpu, g_64)}
    out = {"rf": list(rf), "crop_frames": list(crop), "probe_s": probe_s, "batch": B,
           "n_signal": N, **run, "gpu_vs_cpu": compare}
    print(f"train: v2 B={B} x {N}, rf {rf} samples -> crop {crop} band frames (probe "
          f"{probe_s:.1f} s); ms per step (mean after one warm step): "
          + ", ".join(f"{k} {v:.1f} (x{run['steps'][k] - 1})" for k, v in run["ms_per_step"].items())
          + f"; 22 kernel launches per step, {run['launches']} in all; gradient kernel "
          + f"{run['launches_backward_per_step']} per step, {run['launches_backward']} in all; peak "
          + f"{run['peak_gb']:.2f} GiB; "
          + "; ".join(f"B=1 {k}: loss GPU vs CPU {c['loss_rel_err']:.1e}, grad GPU vs CPU "
                      f"{c['grad_gpu_vs_cpu']:.2e}, vs float64 GPU {c['grad_gpu_vs_f64']:.2e} "
                      f"CPU {c['grad_cpu_vs_f64']:.2e} (bound {c['grad_bound']:.2e})"
                      for k, c in compare.items()), flush=True)
    for k, c in compare.items():
        check(c["loss_rel_err"] <= LOSS_TOL, f"{k} step: GPU vs CPU loss {c['loss_rel_err']:.3e}")
        check(c["grad_gpu_vs_f64"] <= c["grad_bound"],
              f"{k} step: GPU gradients {c['grad_gpu_vs_f64']:.3e} from float64, bound "
              f"{c['grad_bound']:.3e}")
    return out


def _is_loss(name: str) -> bool:
    return name.startswith(("loss_", "multiband_", "fullband_", "regularization",
                            "feature_matching", "adversarial"))


def phase_train_bf16(crop) -> dict:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.steps import build_train_steps

    flags = ["train.bf16=true", "train.bf16_dis=true"]
    cfg = compose(["v2"], flags)
    B, N = cfg.data.batch, cfg.data.n_signal
    x = torch.randn(B, 1, N, device="cuda", generator=torch.Generator(device="cuda").manual_seed(6))
    x = x * 0.1
    reset_counts()
    run = _train_run(cfg, crop, x, bf16=True)

    # B=1 from the same seeded weights: bf16 against fp32, both on the card
    xb, eb = _b1_inputs(cfg)
    compare = {}
    for key, which, extra in (("gen", "gen", []), ("gen_eps1e-3", "gen", ["distance.log_epsilon=1e-3"]),
                              ("dis", "dis", [])):
        m32, g32 = _step_once(compose(["v2"], extra), crop, which, xb, eb)
        m16, g16 = _step_once(compose(["v2"], flags + extra), crop, which, xb, eb)
        check(all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                  for g in g16.values()), f"bf16 {key} step: gradients not fp32 or not finite")
        losses = {k: abs(m16[k] - v) / max(abs(v), 1e-2) for k, v in m32.items() if _is_loss(k)}
        compare[key] = {"loss_rel_err": max(losses.values()), "worst_loss": max(losses, key=losses.get),
                        "grad_distance": _grad_distance(g16, g32),
                        "grad_bound": GRAD_BF16_BOUND[key],
                        "grad_max_rel": max(_grad_errors(g16, g32).values())}
    out = {"batch": B, "n_signal": N, **run, "bf16_vs_fp32": compare,
           "variants": {p: _variant_bf16(p, flags) for p in VARIANT_BF16}}
    hybrid = compose(["hybrid"], flags + VARIANT_OVERRIDES["hybrid"])
    check(refuses(lambda: build_train_steps(hybrid, (0, 0)), ValueError),
          "hybrid (mel input) with train.bf16 built its steps; rave_tpu has no such step")
    print(f"train_bf16: v2 + {' '.join(flags)}, B={B} x {N}; ms per step (mean after one warm "
          f"step): " + ", ".join(f"{k} {v:.1f} (x{run['steps'][k] - 1})"
                                 for k, v in run["ms_per_step"].items())
          + f"; 22 bf16 launches and no fp32 per step, {run['launches']} in all; peak "
          + f"{run['peak_gb']:.2f} GiB; B=1 bf16 vs fp32: "
          + "; ".join(f"{k}: losses {c['loss_rel_err']:.2e} ({c['worst_loss']}) <= "
                      f"{BF16_LOSS_TOL}, grad distance {c['grad_distance']:.3e} <= "
                      f"{c['grad_bound']:g}" for k, c in compare.items()), flush=True)
    for preset, v in out["variants"].items():
        r = v["run"]
        print(f"train_bf16 {preset}: B={B} x {N} ms per step (mean after one warm step) "
              + ", ".join(f"{k} {ms:.1f} (x{r['steps'][k] - 1})" for k, ms in
                          r["ms_per_step"].items())
              + f"; {r['launches_per_step']} bf16 launches and no fp32 per step, "
              f"{r['launches']} in all; peak {r['peak_gb']:.2f} GiB; B=1 bf16 vs fp32: "
              + "; ".join(f"{k}: losses {c['loss_rel_err']:.2e} ({c['worst_loss']}) <= "
                          f"{BF16_LOSS_TOL}, grad distance {c['grad_distance']:.3e} <= "
                          f"{c['grad_bound']:g}" for k, c in v["bf16_vs_fp32"].items())
              + "; hybrid + train.bf16 refused (ROADMAP C14)", flush=True)
    for what, cmp in [("v2", compare)] + [(p, v["bf16_vs_fp32"])
                                          for p, v in out["variants"].items()]:
        for k, c in cmp.items():
            check(c["loss_rel_err"] <= BF16_LOSS_TOL,
                  f"{what} bf16 {k} step: losses {c['loss_rel_err']:.3e} from fp32 "
                  f"({c['worst_loss']})")
            check(c["grad_distance"] <= c["grad_bound"],
                  f"{what} bf16 {k} step: gradients {c['grad_distance']:.3e} from fp32, bound "
                  f"{c['grad_bound']}")
    return out


def _variant_bf16(preset: str, flags) -> dict:
    """`preset` with `flags` (train.bf16 + bf16_dis) at full width: `_train_run`'s
    steps (2 pre-warmup, then 2 of each program past the warmup: exact bf16
    launches, finite, ms, peak), without the valid-signal crop (the probe is
    phase `variants`' work; the crop changes no program); then at B=1 x
    131072 from the seed-0 state, on the same draws, a pre-warmup generator
    step at log_epsilon 1e-3 and a critic step in bf16 against fp32 on the
    card, under phase 9's bounds."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise

    crop_off = ["train.valid_signal_crop=false"]
    cfg = compose([preset], flags + crop_off)
    x = torch.randn(TRAIN_BATCH, 1, N_SIGNAL, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
    run = _train_run(cfg, (0, 0), x, bf16=True, per_step=VARIANT_LAUNCHES[preset],
                     prewarmup=2, cycles=2)
    xb, _ = _b1_inputs(cfg)
    draws = draw_noise(compose([preset]), xb, torch.Generator().manual_seed(9)).to("cuda")
    xb = xb.to("cuda")

    def step(overrides, which):
        c = compose([preset], crop_off + overrides)
        st = create_train_state(c, seed=0, device="cuda")
        if which == "dis":
            st.step = c.train.phase_1_duration
        steps = build_train_steps(c, (0, 0))
        m = (steps["gen"](st, xb, False, draws=draws) if which == "gen"
             else steps["dis"](st, xb, draws=draws))
        module = st.model if which == "gen" else st.discriminator
        return ({k: float(v) for k, v in m.items()},
                {n: p.grad.detach().cpu() for n, p in module.named_parameters()})

    compare = {}
    for key, which, extra in (("gen_eps1e-3", "gen", ["distance.log_epsilon=1e-3"]),
                              ("dis", "dis", [])):
        m32, g32 = step(extra, which)
        m16, g16 = step(flags + extra, which)
        check(all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                  for g in g16.values()), f"{preset} bf16 {key} step: gradients not fp32 or "
                                          "not finite")
        losses = {k: abs(m16[k] - v) / max(abs(v), 1e-2) for k, v in m32.items() if _is_loss(k)}
        compare[key] = {"loss_rel_err": max(losses.values()),
                        "worst_loss": max(losses, key=losses.get),
                        "grad_distance": _grad_distance(g16, g32),
                        "grad_bound": GRAD_BF16_BOUND[key]}
    return {"run": run, "bf16_vs_fp32": compare}


def phase_remat(crop) -> dict:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise

    runs = {}
    torch.backends.cudnn.deterministic = True
    for name, remat in (("warm", False), ("plain", False), ("remat", True), ("plain_again", False)):
        cfg = compose(["v2"], [f"train.remat={str(remat).lower()}"])
        x = torch.randn(cfg.data.batch, 1, cfg.data.n_signal, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
        draws = draw_noise(cfg, x, torch.Generator(device="cuda").manual_seed(7))
        state = create_train_state(cfg, seed=0, device="cuda")
        step = build_train_steps(cfg, crop)["gen"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        m = step(state, x, False, draws=draws)
        torch.cuda.synchronize()
        runs[name] = {"ms": (time.perf_counter() - t0) * 1e3, "launches": dilated_unit.launches,
                      "launches_backward": dilated_unit.launches_backward,
                      "peak_gb": (torch.cuda.max_memory_allocated() - base) / 2**30,
                      "metrics": {k: float(v) for k, v in m.items()},
                      "grads": {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}}
        del state, step, m
    torch.backends.cudnn.deterministic = False
    del runs["warm"]  # cuDNN's and the allocator's first-call costs
    plain, remat, again = runs["plain"], runs["remat"], runs["plain_again"]

    def loss_err(a, b):
        return max(abs(a["metrics"][k] - v) / max(abs(v), 1e-2) for k, v in b["metrics"].items())

    out = {"loss_rel_err": loss_err(remat, plain),
           "grad_distance": _grad_distance(remat["grads"], plain["grads"]),
           "plain_again_loss_rel_err": loss_err(again, plain),
           "plain_again_grad_distance": _grad_distance(again["grads"], plain["grads"]),
           "plain_again_bit_equal": all(torch.equal(again["grads"][n], g)
                                        for n, g in plain["grads"].items()),
           **{f"{k}_{f}": r[f] for k, r in runs.items()
              for f in ("ms", "launches", "launches_backward", "peak_gb")}}
    print(f"remat: v2 fp32 pre-warmup step, B={TRAIN_BATCH} x {N_SIGNAL}: with remat vs "
          f"without, losses {out['loss_rel_err']:.2e} <= {REMAT_LOSS_TOL}, gradients "
          f"{out['grad_distance']:.2e} <= {REMAT_GRAD_TOL} (without vs without: "
          f"{out['plain_again_loss_rel_err']:.2e}, {out['plain_again_grad_distance']:.2e}); "
          f"launches {remat['launches']} vs {plain['launches']}, gradient kernel "
          f"{remat['launches_backward']} vs {plain['launches_backward']}; the step again "
          f"{'bit-equal' if out['plain_again_bit_equal'] else 'NOT bit-equal'}; peak above the state "
          f"{remat['peak_gb']:.2f} vs {plain['peak_gb']:.2f} GiB; {remat['ms']:.1f} vs "
          f"{plain['ms']:.1f} ms (one step each)", flush=True)
    check(plain["launches"] == 22 and remat["launches"] == 44,
          f"launches {plain['launches']} without remat (22), {remat['launches']} with (44)")
    check(plain["launches_backward"] == 22 and remat["launches_backward"] == 22,
          f"gradient kernel launches {plain['launches_backward']} without remat, "
          f"{remat['launches_backward']} with (22 each)")
    check(out["plain_again_bit_equal"], "the same pre-warmup step from the same state and noise "
          f"gave other gradients (distance {out['plain_again_grad_distance']:.3e})")
    check(out["loss_rel_err"] <= REMAT_LOSS_TOL, f"remat losses {out['loss_rel_err']:.3e} apart")
    check(out["grad_distance"] <= REMAT_GRAD_TOL, f"remat gradients {out['grad_distance']:.3e} apart")
    check(remat["peak_gb"] < plain["peak_gb"], "remat did not lower the peak memory")
    return out


# ---- the training programs as CUDA graphs (train/graphs.py) -----------------------------

# what `cli train` prints when it runs its steps as CUDA graphs (train/loop.py::step_method),
# and under data parallelism
GRAPHED_STEPS = "the training steps run as CUDA graphs"
EAGER_DP_STEPS = "the training steps run eagerly (data parallel"

TRAIN_GRAPH_MODES = {"fp32": [], "bf16": ["train.bf16=true", "train.bf16_dis=true"],
                     "remat": ["train.remat=true"]}
# a family's graphed steps beside its eager ones: 3 pre-warmup steps, then 3 cycles of a
# critic's period of 2, so that each program's key is warmed up (one eager step), captured
# (its one replay) and replayed at a later step
FAMILY_PREWARMUP, FAMILY_CYCLES, FAMILY_DIS_EVERY = 3, 3, 2
# the families whose programs bring into a capture what v2's do not: the codebooks' k-means
# and training (discrete), BatchNorm's running statistics (v1), the mel front-end and the GRU
# (hybrid), Snake, AdaIN and the multi-period / multi-resolution critic (v3), the spectral
# critic (spectral); v2_small and v2_nopqmf run v2's programs at other widths and outputs
GRAPHED_FAMILIES = ("discrete", "v1", "hybrid", "v3", "spectral")
TRAIN_GRAPH_PREWARMUP, TRAIN_GRAPH_CYCLES = 5, 4  # phase `train`'s schedule (`_train_run`)


def step_phase(which: str, warmed: bool) -> str:
    return "dis" if which == "dis" else ("gen_adversarial" if warmed else "gen_prewarmup")


def trace_launches(names) -> tuple:
    """The unit's wrapper calls in a device trace's kernel names, as
    `LoopProbe.counts()`: forward calls (fp32, bf16), one weight
    preparation each (`prepare_weights_f32` / `prepare_weights_bf16`), then
    gradient calls (fp32, bf16), one `wgrad_wgmma_kernel` each."""
    wgrad = [n for n in names if "wgrad_wgmma_kernel" in n]
    wgrad_bf16 = sum("bfloat16" in n for n in wgrad)
    return (sum("prepare_weights_f32" in n for n in names),
            sum("prepare_weights_bf16" in n for n in names), len(wgrad) - wgrad_bf16, wgrad_bf16)


@contextlib.contextmanager
def kept_graphs():
    """CUDA graphs made inside keep the graph they captured beside the
    executable one (`keep_graph=True`; instantiated at the first replay), for
    `graph_node_launches`."""
    import torch

    made = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = lambda: made(keep_graph=True)
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = made


def graph_node_launches(graph) -> tuple:
    """The unit's wrapper calls that a captured CUDA graph holds, which each
    of its replays runs: its nodes (`cudaGraphDebugDotPrint` of a graph
    made under `kept_graphs`; one node statement per line start, the kernel's
    name in its label) counted by their kernels' names as
    `trace_launches` counts a trace's kernels."""
    path = ROOT / "build" / "graph_nodes.dot"
    path.unlink(missing_ok=True)
    with warnings.catch_warnings():  # torch's "DEBUG: calling debug_dump()" notes
        warnings.simplefilter("ignore")
        graph.debug_dump(str(path))
    check(path.exists(), "a kept CUDA graph printed no nodes (cudaGraphDebugDotPrint)")
    text = path.read_text(errors="replace")
    path.unlink()
    return trace_launches(re.split(r'\n\s*"[^"\n]*node_\d+"\s*\[', "\n" + text)[1:])


def program_graph(graphs, p: str):
    """The CUDA graph of program `p` among a `TrainGraphs`' (one per program)."""
    which, warmed = ("dis", True) if p == "dis" else ("gen", p == "gen_adversarial")
    held = [e.graph for k, e in graphs.graphs.items() if k[:2] == (which, warmed)]
    check(len(held) == 1, f"{len(held)} graphs of the {p} program")
    return held[0]


def device_trace(calls: dict) -> dict:
    """Each call of `calls` ({name: fn}) profiled alone by torch.profiler
    (the card's activity only: the host's ops would cost the session seconds
    and are not read) and ended by a synchronize: {name: {"busy_ms":
    the union of the intervals of the kernels and copies the card ran,
    "launches": `trace_launches` of its kernels}} (a step's backward
    launches from autograd's own thread, so a range around the call would
    not hold them). A session that recorded no device event is run again
    once; busy_ms None and launches None where the second saw none either."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in calls.items():
        for attempt in range(2):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
            if events:
                break
        if not events:
            out[name] = {"busy_ms": None, "launches": None}
            continue
        spans = sorted((e.time_range.start, e.time_range.end) for e in events)
        busy, (s0, e0) = 0.0, spans[0]
        for a, b in spans[1:]:
            if a > e0:
                busy, s0, e0 = busy + e0 - s0, a, b
            else:
                e0 = max(e0, b)
        out[name] = {"busy_ms": (busy + e0 - s0) / 1e3,
                     "launches": trace_launches([e.name for e in events])}
    return out


PROGRAMS = ("gen_prewarmup", "gen_adversarial", "dis")
# traced sessions of one more step of a program at most: a session can lose a kernel's record
# (seen on an H100 80GB HBM3: 21 of a replay's 22 weight preparations), never add one
TRACE_ATTEMPTS = 3


def graph_lockstep(cfg, crop, x, prewarmup: int, cycles: int, what: str,
                   per_step: int = None, busy: bool = False) -> dict:
    """`prewarmup` pre-warmup generator steps, then `cycles` *
    update_discriminator_every steps past the warmup, each picked by
    pick_phase (phase `train`'s schedule), twice from seed 0 under
    deterministic cuDNN: the eager steps, then `TrainGraphs` over them; step
    i takes the same draws in both. Failing checks: each step's metrics
    bit-equal, and after the runs every parameter, gradient, buffer, Adam
    state and learning rate and EMA tensor; the wrappers' launches in each
    graphed step that ran Python (a key's warm-up, a capture) those of its
    eager twin, and none in a replay (`per_step` forward launches with
    `bwd_per_step` of the gradient's in each eager step where given; a remat
    pre-warmup step twice the forwards, a remat adversarial step its eager
    twin's alone); every program captured once and replayed at a later
    step. Then one more step of each program in each run, past the
    comparison: with `busy` timed (synchronized), then profiled
    (`device_trace`): in the graphed run always, a replay whose unit
    launches, counted in the card's trace, must be those of the program's
    eager steps; in the eager run with `busy`, where the trace's count must
    be the wrappers'. A trace that counts fewer is taken again, one more
    step, up to TRACE_ATTEMPTS sessions (the profiler can lose a record);
    one that counts more fails. The wall of each step, the peak memory of each run
    and the device-busy share of each profiled step."""
    import torch

    from rave_tpu_torch.train import graphs as train_graphs
    from rave_tpu_torch.train.graphs import TrainGraphs, state_tensors
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise, pick_phase

    t = cfg.train
    runs = {}
    with deterministic_cudnn():
        for graphed in (False, True):
            steps = build_train_steps(cfg, crop)
            run = TrainGraphs(steps) if graphed else steps
            state = create_train_state(cfg, seed=0, device="cuda")
            captures, replays = train_graphs.captures, train_graphs.replays
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls, counts, metrics, phases, served, quantize_of = [], [], [], [], [], {}
            # the graphed run's graphs keep their nodes (graph_node_launches)
            with kept_graphs() if graphed else contextlib.nullcontext():
                for i in range(prewarmup + cycles * t.update_discriminator_every):
                    if i == prewarmup:
                        state.step = t.phase_1_duration
                    which, warmed, quantize = pick_phase(cfg, state.step)
                    check((i < prewarmup) == (not warmed),
                          f"{what}: step {state.step} warmed {warmed}")
                    draws = draw_noise(cfg, x,
                                       torch.Generator(device="cuda").manual_seed(100 + i))
                    torch.cuda.synchronize()
                    launched = LoopProbe.counts()  # read, never reset: the phases' totals stand
                    before = train_graphs.captures, train_graphs.replays
                    t0 = time.perf_counter()
                    m = (run.gen(state, x, warmed, draws=draws, quantize=quantize)
                         if which == "gen" else run.dis(state, x, draws=draws, quantize=quantize))
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    # a replay of a graph captured at an earlier step, or a step that ran Python
                    served.append((train_graphs.captures, train_graphs.replays)
                                  == (before[0], before[1] + 1))
                    counts.append(tuple(a - b for a, b in zip(LoopProbe.counts(), launched)))
                    metrics.append({k: v.detach().cpu() for k, v in m.items()})
                    phases.append(step_phase(which, warmed))
                    quantize_of[phases[-1]] = quantize
            runs[graphed] = {"state": state, "run": run, "walls": walls, "counts": counts,
                             "served": served, "metrics": metrics, "phases": phases,
                             "quantize": quantize_of,
                             "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
                             "captures": train_graphs.captures - captures,
                             "replays": train_graphs.replays - replays}
        eager, graph = runs[False], runs[True]
        n = len(eager["phases"])
        for i in range(n):
            a, b = eager["metrics"][i], graph["metrics"][i]
            bad = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
            phase = eager["phases"][i]
            check(a.keys() == b.keys() and not bad,
                  f"{what}: step {i} ({phase}): graphed metrics {bad[:4]} differ from eager "
                  f"({[(float(a[k]), float(b[k])) for k in bad[:2] if k in b]})")
            want = (0, 0, 0, 0) if graph["served"][i] else eager["counts"][i]
            check(graph["counts"][i] == want,
                  f"{what}: step {i} ({phase}, {'a replay' if graph['served'][i] else 'Python'}):"
                  f" wrapper launches {graph['counts'][i]}, expected {want}")
            # a remat adversarial step's recompute: held to its eager twin's count alone
            if per_step is not None and not (t.remat and phase == "gen_adversarial"):
                fwd = per_step * (2 if t.remat and phase == "gen_prewarmup" else 1)
                bwd = bwd_per_step(phase, per_step)
                check(eager["counts"][i] == ((0, fwd, 0, bwd) if t.bf16 else (fwd, 0, bwd, 0)),
                      f"{what}: step {i} ({phase}): launches {eager['counts'][i]}, expected "
                      f"{fwd} forward and {bwd} gradient ({'bf16' if t.bf16 else 'fp32'})")
            check(all(math.isfinite(float(v)) for v in b.values()),
                  f"{what}: step {i}: non-finite metrics")
        ta, tb = state_tensors(eager["state"]), state_tensors(graph["state"])
        check(len(ta) == len(tb), f"{what}: {len(ta)} eager state tensors, {len(tb)} graphed")
        unequal_at = [i for i, (a, b) in enumerate(zip(ta, tb))
                      if (a is None) != (b is None) or (a is not None and not torch.equal(a, b))]
        check(not unequal_at, f"{what}: {len(unequal_at)} of {len(ta)} state tensors differ "
                              f"after the run (parameters, gradients, buffers, Adam states, EMA)")
        programs = [p for p in PROGRAMS if p in eager["phases"]]
        check(graph["captures"] == len(graph["run"].graphs) == len(programs),
              f"{what}: {graph['captures']} graphs captured for the programs {programs}")
        graph_n = {p: sum(q == p and r for q, r in zip(graph["phases"], graph["served"]))
                   for p in programs}
        check(all(graph_n.values()), f"{what}: replays per program {graph_n}: a program was "
                                     f"never replayed after its capture")
        # the programs' unit launches, from their eager steps (one count per program)
        eager_launches = {p: {c for c, q in zip(eager["counts"], eager["phases"]) if q == p}
                          for p in programs}
        check(all(len(v) == 1 for v in eager_launches.values()),
              f"{what}: eager launches per program {eager_launches}")
        eager_launches = {p: v.pop() for p, v in eager_launches.items()}

        for graphed, r in runs.items():  # one more step of each program, past the comparison
            st, run = r["state"], r["run"]
            calls, python = {}, {}
            for p in programs:
                draws = draw_noise(cfg, x, torch.Generator(device="cuda").manual_seed(99))
                q = r["quantize"][p]
                call = (functools.partial(run.gen, st, x, p == "gen_adversarial", draws=draws,
                                          quantize=q) if p != "dis" else
                        functools.partial(run.dis, st, x, draws=draws, quantize=q))

                def counted(call=call, p=p):
                    before = LoopProbe.counts(), train_graphs.captures, train_graphs.replays
                    call()
                    python[p] = (tuple(a - b for a, b in zip(LoopProbe.counts(), before[0])),
                                 (train_graphs.captures, train_graphs.replays)
                                 == (before[1], before[2] + 1))
                calls[p] = counted
            r["busy"] = {}
            if busy:
                for p, call in calls.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    r["busy"][p] = {"wall_ms": (time.perf_counter() - t0) * 1e3}
            if not (graphed or busy):
                continue
            for p, call in calls.items():
                for attempt in range(1, TRACE_ATTEMPTS + 1):
                    traced = device_trace({p: call})[p]
                    counts, replayed = python[p]
                    want = eager_launches[p] if graphed else counts
                    if traced["launches"] == want:
                        break
                    # the profiler can lose a kernel's record, never invent one
                    check(traced["launches"] is None
                          or all(a <= b for a, b in zip(traced["launches"], want)),
                          f"{what}: the {'graphed' if graphed else 'eager'} {p} step's trace "
                          f"holds {traced['launches']} unit launches, more than {want}")
                r.setdefault("trace_attempts", {})[p] = attempt
                if graphed:
                    check(replayed and counts == (0, 0, 0, 0),
                          f"{what}: the traced {p} step was not a replay (wrappers' launches "
                          f"{counts})")
                    nodes = graph_node_launches(program_graph(run, p))
                    r.setdefault("graph_launches", {})[p] = list(nodes)
                    check(nodes == eager_launches[p],
                          f"{what}: the {p} graph's kernel nodes hold {nodes} unit launches, "
                          f"the eager step {eager_launches[p]}")
                    # a trace that lost records in every session is read against the nodes
                    check(traced["launches"] == eager_launches[p] or attempt == TRACE_ATTEMPTS,
                          f"{what}: a replay of the {p} graph ran {traced['launches']} unit "
                          f"launches in the card's trace, the eager step {eager_launches[p]}")
                else:
                    check(traced["launches"] == counts,
                          f"{what}: the eager {p} step's trace holds {traced['launches']} unit "
                          f"launches, its wrappers counted {counts}")
                if busy:
                    wall = r["busy"][p]["wall_ms"]
                    r["busy"][p].update(busy_ms=traced["busy_ms"], busy_share=None
                                        if traced["busy_ms"] is None else traced["busy_ms"] / wall)
                if graphed:
                    r.setdefault("replay_launches", {})[p] = (
                        None if traced["launches"] is None else list(traced["launches"]))

    first = {p: eager["phases"].index(p) for p in programs}
    eager_ms = {p: [w for i, (w, q) in enumerate(zip(eager["walls"], eager["phases"]))
                    if q == p and i != first[p]] for p in programs}
    graph_ms = {p: [w for w, q, r in zip(graph["walls"], graph["phases"], graph["served"])
                    if q == p and r] for p in programs}
    return {"steps": n, "phases": eager["phases"],
            # eager: after each program's first step; graphed: the replays of graphs
            # captured at earlier steps (not the warm-up steps, not the capturing step)
            "eager_ms": {p: statistics.mean(v) if v else None for p, v in eager_ms.items()},
            "graph_ms": {p: statistics.mean(v) if v else None for p, v in graph_ms.items()},
            "eager_n": {p: len(v) for p, v in eager_ms.items()},
            "graph_n": {p: len(v) for p, v in graph_ms.items()},
            "walls_eager": eager["walls"], "walls_graph": graph["walls"],
            "launches": [list(c) for c in graph["counts"]],
            "eager_launches": {p: list(c) for p, c in eager_launches.items()},
            "replay_launches": graph["replay_launches"],
            "graph_launches": graph["graph_launches"],
            "trace_attempts": {"eager": eager.get("trace_attempts", {}),
                               "graph": graph["trace_attempts"]},
            "peak_gb": {"eager": eager["peak_gb"], "graph": graph["peak_gb"]},
            "busy": {"eager": eager["busy"], "graph": graph["busy"]},
            "captures": graph["captures"], "replays": graph["replays"],
            "state_tensors": len(ta)}


def lockstep_summary(r: dict) -> str:
    """One line's worth of a `graph_lockstep` result."""
    fmt = lambda v: "-" if v is None else f"{v:.1f}"  # noqa: E731
    walls = ", ".join(f"{p} {fmt(r['eager_ms'][p])} -> {fmt(r['graph_ms'][p])} "
                      f"(x{r['eager_n'][p]}/x{r['graph_n'][p]})" for p in sorted(r["eager_ms"]))
    traced = ", ".join(f"{p} {v if v is None else tuple(v)}"
                       + (f" (session {r['trace_attempts']['graph'][p]})"
                          if r["trace_attempts"]["graph"][p] > 1 else "")
                       + ("" if v == r["graph_launches"][p] else
                          f" (the graph's nodes {tuple(r['graph_launches'][p])})")
                       for p, v in sorted(r["replay_launches"].items()))
    return (f"{r['steps']} steps bit-equal (metrics; {r['state_tensors']} state tensors), "
            f"{r['captures']} graphs, {r['replays']} replays; unit launches of a replay in the "
            f"card's trace (fwd fp32, bf16, grad fp32, bf16; the graph's kernel nodes hold the "
            f"eager step's): {traced}; ms eager -> graphed: "
            f"{walls}; peak {r['peak_gb']['eager']:.2f} -> {r['peak_gb']['graph']:.2f} GiB")


def family_lockstep(cfg, crop, what: str, per_step: int) -> dict:
    """`graph_lockstep` of a family at full width, B = data.batch x
    data.n_signal: FAMILY_PREWARMUP pre-warmup steps and FAMILY_CYCLES cycles
    of a critic step every FAMILY_DIS_EVERY steps, each program warmed up,
    captured and replayed at a later step, one more replay of each traced;
    printed as a `graphs` line."""
    import torch

    cfg = copy.deepcopy(cfg)
    cfg.train.update_discriminator_every = FAMILY_DIS_EVERY
    x = torch.randn(cfg.data.batch, 1, cfg.data.n_signal, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
    r = graph_lockstep(cfg, crop, x, FAMILY_PREWARMUP, FAMILY_CYCLES, f"{what} graphed steps",
                       per_step=per_step)
    print(f"graphs: {what} training steps B={cfg.data.batch} x {cfg.data.n_signal} through "
          f"TrainGraphs: {lockstep_summary(r)}", flush=True)
    return r


def graph_launches(train_graph: dict, modes, column: int) -> int:
    """The unit's launches of one kind (a `LoopProbe.counts()` column) that
    a replay of each program of phase `train_graph`'s `modes` runs, counted
    in the graphs' kernel nodes (`graph_node_launches`; the traced replays'
    counts are printed beside them)."""
    return sum(v[column] for m in modes for v in train_graph[m]["graph_launches"].values())


def phase_train_graph(crop) -> dict:
    """v2's three programs as CUDA graphs against the eager steps; see the module docstring."""
    import torch

    from rave_tpu_torch.config import compose

    t_phase = time.perf_counter()
    out = {}
    for mode, overrides in TRAIN_GRAPH_MODES.items():
        cfg = compose(["v2"], overrides)
        x = torch.randn(cfg.data.batch, 1, cfg.data.n_signal, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
        r = out[mode] = graph_lockstep(cfg, crop, x, TRAIN_GRAPH_PREWARMUP, TRAIN_GRAPH_CYCLES,
                                       f"train_graph v2 {mode}", per_step=22,
                                       busy=mode != "remat")
        busy = "; ".join(
            f"{run} {p} {b['wall_ms']:.1f} ms busy "
            + ("not measured" if b["busy_ms"] is None else
               f"{b['busy_ms']:.1f} ({100 * b['busy_share']:.0f}%)")
            for run, by in r["busy"].items() for p, b in sorted(by.items()))
        print(f"train_graph: v2 {mode} B={cfg.data.batch} x {cfg.data.n_signal}, "
              f"{lockstep_summary(r)}" + (f"; one more step each: {busy}" if busy else ""),
              flush=True)
        del x
    for mode in ("fp32", "bf16"):
        e, g = out[mode]["eager_ms"]["gen_prewarmup"], out[mode]["graph_ms"]["gen_prewarmup"]
        check(g is not None and e is not None and g < e,
              f"train_graph v2 {mode}: the graphed pre-warmup step takes {g} ms, the eager "
              f"{e} ms")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"train_graph: {out['seconds']:.1f} s", flush=True)
    return out


def write_corpus(folder: Path, seed: int = 11) -> None:
    """LOOP_FILES seeded .wav files of tones, chirps, noise and their mix,
    LOOP_RECORDS records of N_SIGNAL samples in all."""
    import numpy as np
    from scipy.io import wavfile

    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    n = LOOP_RECORDS // LOOP_FILES * N_SIGNAL
    t = np.arange(n) / SAMPLE_RATE
    f0 = rng.uniform(80, 800, size=3)
    tone = sum(0.2 * np.sin(2 * np.pi * f * (1 + k) * t) / (1 + k) for k, f in enumerate(f0))
    chirp = 0.4 * np.sin(2 * np.pi * (60 + 40 * t) * t)
    noise = 0.15 * rng.standard_normal(n)
    for name, x in (("tones", tone), ("chirp", chirp), ("noise", noise),
                    ("mix", 0.5 * (tone + chirp) + 0.5 * noise)):
        wavfile.write(folder / f"{name}.wav", SAMPLE_RATE,
                      (np.clip(x, -1, 1) * 32767).astype(np.int16))


class LoopProbe:
    """Observes the training driver in process: its receptive-field probe,
    each step, validation, checkpoint save and restore end in a synchronize
    and record their wall time and their kernel launches of each variant; a
    restore also keeps a host copy of the state it restored. The launch
    counts are read, never reset, so the phase's totals stay those of the
    main path."""

    NAMES = ("receptive_field", "train_steps", "run_validation", "save_checkpoint",
             "restore_checkpoint")

    def __init__(self):
        from rave_tpu_torch.train import loop

        self.loop, self.events, self.keep_x_at = loop, [], None
        self.saved = {name: getattr(loop, name) for name in self.NAMES}

    def __enter__(self):
        loop = self.loop
        loop.receptive_field = self.observe("receptive_field", self.saved["receptive_field"])
        loop.run_validation = self.observe("validation", self.saved["run_validation"])
        loop.save_checkpoint = self.observe("save", self.saved["save_checkpoint"])
        loop.restore_checkpoint = self.observe("restore", self.saved["restore_checkpoint"])
        loop.train_steps = lambda *a, **k: {
            which: self.observe("step", fn, which)
            for which, fn in self.saved["train_steps"](*a, **k).items()}
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.loop, name, fn)

    @staticmethod
    def counts():
        """Launches of the forward kernel (fp32, bf16), then of the gradient's."""
        from rave_tpu_torch.ops.kernels import dilated_unit as du

        return (du.launches - du.launches_bf16, du.launches_bf16,
                du.launches_backward - du.launches_backward_bf16, du.launches_backward_bf16)

    def observe(self, kind: str, fn, which: str = ""):
        import torch

        from rave_tpu_torch.train import graphs as train_graphs

        def call(*args, **kwargs):
            torch.cuda.synchronize()
            graphs = train_graphs.captures, train_graphs.replays
            before, t0 = self.counts(), time.perf_counter()
            step = args[0].step if kind == "step" else None
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            after = self.counts()
            event = {"kind": kind, "start": t0, "end": t1, "ms": (t1 - t0) * 1e3,
                     **{k: a - b for k, a, b in zip(("fp32", "bf16", "bwd_fp32", "bwd_bf16"),
                                                    after, before)}}
            if kind == "step":
                event["step"] = step
                # a replay of a graph captured at an earlier step (not a warm-up or capture)
                event["replayed"] = (train_graphs.captures, train_graphs.replays) == (
                    graphs[0], graphs[1] + 1)
                event["phase"] = ("dis" if which == "dis" else
                                  "gen_adversarial" if args[2] else "gen_prewarmup")
                event["finite"] = all(math.isfinite(float(v)) for v in out.values())
                if step == self.keep_x_at:
                    event["x"] = args[1].clone()
            elif kind == "validation":
                event["batches"] = len(args[2])
                event["value"] = out[0]
            elif kind == "save":
                event["step"], event["mb"] = args[1].step, out.stat().st_size / 2**20
            elif kind == "restore" and out is not None:
                st = args[1]
                event["path"], event["state"] = out, host_copy({
                    "step": st.step, "model": st.model.state_dict(),
                    "discriminator": st.discriminator.state_dict(),
                    "gen_opt": st.gen_opt.state_dict(), "dis_opt": st.dis_opt.state_dict(),
                    "ema": st.ema})
            self.events.append(event)
            return out

        return call

    def take(self) -> list:
        events, self.events = self.events, []
        return events


@contextlib.contextmanager
def threaded_loader():
    """The training driver's host batches from the threaded `Loader` where its
    rule would take the C++ sampler, for the run inside."""
    from rave_tpu_torch.train import loop

    rule = loop.input_pipeline
    loop.input_pipeline = lambda *a, **k: "threads" if rule(*a, **k) == "native" else rule(*a, **k)
    try:
        yield
    finally:
        loop.input_pipeline = rule


def loop_ms(events) -> dict:
    """Mean loop ms per step by phase: from the end of one step to the end of
    the next (the loop's own work, data and logging included), over the steps
    that replay a graph captured at an earlier step and follow a step of the
    same run with no validation or save between (a key's warm-up and
    capturing steps pay one-time costs); and the bare step calls' mean over
    the same steps. A phase with no such step is left out."""
    loop_times, bare = {}, {}
    for prev, ev in zip(events, events[1:]):
        if ev["kind"] == "step" and ev["replayed"] and prev["kind"] == "step":
            loop_times.setdefault(ev["phase"], []).append((ev["end"] - prev["end"]) * 1e3)
            bare.setdefault(ev["phase"], []).append(ev["ms"])
    return {k: {"loop_ms": statistics.mean(v), "step_ms": statistics.mean(bare[k]), "n": len(v)}
            for k, v in loop_times.items()}


def host_copy(tree):
    """A copy of a nest of dicts, lists and tensors, its tensors cloned to the host."""
    import torch

    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


def unequal(a, b, path: str = "") -> list:
    """Paths where two nests of dicts, lists and tensors differ in any bit."""
    import torch

    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{path} keys"]
        return [p for k in a for p in unequal(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in unequal(x, y, f"{path}[{i}]")]
    if torch.is_tensor(a):
        return [] if a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()) else [path]
    return [] if a == b else [path]


def _cli(args) -> str:
    """Run a command of the port's CLI in this process; its standard output."""
    from rave_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main([str(a) for a in args])
    check(code == 0, f"cli {args[0]} exited {code}: {out.getvalue()[-2000:]}")
    return out.getvalue()


def _check_steps(events, kind: str, first: int, last: int, probe: bool = True,
                 per_step: int = 22) -> None:
    """The run took steps first..last-1, each that ran Python (eager, or a
    graph's warm-up or capture) launching `per_step` units of its variant
    (22; 0 for v3, whose Snake units bypass the kernel) and `bwd_per_step` of
    the gradient kernel, each replay of a graph none (it runs no Python;
    phase `train_graph` counts a replay's kernels in the card's trace), and
    finite; each validation batch and the probe's forwards as many units, the
    probe as many gradients and validation none."""
    steps = [e for e in events if e["kind"] == "step"]
    check([e["step"] for e in steps] == list(range(first, last)),
          f"{kind} run took steps {[e['step'] for e in steps]}, expected {first}..{last - 1}")
    other = "fp32" if kind == "bf16" else "bf16"
    for e in steps:
        want = 0 if e["replayed"] else per_step
        want_bwd = 0 if e["replayed"] else bwd_per_step(e["phase"], per_step)
        check(e[kind] == want and e[other] == 0,
              f"{kind} run, step {e['step']} ({e['phase']}, replayed {e['replayed']}): "
              f"{e['fp32']} fp32 and {e['bf16']} bf16 launches, expected {want} {kind}")
        check(e[f"bwd_{kind}"] == want_bwd and e[f"bwd_{other}"] == 0,
              f"{kind} run, step {e['step']} ({e['phase']}): {e['bwd_fp32']} fp32 and "
              f"{e['bwd_bf16']} bf16 gradient kernel launches, expected {want_bwd} {kind}")
        check(e["finite"], f"{kind} run, step {e['step']}: non-finite metrics")
    for e in events:
        if e["kind"] == "validation":
            check(e["fp32"] == per_step * e["batches"] and e["bf16"] == 0
                  and e["bwd_fp32"] == e["bwd_bf16"] == 0,
                  f"validation over {e['batches']} batches: {e['fp32']} fp32 / {e['bf16']} bf16 "
                  f"launches, {e['bwd_fp32'] + e['bwd_bf16']} of the gradient kernel")
            check(math.isfinite(e["value"]), f"validation value {e['value']}")
        if e["kind"] == "receptive_field":  # no probe runs for the discrete family: (0, 0)
            # the probe's gradient of one output sample by the input: one backward per unit
            check((e["fp32"] > 0) == (probe and per_step > 0) and e["fp32"] % 22 == 0
                  and e["bf16"] == 0 and e["bwd_fp32"] == e["fp32"] and e["bwd_bf16"] == 0,
                  f"receptive-field probe: {e['fp32']} fp32, {e['bf16']} bf16 launches, "
                  f"{e['bwd_fp32']} / {e['bwd_bf16']} of the gradient kernel")


def phase_loop(train_ms: dict, train_bf16_ms: dict) -> dict:
    import torch

    from rave_tpu_torch import config as config_lib
    from rave_tpu_torch.data.dataset import get_dataset, split_dataset
    from rave_tpu_torch.data.device_data import DeviceDataPipeline
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train import graphs as train_graphs
    from rave_tpu_torch.train.loop import device_batches
    from rave_tpu_torch.utils import checkpoint

    work = ROOT / "build" / "loop"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    write_corpus(work / "corpus")
    db, runs = work / "db", work / "runs"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _cli(["preprocess", "--input_path", work / "corpus", "--output_path", db,
          "--num_signal", N_SIGNAL, "--sampling_rate", SAMPLE_RATE])
    common = ["--config", "v2", "--db_path", db, "--out_path", runs, "--batch", TRAIN_BATCH,
              "--n_signal", N_SIGNAL, "--device", "cuda"]
    for o in LOOP_SCHEDULE:
        common += ["--override", o]
    graphs0 = train_graphs.captures, train_graphs.replays
    with LoopProbe() as probe:
        # fp32 with the device-resident dataset, then a resume with more steps
        out = _cli(["train", "--name", "loop", "--max_steps", LOOP_STEPS, "--val_every",
                    LOOP_VAL_EVERY, "--save_every", LOOP_SAVE_EVERY, "--device_data", "on",
                    *common])
        run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
        first = probe.take()
        probe.keep_x_at = LOOP_STEPS
        out2 = _cli(["train", "--name", "loop", "--max_steps", LOOP_RESUME_STEPS, "--val_every",
                     LOOP_VAL_EVERY, "--save_every", LOOP_SAVE_EVERY, "--device_data", "on",
                     *common])
        resumed = probe.take()
        probe.keep_x_at = None
        # bf16 through the threaded host loader and the pinned, non-blocking prefetch
        # (the loop's rule takes the C++ sampler here: phase native runs that)
        with threaded_loader():
            out3 = _cli(["train", "--name", "loop_bf16", "--bf16", "--max_steps",
                         LOOP_BF16_STEPS, "--val_every", 1000, "--save_every", 1000,
                         "--device_data", "off", "--no_resume", *common, "--override",
                         f"train.phase_1_duration={LOOP_BF16_WARMUP}"])
        run_bf16 = Path(out3.strip().splitlines()[-1].removeprefix("run dir: "))
        bf16_events = probe.take()
    graphed = (train_graphs.captures - graphs0[0], train_graphs.replays - graphs0[1])
    for o in (out, out2, out3):  # each run captures its graphs, the resumed one after its restore
        check(GRAPHED_STEPS in o, f"cli train did not graph its steps: {o[-1500:]}")
    check(graphed[0] >= 3 and graphed[1] > 0, f"loop runs: {graphed[0]} graphs captured, "
                                              f"{graphed[1]} replays")
    evals = []
    for ema in (False, False, True):
        before = LoopProbe.counts()
        ev = json.loads(_cli(["eval", "--run", run_dir, "--db_path", db, "--split", "val",
                              "--device", "cuda", *(["--ema_weights"] if ema else [])]
                             ).strip().splitlines()[-1])
        ev["fp32"], ev["bf16"], ev["bwd_fp32"], ev["bwd_bf16"] = (
            a - b for a, b in zip(LoopProbe.counts(), before))
        evals.append(ev)
    torch.cuda.synchronize()
    launches = {"fp32": dilated_unit.launches - dilated_unit.launches_bf16,
                "bf16": dilated_unit.launches_bf16,
                "bwd_fp32": dilated_unit.launches_backward - dilated_unit.launches_backward_bf16,
                "bwd_bf16": dilated_unit.launches_backward_bf16}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # the runs: launches, steps, files, checkpoints, PCA
    _check_steps(first, "fp32", 0, LOOP_STEPS)
    _check_steps(resumed, "fp32", LOOP_STEPS, LOOP_RESUME_STEPS)
    _check_steps(bf16_events, "bf16", 0, LOOP_BF16_STEPS)
    check("using the threaded host loader" in out3, "bf16 run did not use the Loader")
    check([checkpoint.checkpoint_step(p) for p in checkpoint.list_checkpoints(str(run_bf16))]
          == [LOOP_BF16_STEPS], "the bf16 run's final checkpoint")
    check(f"resumed at step {LOOP_STEPS}" in out2, "the second run did not resume")
    for events in (first, bf16_events):
        phases = {e["phase"] for e in events if e["kind"] == "step"}
        check(phases == {"gen_prewarmup", "gen_adversarial", "dis"}, f"phases run: {phases}")
    cfg = config_lib.from_dict(json.loads((run_dir / "config.json").read_text()))
    warmup = cfg.train.phase_1_duration
    check(sum(e["kind"] == "validation" for e in first) == 2, "validations of the first run")
    vals = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    check([r["step"] for r in vals if "validation" in r]
          == [LOOP_VAL_EVERY, LOOP_STEPS, LOOP_RESUME_STEPS], f"validation rows {vals}")
    check({r["step"] for r in vals if "loss_gen" in r} >= {1, 2}, "no loss rows at steps 1, 2")
    check(all(math.isfinite(v) for r in vals for v in r.values()), "non-finite metrics row")
    check((run_dir / "status.json").is_file(), "no status.json")
    ckpts = [checkpoint.checkpoint_step(p) for p in checkpoint.list_checkpoints(str(run_dir))]
    check(ckpts == [LOOP_VAL_EVERY, LOOP_SAVE_EVERY, LOOP_STEPS, LOOP_RESUME_STEPS],
          f"checkpoints at {ckpts}")
    ckpt_pre = torch.load(checkpoint.latest_checkpoint(str(run_dir), LOOP_VAL_EVERY),
                          map_location="cpu", weights_only=True)["model"]
    check(LOOP_VAL_EVERY <= warmup and bool(ckpt_pre["fidelity"].gt(0).all())
          and not torch.equal(ckpt_pre["latent_pca"], torch.eye(cfg.latent_size)),
          "the pre-warmup validation left the PCA buffers unset")
    final = torch.load(checkpoint.latest_checkpoint(str(run_dir)), map_location="cpu",
                       weights_only=True)
    check(all(torch.equal(final["model"][k], ckpt_pre[k])
              for k in ("latent_pca", "latent_mean", "fidelity")),
          "the PCA buffers moved after the warmup")

    # resume: the state the second run restored, EMA included, bit-equal to its
    # checkpoint; the schedule continued
    restores = [e for e in first + resumed if e["kind"] == "restore" and "state" in e]
    check(len(restores) == 1 and restores[0] in resumed
          and checkpoint.checkpoint_step(restores[0]["path"]) == LOOP_STEPS,
          f"restores: {[(e['path'], e in resumed) for e in restores]}")
    restored = restores[0]["state"]
    saved = torch.load(restores[0]["path"], map_location="cpu", weights_only=True)
    bad = unequal(restored, saved)
    check(not bad and restored["step"] == LOOP_STEPS and restored["ema"] is not None,
          f"restore not bit-equal: {bad[:5]}")
    dataset = get_dataset(str(db), cfg.sampling_rate, N_SIGNAL)
    train_idx, _ = split_dataset(dataset)
    pipeline = DeviceDataPipeline(str(db), train_idx, TRAIN_BATCH, N_SIGNAL, SAMPLE_RATE,
                                  device="cuda")
    unbroken = device_batches(pipeline, 0)
    for _ in range(LOOP_STEPS + 1):  # the batches of steps 0 .. LOOP_STEPS
        x_unbroken = next(unbroken)
    x_resumed = next(e["x"] for e in resumed if e.get("x") is not None)
    check(torch.equal(x_resumed, x_unbroken),
          f"the resumed run's batch at step {LOOP_STEPS} is not the unbroken pipeline's")
    batch_ms = cuda_ms(lambda: pipeline.batch_at(LOOP_STEPS), 20)

    # eval: finite, repeatable, 22 fp32 launches per batch
    for k in EVAL_METRICS:
        check(all(math.isfinite(ev[k]) for ev in evals), f"eval {k} not finite")
    check(evals[0] == evals[1], f"eval differs between calls: {evals[:2]}")
    check(evals[2]["ema"] and evals[2]["spectral_distance"] != evals[0]["spectral_distance"],
          f"eval --ema_weights: {evals[2]}")
    for ev in evals:
        check(ev["n_clips"] == LOOP_VAL_BATCH, f"eval over {ev['n_clips']} clips")
        check(ev["fp32"] == 22 * ev["n_batches"] and ev["bf16"] == 0
              and ev["bwd_fp32"] == ev["bwd_bf16"] == 0,
              f"eval launches {ev['fp32']} fp32, {ev['bf16']} bf16, "
              f"{ev['bwd_fp32'] + ev['bwd_bf16']} of the gradient kernel")
    accounted = sum(e["fp32"] for e in first + resumed + bf16_events) + sum(
        ev["fp32"] for ev in evals)
    check(launches["fp32"] == accounted and
          launches["bf16"] == sum(e["bf16"] for e in bf16_events) and
          all(launches[k] == sum(e[k] for e in first + resumed + bf16_events)
              for k in ("bwd_fp32", "bwd_bf16")),
          f"launches {launches} not all in the probe, the steps, validation and eval")

    saves = [e for e in first + resumed + bf16_events if e["kind"] == "save"]
    timing = {"fp32": loop_ms(first + resumed), "bf16": loop_ms(bf16_events)}
    out = {"records": LOOP_RECORDS, "run_dir": str(run_dir.relative_to(ROOT)),
           "checkpoints": ckpts, "launches": launches, "peak_gb": peak_gb,
           "graph_captures": graphed[0], "graph_replays": graphed[1],
           "loop_ms": timing, "bare_step_ms": {"fp32": train_ms, "bf16": train_bf16_ms},
           "device_batch_ms": batch_ms, "save_s": [e["ms"] / 1e3 for e in saves],
           "checkpoint_mb": [e["mb"] for e in saves], "eval": evals[0],
           "eval_ema": evals[2],
           "validation_ms": [e["ms"] for e in first + resumed if e["kind"] == "validation"],
           "probe_ms": [e["ms"] for e in first + resumed + bf16_events
                        if e["kind"] == "receptive_field"],
           "validation": [r["validation"] for r in vals if "validation" in r],
           "seconds": time.perf_counter() - t0}
    summary = "; ".join(f"{kind} {ph} {v['loop_ms']:.1f} (step {v['step_ms']:.1f}, x{v['n']}; "
                        f"phase train {out['bare_step_ms'][kind].get(ph, float('nan')):.1f})"
                        for kind, t in timing.items() for ph, v in sorted(t.items()))
    print(f"loop: cli preprocess {LOOP_RECORDS} records -> train v2 B={TRAIN_BATCH} x {N_SIGNAL} "
          f"steps 0..{LOOP_STEPS - 1} (device data), resumed to {LOOP_RESUME_STEPS}, bf16 "
          f"{LOOP_BF16_STEPS} steps (host loader) -> eval x2; steps as CUDA graphs "
          f"({graphed[0]} captured, {graphed[1]} replays); 22 launches per step that runs "
          f"Python (none in a replay) and per "
          f"validation/eval batch, {launches['fp32']} fp32 + {launches['bf16']} bf16 in all; "
          f"checkpoints {ckpts}; restore bit-equal (EMA included); validation {out['validation']}; eval "
          + ", ".join(f"{k} {evals[0][k]}" for k in EVAL_METRICS)
          + "; with --ema_weights " + ", ".join(f"{k} {evals[2][k]}" for k in EVAL_METRICS),
          flush=True)
    print(f"loop times: ms per step, loop (bare step call; phase train's bare step): {summary}; "
          f"device-data batch {batch_ms:.3f} ms (device); checkpoint save "
          f"{', '.join(f'{s:.2f}' for s in out['save_s'])} s of "
          f"{', '.join(f'{mb:.1f}' for mb in out['checkpoint_mb'])} MiB; validation "
          f"{', '.join(f'{ms:.1f}' for ms in out['validation_ms'])} ms; receptive-field probe "
          f"{', '.join(f'{ms:.0f}' for ms in out['probe_ms'])} ms; "
          f"peak {peak_gb:.2f} GiB; phase {out['seconds']:.1f} s", flush=True)
    return out


def write_signal(path: Path, seconds: float, seed: int) -> int:
    """A seeded mono .wav of tones, a chirp and noise; its length in samples."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    n = int(round(seconds * SAMPLE_RATE))
    t = np.arange(n) / SAMPLE_RATE
    f0 = rng.uniform(80, 800, size=3)
    x = sum(0.15 * np.sin(2 * np.pi * f * (1 + k) * t) / (1 + k) for k, f in enumerate(f0))
    x = x + 0.2 * np.sin(2 * np.pi * (60 + 30 * t) * t) + 0.05 * rng.standard_normal(n)
    wavfile.write(path, SAMPLE_RATE, (np.clip(x, -1, 1) * 32767).astype(np.int16))
    return n


# ---- the served streaming steps: CUDA graphs beside their eager twins ---------------------

def reset_graph_counts() -> None:
    from rave_tpu_torch.nn import graphs

    graphs.captures = graphs.replays = 0


def graphs_line(phase: str, p50s: dict, budgets: dict) -> dict:
    """Print phase `phase`'s `graphs` line: the CUDA graphs captured and
    replayed since `reset_graph_counts`, and per family the p50 ms of each
    path (`graph`: the public method or `graphed_stream`; `program`: the
    `.pt2` through `StepGraphs`; `eager` / `program_eager`: called directly)
    against its block's budget; returns them."""
    from rave_tpu_torch.nn import graphs

    out = {"captured": graphs.captures, "replays": graphs.replays, "p50_ms": p50s,
           "budget_ms": budgets}
    print(f"graphs: {phase}: {graphs.captures} graphs captured, {graphs.replays} replays; p50 "
          + "; ".join(f"{k} " + ", ".join(f"{path} {ms:.3f}" for path, ms in v.items())
                      + f" ms (budget {budgets[k]:.2f})" for k, v in p50s.items()), flush=True)
    return out


def timed_call(fn, *args, **kwargs):
    """(fn's result, host ms), the call ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def states_equal(a, b) -> bool:
    return all(torch_equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


def torch_equal(x, y) -> bool:
    import torch

    return x.shape == y.shape and bool(torch.equal(x, y))


class Lockstep:
    """An artifact's served streaming forward (its public method: a CUDA graph
    replay) beside its eager twin (`stream_steps["forward"]`, the step program
    and the resampler called directly on a copy of the stream state) and,
    with `program`, its `forward_step.pt2` called directly and through
    `StepGraphs`, each on its own state. Every block of every path is timed
    by the host clock, ending in a synchronize; the served outputs and state
    are compared with the eager twin's, the program's with the served ones
    (its state's relative errors over `state_floor`) and the program's served
    ones with its direct ones. `reset_stream` and `attribute` change every
    path's state as the artifact changes its own."""

    def __init__(self, art, program=None, state_floor: float = 1e-6):
        from rave_tpu_torch.nn.graphs import StepGraphs

        self.art, self.program, self.state_floor = art, program, state_floor
        self.eager = [t.clone() for t in art.stream_state]
        if program is not None:
            self.direct = [t.clone() for t in art.state]
            self.served = StepGraphs(program, [t.clone() for t in art.state], art.graph_pool)
        self.ms = {"graph": [], "eager": []}
        if program is not None:
            self.ms.update(program=[], program_eager=[])
        self.blocks, self.graph_equal, self.graph_err = 0, True, 0.0
        self.program_y_err = self.program_state_err = 0.0
        self.program_equal = self.program_graph_equal = True

    def _states(self) -> list:
        return [self.eager] + ([self.direct, self.served.state] if self.program else [])

    def reset_stream(self) -> None:
        self.art.reset_stream()
        adain = set(self.art.adain_indices)
        for state in self._states():
            for i, t in enumerate(state):
                if i not in adain:
                    t.zero_()

    def attribute(self, name: str, *args) -> None:
        """The artifact's AdaIN setter `name`, then its AdaIN state into every path's."""
        getattr(self.art, name)(*args)
        for i in self.art.adain_indices:
            for state in self._states():
                state[i].copy_(self.art.stream_state[i])

    def block(self, xb, seed: int):
        import torch

        from rave_tpu_torch.train.loop import fp32_exact

        art, n = self.art, len(self.art.slots)
        y_g, ms = timed_call(art.forward, xb, streaming=True, seed=seed)
        self.ms["graph"].append(ms)
        s = torch.full((), seed, dtype=torch.int64, device=xb.device)
        with torch.no_grad(), fp32_exact():
            (y_e, self.eager), ms = timed_call(art.stream_steps["forward"], self.eager, xb, s)
            self.ms["eager"].append(ms)
            if self.program is not None:
                (y_p, self.direct), ms = timed_call(self.program, self.direct, xb, s)
                self.ms["program_eager"].append(ms)
                y_pg, ms = timed_call(self.served, xb, seed)
                self.ms["program"].append(ms)
        equal = torch_equal(y_g, y_e) and states_equal(art.stream_state, self.eager)
        if not equal:
            self.graph_err = max([self.graph_err, rel_err(y_g, y_e)] + [
                rel_err(a, b, 1e-6) for a, b in zip(art.stream_state, self.eager)])
        self.graph_equal = self.graph_equal and equal
        if self.program is not None:
            self.program_y_err = max(self.program_y_err, rel_err(y_p, y_g))
            self.program_state_err = max([self.program_state_err] + [
                rel_err(a, b, self.state_floor) for a, b in zip(self.direct, art.state)])
            self.program_equal = (self.program_equal and torch_equal(y_p, y_g)
                                  and states_equal(self.direct, art.stream_state[:n]))
            self.program_graph_equal = (self.program_graph_equal and torch_equal(y_pg, y_p)
                                        and states_equal(self.served.state, self.direct))
        self.blocks += 1
        return y_g

    def p50(self) -> dict:
        return {k: statistics.median(v) for k, v in self.ms.items()}

    def summary(self) -> dict:
        out = {"blocks": self.blocks, "graph_bit_equal": self.graph_equal,
               "graph_max_rel_err": self.graph_err, "p50_ms": self.p50()}
        if self.program is not None:
            out.update(program_y_err=self.program_y_err,
                       program_state_err=self.program_state_err,
                       program_bit_equal=self.program_equal,
                       program_graph_bit_equal=self.program_graph_equal)
        return out


def run_lockstep(art, x, seed0: int, program=None, blocks: int = PROGRAM_BLOCKS,
                 attributes=None, state_floor: float = 1e-6) -> Lockstep:
    """`blocks` blocks of `x` through a `Lockstep` from a fresh stream, a
    `reset_stream` after half of them, and the artifact's AdaIN `attributes`
    ({block: [(name, *args)]}) before the blocks they name."""
    lock = Lockstep(art, program, state_floor)
    lock.reset_stream()
    B = art.block_size
    check(x.shape[-1] >= blocks * B, f"{x.shape[-1]} samples for {blocks} blocks of {B}")
    for i in range(blocks):
        if i == blocks // 2:
            lock.reset_stream()
        for name, *args in (attributes or {}).get(i, []):
            lock.attribute(name, *args)
        lock.block(x[..., i * B:(i + 1) * B], seed0 + i)
    return lock


def check_served(what: str, lock, budget: float) -> dict:
    """The served path's checks: the graph's outputs and state bit-equal to
    the eager twin's over every block; its p50, and the `.pt2` served through
    `StepGraphs` (bit-equal to the `.pt2` called directly), under the budget."""
    s = lock.summary()
    check(lock.blocks >= PROGRAM_BLOCKS, f"{what}: {lock.blocks} blocks served")
    check(s["graph_bit_equal"], f"{what}: the served graph is not bit-equal to the eager "
                                f"steps over {lock.blocks} blocks ({s['graph_max_rel_err']:.3e})")
    gated = {k: v for k, v in s["p50_ms"].items() if k in ("graph", "program")}
    check(max(gated.values()) < budget, f"{what}: served streaming p50 {gated} over the "
                                        f"{budget:.2f} ms budget")
    if "program_graph_bit_equal" in s:
        check(s["program_graph_bit_equal"], f"{what}: the .pt2 served through StepGraphs is not "
                                            f"bit-equal to the .pt2 called directly")
    return s


def model_lockstep(model, cfg, xs, blocks: int, uniforms=None) -> dict:
    """The model's step pair served by `graphed_stream` (a CUDA graph per
    block shape) beside an eager twin (a copy of the model, its `step_encode`
    and `step_decode` called directly), `blocks` blocks of `xs` from a fresh
    stream with `init_stream_state` after half of them: each timed by the
    host clock; outputs and both models' stream buffers compared."""
    import torch

    from rave_tpu_torch.export.artifact import graphed_stream, stream_slots
    from rave_tpu_torch.nn.streaming import init_stream_state

    D, block = cfg.latent_size, cfg.block_size()
    with torch.no_grad():
        twin = copy.deepcopy(model)
        served = graphed_stream(model, D)
        ms, equal, err = {"graph": [], "eager": []}, True, 0.0
        for i in range(blocks):
            if i in (0, blocks // 2):
                init_stream_state(model, 1)
                init_stream_state(twin, 1)
            xb, u = xs[..., i * block:(i + 1) * block], uniforms[i] if uniforms else None
            (z, y), t = timed_call(served, xb, u)
            ms["graph"].append(t)

            def eager():
                z_e = twin.step_encode(xb)
                return z_e, twin.step_decode(z_e[:, :D], u)

            (z_e, y_e), t = timed_call(eager)
            ms["eager"].append(t)
            mine = [getattr(m, a) for _, m, a in stream_slots(model)]
            theirs = [getattr(m, a) for _, m, a in stream_slots(twin)]
            same = torch_equal(z, z_e) and torch_equal(y, y_e) and states_equal(mine, theirs)
            if not same:
                err = max([err, rel_err(z, z_e), rel_err(y, y_e)]
                          + [rel_err(a, b, 1e-6) for a, b in zip(mine, theirs)])
            equal = equal and same
    return {"blocks": blocks, "graph_bit_equal": equal, "graph_max_rel_err": err,
            "p50_ms": {k: statistics.median(v) for k, v in ms.items()},
            "graphs": len(served.graphs)}


def phase_export(run_dir: Path) -> dict:
    import numpy as np
    import torch
    from scipy.io import wavfile

    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.utils import checkpoint
    from rave_tpu_torch.utils.rng import normal_from_seed

    work = ROOT / "build" / "loop"
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # 1. the loop's run exported twice through the CLI
    arts = {}
    for key, flags in (("streaming_ema", ["--streaming", "--ema_weights"]),
                       ("stereo_88200", ["--stereo", "--sr", 2 * SAMPLE_RATE])):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        text = _cli(["export", "--run", run_dir, "--output", work / "export" / key,
                     "--device", "cuda", *flags])
        torch.cuda.synchronize()
        path = Path(text.strip().splitlines()[-1].removeprefix("exported: "))
        arts[key] = {"path": path, "seconds": time.perf_counter() - t0,
                     "mib": sum(f.stat().st_size for f in path.iterdir()) / 2**20,
                     "launches": dilated_unit.launches,
                     "manifest": json.loads((path / "manifest.json").read_text())}
    cfg = json.loads((run_dir / "config.json").read_text())
    fid = torch.load(checkpoint.latest_checkpoint(str(run_dir)), map_location="cpu",
                     weights_only=True)["model"]["fidelity"].numpy()
    D, ratio = cfg["latent_size"], 2048  # v2: 16 bands x 4 x 4 x 4 x 2
    k = max(int(np.argmax(fid > 0.95)), 1)
    latent = min(2 ** math.ceil(math.log2(k)), D)
    for key, a in arts.items():
        m, stereo = a["manifest"], key.startswith("stereo")
        check(m["format"] == "rtpu-torch-v1" and m["latent_size"] == latent
              and m["full_latent_size"] == D, f"{key}: latent {m['latent_size']} of "
              f"{m['full_latent_size']}, expected {latent} of {D} from fidelity {fid.tolist()}")
        check((m["methods"]["encode"]["out_ratio"], m["methods"]["decode"]["in_ratio"],
               m["methods"]["forward"]["out_ratio"], m["block_size"]) == (ratio, ratio, 1, ratio),
              f"{key}: ratios {m['methods']}")
        lat = m["latency"]
        check(lat["encode_latent_frames"] > 0 and lat["decode_samples"] > 0 and
              lat["total_samples"] == lat["encode_latent_frames"] * ratio + lat["decode_samples"],
              f"{key}: latency {lat}")
        check((m["stream_batch"], m["target_sampling_rate"], m["streaming"])
              == ((2, 2 * SAMPLE_RATE, False) if stereo else (1, SAMPLE_RATE, True)),
              f"{key}: stream batch {m['stream_batch']}, rate {m['target_sampling_rate']}")
        check(all(e["device"].startswith("cuda") for e in m["aot"].values()), f"{key}: aot")
    latencies = [a["manifest"]["latency"] for a in arts.values()]
    check(latencies[0] == latencies[1], f"the two artifacts' latencies differ: {latencies}")

    # 2. generate through the CLI on a 30 s file (ragged against the block)
    art_path = arts["streaming_ema"]["path"]
    wav = work / "generate_in.wav"
    n = write_signal(wav, EXPORT_SECONDS, seed=21)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    _cli(["generate", "--model", art_path, "--input", wav, "--out_path", work / "generated",
          "--seed", GENERATE_SEED, "--device", "cuda"])
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = dilated_unit.launches
    check(launches == 22 and dilated_unit.launches_bf16 == 0,
          f"generate: {launches} launches ({dilated_unit.launches_bf16} bf16), expected 22 fp32")
    art = ExportedRAVE(str(art_path), device="cuda", seed=GENERATE_SEED)
    x = load_signal(decode_file(str(wav), SAMPLE_RATE, 1), 1, 1, art.block_size).cuda()
    y = art.forward(x)[0, 0, :n].clamp(-1, 1).cpu().numpy()
    sr, written = wavfile.read(work / "generated" / "generate_in_reconstructed.wav")
    wav_err = float(np.abs(written / 32767 - y).max())
    check(sr == SAMPLE_RATE and written.shape == (n,) and np.isfinite(y).all()
          and wav_err <= 1 / 32767 + 1e-7,
          f"generated wav ({sr} Hz, {written.shape}) {wav_err:.3e} from the artifact's forward")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        art.forward(x)
    torch.cuda.synchronize()
    forward_s = (time.perf_counter() - t0) / 3

    # 3. the card against the CPU (plain unit), same artifact and seeds
    clip = x[..., : -(-int(CLIP_SECONDS * SAMPLE_RATE) // art.block_size) * art.block_size]
    cpu = ExportedRAVE(str(art_path), device="cpu")
    y_gpu, y_cpu = art.forward(clip, seed=7).cpu(), cpu.forward(clip.cpu(), seed=7)
    offline_err = rel_err(y_gpu, y_cpu)
    art.reset_stream()
    B = art.block_size
    outs = [(art.forward(clip[..., i * B:(i + 1) * B], streaming=True, seed=50 + i).cpu(),
             cpu.forward(clip[..., i * B:(i + 1) * B].cpu(), streaming=True, seed=50 + i))
            for i in range(CPU_STREAM_BLOCKS)]
    stream_err = rel_err(torch.cat([a for a, _ in outs], -1), torch.cat([b for _, b in outs], -1))
    # the stereo artifact (two rows, resampled at both ends) likewise, and the
    # seeded draws themselves
    st_path = arts["stereo_88200"]["path"]
    st_gpu, st_cpu = ExportedRAVE(str(st_path), device="cuda"), ExportedRAVE(str(st_path), "cpu")
    xs = torch.randn(2, 1, 4 * st_gpu.block_size, generator=torch.Generator().manual_seed(8))
    ys_gpu = st_gpu.forward(xs.cuda() * 0.1, seed=9).cpu()
    stereo_err = rel_err(ys_gpu, st_cpu.forward(xs * 0.1, seed=9))
    draws = normal_from_seed(12345, (1, D, 4096), 1, device="cuda").cpu()
    draw_err = float((draws - normal_from_seed(12345, (1, D, 4096), 1)).abs().max())
    check(offline_err <= MODEL_TOL and stream_err <= MODEL_TOL and stereo_err <= MODEL_TOL
          and ys_gpu.shape == xs.shape and draw_err <= 1e-6,
          f"artifact GPU vs CPU rel err: offline {offline_err:.3e}, streaming {stream_err:.3e}, "
          f"stereo at 88.2 kHz {stereo_err:.3e} > {MODEL_TOL}; seeded draws {draw_err:.3e}")

    # 4. the served forward (a CUDA graph), its eager twin, forward_step.pt2 called
    # directly and served, in lockstep over 32 blocks; the stereo artifact's served
    # forward against its eager twin; beside them, the model's bare step pair (no
    # codec, no seed, no state swap)
    reset_graph_counts()
    budget = B / SAMPLE_RATE * 1e3
    lock = run_lockstep(art, x, 1000, art.load_program("forward"))
    y_err, state_err = lock.program_y_err, lock.program_state_err
    check(y_err <= PROGRAM_TOL and state_err <= PROGRAM_TOL,
          f"forward_step.pt2 vs eager over {PROGRAM_BLOCKS} blocks: y {y_err:.3e}, state "
          f"{state_err:.3e} > {PROGRAM_TOL}")
    served = {"v2": check_served("export v2", lock, budget)}
    xs_long = torch.randn(2, 1, PROGRAM_BLOCKS * st_gpu.block_size, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(10)) * 0.1
    budgets = {"v2": budget, "stereo_88200": st_gpu.block_size / (2 * SAMPLE_RATE) * 1e3}
    served["stereo_88200"] = check_served("export stereo", run_lockstep(st_gpu, xs_long, 1100),
                                          budgets["stereo_88200"])
    bare_ms = []
    for i in range(PROGRAM_BLOCKS):
        xb = x[..., i * B:(i + 1) * B]
        with torch.no_grad():
            _, ms = timed_call(lambda: art.model.step_decode(art.model.step_encode(xb)[:, :D]))
        bare_ms.append(ms)
    graphs = graphs_line("export", {k: v["p50_ms"] for k, v in served.items()}, budgets)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # 5. the unit at the 30 s forward's 11 centered shapes, B=1
    N = x.shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(30)
    unit_rows = [kernel_row(gen, "export_b1", 1, C, N // (16 * 4 ** i), d, "centered")
                 for i, (C, _, dils) in enumerate(UNIT_SHAPES) for d in dils]
    p50 = {**served["v2"]["p50_ms"], "bare_model_steps": statistics.median(bare_ms)}
    out = {"artifacts": {k: {kk: (str(v.relative_to(ROOT)) if kk == "path" else v)
                             for kk, v in a.items() if kk != "manifest"} for k, a in arts.items()},
           "latent_size": latent, "generate_launches": launches, "generate_s": generate_s,
           "forward_s": forward_s, "seconds_of_audio": n / SAMPLE_RATE,
           "realtime_factor_generate": n / SAMPLE_RATE / generate_s,
           "realtime_factor_forward": n / SAMPLE_RATE / forward_s, "wav_err": wav_err,
           "gpu_vs_cpu_rel_err": {"offline": offline_err, "stream": stream_err,
                                  "stereo_88200": stereo_err, "draws_abs": draw_err},
           "program_rel_err": {"y": y_err, "state": state_err}, "block_ms_p50": p50,
           "block_budget_ms": budget, "served": served, "graphs": graphs, "peak_gb": peak_gb,
           "unit_b1": unit_rows, "seconds": time.perf_counter() - t_phase}
    print(f"export: cli export x2 (--streaming --ema_weights; --stereo --sr {2 * SAMPLE_RATE}) "
          + "; ".join(f"{k} {a['seconds']:.1f} s, {a['mib']:.1f} MiB" for k, a in arts.items())
          + f"; latent {latent} of {D}; generate {n / SAMPLE_RATE:.1f} s of audio: {launches} "
          f"launches, wav {wav_err:.2e} from forward; GPU vs CPU offline {offline_err:.2e}, "
          f"{CPU_STREAM_BLOCKS} blocks {stream_err:.2e}, stereo {stereo_err:.2e} <= {MODEL_TOL}, "
          f"draws {draw_err:.1e}; forward_step.pt2 vs "
          f"eager {PROGRAM_BLOCKS} blocks y {y_err:.2e}, state {state_err:.2e} <= {PROGRAM_TOL}"
          f"; served forward bit-equal to the eager steps over {PROGRAM_BLOCKS} blocks across a "
          f"reset (v2 and stereo), the served .pt2 bit-equal to the .pt2", flush=True)
    print(f"export times: generate realtime factor {out['realtime_factor_generate']:.1f}x end "
          f"to end ({generate_s:.2f} s), {out['realtime_factor_forward']:.1f}x bare forward "
          f"({forward_s * 1e3:.1f} ms); streaming p50 per block served {p50['graph']:.3f} ms, "
          f".pt2 served {p50['program']:.3f} ms, eager {p50['eager']:.3f} ms, .pt2 eager "
          f"{p50['program_eager']:.3f} ms, the model's bare steps {p50['bare_model_steps']:.3f} "
          f"ms (budget {out['block_budget_ms']:.2f} ms); peak "
          f"{peak_gb:.2f} GiB; unit B=1 kernel/plain ms: {shape_summary(unit_rows)}; phase "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# the discrete phase: the C=768 unit shapes only discrete reaches (T=256 at B=16 x 131072)
# the prior phase: the stock prior (prior_v1.gin) at latent_size 16 over the 128 latent
# frames of the 262144 samples train_prior takes at v2's decimation (2048)
PRIOR_LATENT, PRIOR_FRAMES, PRIOR_STREAM_STEPS = 16, 128, 64
PRIOR_PROGRAM_STEPS, PRIOR_TIMED_STEPS, PRIOR_SECONDS = 32, 32, 5.0
PRIOR_STREAM_TOL = 1e-4  # 64 chained steps against the offline logits
PRIOR_FRAME_MS = 2048 / SAMPLE_RATE * 1e3  # one latent frame of v2: a live prior's budget
# train_prior's clips: the loop's 16-step run keeps most of its 128 dimensions at fidelity
# 0.95, and the diagonal shift of D dimensions takes D - 1 of the clip's frames, so the
# default 262144 samples (128 frames) would leave one; 524288 leave at least 129
PRIOR_N_SIGNAL = 524288
# the units of one v2 encoder (or decoder): each shape's dilations once
UNITS_PER_HALF = sum(len(d) for _, _, d in UNIT_SHAPES)


def _stock_prior() -> dict:
    """(a) The stock prior at full width on the card: the forward at B=8 x 128
    frames against the same weights on the CPU, 64 chained steps against the
    offline logits, and one Adam step (ms, peak memory)."""
    import torch

    from rave_tpu_torch.nn.streaming import init_stream_state
    from rave_tpu_torch.prior.core import stack_one_hot
    from rave_tpu_torch.prior.model import build_prior, prior_loss

    prior = build_prior(PRIOR_LATENT, seed=0, device="cuda")
    cpu = build_prior(PRIOR_LATENT, seed=0, device="cpu")
    R = prior.resolution
    classes = torch.randint(0, R, (TRAIN_BATCH, PRIOR_LATENT, PRIOR_FRAMES),
                            generator=torch.Generator().manual_seed(12))
    x_cpu = stack_one_hot(classes, R)
    x = x_cpu.to("cuda")
    with torch.no_grad():
        logits = prior(x)
        err_cpu = rel_err(logits.cpu(), cpu(x_cpu))
        init_stream_state(prior, TRAIN_BATCH)
        chained = torch.cat([prior.step(x[..., t:t + 1]) for t in range(PRIOR_STREAM_STEPS)], -1)
        err_stream = rel_err(chained, logits[..., :PRIOR_STREAM_STEPS])
    check(logits.shape == x.shape and bool(torch.isfinite(logits).all()),
          f"prior logits {tuple(logits.shape)} or not finite")
    check(err_cpu <= MODEL_TOL, f"prior card vs CPU {err_cpu:.3e} > {MODEL_TOL}")
    check(err_stream <= PRIOR_STREAM_TOL,
          f"prior {PRIOR_STREAM_STEPS} chained steps vs offline {err_stream:.3e}")
    opt = torch.optim.Adam(prior.parameters(), lr=1e-4)
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(3):  # two warm steps, then the timed one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = prior_loss(prior, x, PRIOR_LATENT)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check(math.isfinite(loss.item()), "prior loss not finite")
    return {"channels": PRIOR_LATENT * R, "receptive_field": prior.receptive_field,
            "params": sum(p.numel() for p in prior.parameters()), "card_vs_cpu": err_cpu,
            "stream_vs_offline": err_stream, "step_ms": times[-1], "loss": loss.item(),
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 2**30}


def v2_unit_shapes(batch: int, n_samples: int, mode: str = "centered") -> list:
    """(B, C, T, d, mode) of the units of one v2 encoder over `n_samples`
    samples, sorted; a decoder that writes `n_samples` has the same."""
    return sorted((batch, C, n_samples // (16 * 4 ** i), d, mode)
                  for i, (C, _, dils) in enumerate(UNIT_SHAPES) for d in dils)


class UnitShapes:
    """While open, records (B, C, T, d, mode) of every fused unit call on a
    CUDA tensor, in process: the shapes the path gives the kernel."""

    def __enter__(self):
        from rave_tpu_torch.models.blocks import FusedDilatedResidual
        from rave_tpu_torch.ops.kernels.dilated_unit import traced

        self.cls, self.saved, self.seen = FusedDilatedResidual, FusedDilatedResidual.forward, []
        saved, seen = self.saved, self.seen

        def forward(mod, x):
            # a trace's calls (the portable export's) go to the registered op, not the wrapper
            if x.is_cuda and mod.inner.activation == "leaky_relu" and not traced():
                left, right = mod.inner.net.layers[1].pad
                seen.append((x.shape[0], x.shape[1], x.shape[2], mod.inner.dilation,
                             "centered" if left == right else "causal"))
            return saved(mod, x)

        self.cls.forward = forward
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.saved


class PriorProbe:
    """Counts the unit's launches of each `encode_latents` and `decode_latents`
    call that `train_prior` makes (the frozen RAVE's halves), in process, and
    the unit shapes of each from `shapes` (a `UnitShapes`); keeps the first
    batch that `encode_latents` was given."""

    NAMES = ("encode_latents", "decode_latents")

    def __init__(self, shapes: UnitShapes):
        from rave_tpu_torch.prior import train

        self.module, self.calls = train, {name: [] for name in self.NAMES}
        self.saved = {name: getattr(train, name) for name in self.NAMES}
        self.shapes, self.first_x = shapes, None

    def __enter__(self):
        for name in self.NAMES:
            setattr(self.module, name, self.observe(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)

    def observe(self, name: str, fn):
        import torch

        from rave_tpu_torch.ops.kernels import dilated_unit

        def call(*args, **kwargs):
            if name == "encode_latents" and self.first_x is None:
                self.first_x = args[2].clone()
            torch.cuda.synchronize()
            before, seen, t0 = dilated_unit.launches, len(self.shapes.seen), time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls[name].append({"launches": dilated_unit.launches - before,
                                     "ms": (time.perf_counter() - t0) * 1e3,
                                     "units": sorted(self.shapes.seen[seen:])})
            return out

        return call


def prior_logits(prior, inputs):
    """(logits, their float32 rounding scale), both [B, D, R, T], of `prior`
    on `inputs` [B, D*R, T]. A logit's rounding scales with what float32
    sums to make it through the whole chain (`prior_error_magnitude`), not
    with its value, which may be near 0 where the terms are not (as
    `check_codes` scales squared distances by the sum of the squares)."""
    import torch

    from rave_tpu_torch.prior.model import split_classes

    D = prior.latent_size
    with torch.no_grad():
        return (split_classes(prior(inputs), D),
                split_classes(prior_error_magnitude(prior, inputs), D))


def prior_error_magnitude(prior, inputs):
    """[B, D*R, T]: the scale of float32 rounding in `prior`'s logits on
    `inputs`, in float64, first order, as independent roundings add: each
    sum of a convolution adds the root of its terms' squares (and its bias's
    square) to its inputs' error carried through the weights (squares through
    squares); leaky ReLU carries it by its slope at the value, the gate
    sigmoid(a) tanh(b) by sigmoid'(a) tanh(b) and sigmoid(a) tanh'(b) plus the
    product's own |g|, an addition by its operands' and its sum's."""
    import torch
    import torch.nn.functional as F

    def conv(c, v, e2):
        w, b = c.weight().double(), None if c.b is None else c.b.double()
        args = (c.stride, 0, c.dilation, c.groups)
        vp, ep = F.pad(v, c.pad), F.pad(e2, c.pad)
        own = F.conv1d(vp * vp, w * w, None if b is None else b * b, *args)
        return F.conv1d(vp, w, b, *args), F.conv1d(ep, w * w, None, *args) + own

    def leaky(v, e2):
        return F.leaky_relu(v, 0.2), torch.where(v > 0, e2, 0.04 * e2)

    def add(a, ea2, b, eb2):
        return a + b, ea2 + eb2 + (a + b) ** 2

    v = inputs.double()
    e2 = torch.zeros_like(v)
    v, e2 = leaky(*conv(prior.pre_net.layers[0], v, e2))
    skp = torch.zeros(v.shape[0], prior.skp_size, v.shape[2], dtype=v.dtype)
    e2_skp = torch.zeros_like(skp)
    for layer in prior.residuals:
        x, ex2 = conv(layer.dconv, v, e2)
        (a, b), (ea2, eb2) = x.chunk(2, dim=1), ex2.chunk(2, dim=1)
        sa, tb = torch.sigmoid(a), torch.tanh(b)
        g = sa * tb
        eg2 = (sa * (1 - sa) * tb) ** 2 * ea2 + (sa * (1 - tb * tb)) ** 2 * eb2 + g * g
        v, e2 = add(v, e2, *conv(layer.rconv, g, eg2))
        skp, e2_skp = add(skp, e2_skp, *conv(layer.sconv, g, eg2))
    first, _, last = prior.post_net.layers
    v, e2 = leaky(*conv(first, skp, e2_skp))
    return conv(last, v, e2)[1].sqrt()


def check_prior_codes(card_art, cpu_art, n: int, seed: int) -> dict:
    """`sample_prior(argmax=True)` on the card against the CPU: the card's
    chain of frames, fed to the CPU's prior (teacher-forced: causal, so its
    offline logits are the chained steps'), gives the card's pick at every
    step and dimension unless the two picks' CPU logits tie: they differ by
    no more than CODE_TIE of the sum of their float32 magnitudes
    (`prior_logits`). The latents that each device samples on its own are
    compared (reported)."""
    import torch

    from rave_tpu_torch.prior.model import split_classes

    prior = card_art.prior_step.prior
    D, R = prior.latent_size, prior.resolution
    x = torch.zeros(1, D * R, 1, device="cuda")
    state, frames = card_art.prior_state(), []
    with torch.no_grad():
        for i in range(n + D - 1):
            x, state = card_art.prior_step(state, x, torch.tensor(0, device="cuda"), True)
            frames.append(x)
        card = torch.cat(frames, -1).cpu()
        inputs = torch.cat([torch.zeros(1, D * R, 1), card[..., :-1]], -1)
        # [1, D, R, n + D - 1] each
        logits, magnitude = prior_logits(cpu_art.prior_step.prior, inputs)
    picks_card, picks_cpu = split_classes(card, D).argmax(2), logits.argmax(2)
    bad = (picks_card != picks_cpu).nonzero()
    at_card = (0, bad[:, 1], picks_card[0, bad[:, 1], bad[:, 2]], bad[:, 2])
    at_cpu = (0, bad[:, 1], picks_cpu[0, bad[:, 1], bad[:, 2]], bad[:, 2])
    l_card, l_cpu = logits[at_card].double(), logits[at_cpu].double()
    window = CODE_TIE * (magnitude[at_card] + magnitude[at_cpu])
    ties = int(((l_cpu - l_card).abs() <= window).sum())
    # how near the CPU's two best logits came anywhere on the chain, in windows: the codes
    # that rounding alone could part lie under 1
    top, at = logits.double().topk(2, dim=2)
    gaps = (top[:, :, 0] - top[:, :, 1]) / (
        CODE_TIE * magnitude.gather(2, at).sum(2)).clamp_min(1e-300)
    nearest = float(gaps.min())
    in_window = int((gaps <= 1).sum())
    if len(bad) != ties:  # each pick that parts: both devices' logits and a float64 referee's
        with torch.no_grad():
            on_card = split_classes(prior(inputs.cuda()), D).cpu()
            f64 = split_classes(copy.deepcopy(cpu_art.prior_step.prior).double()(
                inputs.double()), D)
        parts = []
        for (_, d, t), a, b in zip(bad.tolist(), l_cpu.tolist(), l_card.tolist()):
            pa, pb = int(picks_cpu[0, d, t]), int(picks_card[0, d, t])
            parts.append(f"dim {d} step {t}: CPU picks {pa}, card {pb}; CPU logits {a:.9g} / "
                         f"{b:.9g} (gap {a - b:.3e}, magnitudes {float(magnitude[0, d, pa, t]):.4g}"
                         f" / {float(magnitude[0, d, pb, t]):.4g}), card "
                         f"{float(on_card[0, d, pa, t]):.9g} / {float(on_card[0, d, pb, t]):.9g}, "
                         f"float64 {float(f64[0, d, pa, t]):.9g} / {float(f64[0, d, pb, t]):.9g} "
                         f"(float64 picks {int(f64[0, d, :, t].argmax())})")
        print("prior argmax codes that part:\n  " + "\n  ".join(parts), flush=True)
    check(len(bad) == ties, f"prior argmax codes: {len(bad)} differ on the card's chain, "
                            f"{ties} of them ties (CODE_TIE {CODE_TIE:g} of the two logits' "
                            f"float32 magnitudes)")
    z_card = card_art.sample_prior(n, seed=seed, argmax=True).cpu()
    z_cpu = cpu_art.sample_prior(n, seed=seed, argmax=True)
    return {"codes": int(picks_card.numel()), "codes_differ": len(bad), "code_ties": ties,
            "nearest_gap_windows": nearest, "codes_in_window": in_window,
            "own_chain_z_rel_err": rel_err(z_card, z_cpu)}


def phase_prior(run_dir: Path, db: Path) -> dict:
    """The latent prior on phase `loop`'s v2 run and store; see the module docstring."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from rave_tpu_torch.export.artifact import ExportedRAVE, prior_step_seed
    from rave_tpu_torch.nn.graphs import StepGraphs
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.prior.train import encode_latents
    from rave_tpu_torch.utils.checkpoint import load_run

    t_phase = time.perf_counter()
    reset_graph_counts()
    work = ROOT / "build" / "prior"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    stock = _stock_prior()

    # (b) train_prior --smoke_test: 2 steps, a validation sample and a save after each
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    shapes = UnitShapes().__enter__()  # closed after (c)'s generate
    with PriorProbe(shapes) as probe:
        out = _cli(["train_prior", "--run", run_dir, "--db_path", db, "--name", "smoke",
                    "--out_path", work, "--n_signal", PRIOR_N_SIGNAL, "--smoke_test",
                    "--device", "cuda"])
    train_s = time.perf_counter() - t0
    launches_train = dilated_unit.launches
    prior_run = Path(out.strip().splitlines()[-1].removeprefix("prior run dir: "))
    pcfg = json.loads((prior_run / "prior_config.json").read_text())
    enc, dec = probe.calls["encode_latents"], probe.calls["decode_latents"]
    check(len(enc) == 2 and len(dec) == 2, f"train_prior: {len(enc)} encodes, {len(dec)} decodes")
    check(all(c["launches"] == UNITS_PER_HALF for c in enc + dec),
          f"unit launches per encode_latents {[c['launches'] for c in enc]}, per decode "
          f"{[c['launches'] for c in dec]}; expected {UNITS_PER_HALF} each")
    check(launches_train == UNITS_PER_HALF * 4 and dilated_unit.launches_bf16 == 0,
          f"train_prior: {launches_train} launches")
    enc_units = v2_unit_shapes(TRAIN_BATCH, PRIOR_N_SIGNAL)
    # the validation sample: 128 frames generated, less the D - 1 that undoing the shift
    # takes (as rave_tpu/prior/train.py decodes it)
    val_frames = min(128, PRIOR_N_SIGNAL // 2048) - pcfg["latent_size"] + 1
    dec_units = v2_unit_shapes(1, val_frames * 2048)
    check(all(c["units"] == enc_units for c in enc) and all(c["units"] == dec_units for c in dec),
          f"unit shapes per encode_latents {[c['units'] for c in enc]}, per decode "
          f"{[c['units'] for c in dec]}; expected {enc_units} and {dec_units}")
    rows = [json.loads(r) for r in (prior_run / "metrics.jsonl").read_text().splitlines()]
    check([r["step"] for r in rows] == [1, 2]
          and all(math.isfinite(r["latent_prediction"]) for r in rows), f"prior rows {rows}")
    check(len(list((prior_run / "checkpoints").iterdir())) == 2, "prior checkpoints")

    # (c) export --prior, generate --prior_seconds, the artifact card vs CPU, .pt2, timing
    t0 = time.perf_counter()
    out = _cli(["export", "--run", run_dir, "--prior", prior_run, "--output", work / "export",
                "--device", "cuda"])
    export_s = time.perf_counter() - t0
    path = out.strip().splitlines()[-1].removeprefix("exported: ")
    launches_export = dilated_unit.launches - launches_train
    before = dilated_unit.launches
    t0 = time.perf_counter()
    _cli(["generate", "--model", path, "--prior_seconds", PRIOR_SECONDS, "--out_path",
          work / "gen", "--seed", GENERATE_SEED, "--device", "cuda"])
    generate_s = time.perf_counter() - t0
    launches_generate = dilated_unit.launches - before
    launches = dilated_unit.launches
    shapes.__exit__()
    check(len(shapes.seen) == launches, f"{len(shapes.seen)} unit calls on the card recorded, "
                                        f"{launches} launches counted")
    check(launches_export == UNITS_PER_HALF and launches_generate == UNITS_PER_HALF,
          f"export --prior {launches_export} launches (its smoke decode), generate "
          f"--prior_seconds {launches_generate} (one decode); expected {UNITS_PER_HALF} each")
    art = ExportedRAVE(path, device="cuda")
    cpu_art = ExportedRAVE(path, device="cpu")
    decim = art.cfg.decimation()
    sr, wav = wavfile.read(work / "gen" / "prior_sample_0.wav")
    n_frames = max(round(PRIOR_SECONDS * SAMPLE_RATE / decim), 1)
    check(sr == SAMPLE_RATE and wav.shape == (n_frames * decim,),
          f"prior sample wav {sr} Hz, {wav.shape}; expected {n_frames * decim} samples")
    gen_units = sorted(shapes.seen[-UNITS_PER_HALF:])
    check(gen_units == v2_unit_shapes(1, n_frames * decim),
          f"generate --prior_seconds: unit shapes {gen_units}")
    check(bool(np.abs(wav).max() > 0), "the prior sample is silent")

    check(art.has_prior and art.manifest["prior"] == pcfg, "the artifact's prior")
    codes = check_prior_codes(art, cpu_art, PRIOR_PROGRAM_STEPS, GENERATE_SEED)
    # the eager step, prior_step.pt2 and both served (the artifact's own graph of
    # the step, and the .pt2 through StepGraphs) in lockstep from a zero frame and
    # state, a new chain from zero halfway: bit-equal
    program = art.load_program("prior")
    served, served_program = art.graphs["prior"], StepGraphs(program, art.prior_state(),
                                                              art.graph_pool)
    D = art.prior_step.prior.latent_size * art.prior_step.prior.resolution
    with torch.no_grad():
        for i in range(PRIOR_PROGRAM_STEPS):
            if i in (0, PRIOR_PROGRAM_STEPS // 2):
                x_e = x_p = x_g = x_pg = torch.zeros(1, D, 1, device="cuda")
                s_e, s_p = art.prior_state(), art.prior_state()
                for t in served.state + served_program.state:
                    t.zero_()
            seed = prior_step_seed(GENERATE_SEED, i)
            seed_t = torch.tensor(seed, dtype=torch.int64, device="cuda")
            x_e, s_e = art.prior_step(s_e, x_e, seed_t)
            x_p, s_p = program(s_p, x_p, seed_t)
            x_g, x_pg = served(x_g, seed), served_program(x_pg, seed)
            check(torch.equal(x_e, x_p) and all(torch.equal(a, b) for a, b in zip(s_e, s_p)),
                  f"prior_step.pt2 differs from the eager step at step {i}")
            check(torch.equal(x_g, x_e) and torch.equal(x_pg, x_e)
                  and states_equal(served.state, s_e) and states_equal(served_program.state, s_e),
                  f"a served prior step differs from the eager step at step {i}")

    def step_ms(fn, graph: bool = False) -> list:
        x, state, ms = torch.zeros(1, D, 1, device="cuda"), art.prior_state(), []
        for t in fn.state if graph else ():
            t.zero_()
        with torch.no_grad():
            for i in range(PRIOR_TIMED_STEPS + 4):
                seed = prior_step_seed(1, i)
                seed_t = torch.tensor(seed, dtype=torch.int64, device="cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if graph:
                    x = fn(x, seed)
                else:
                    x, state = fn(state, x, seed_t)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        return ms[4:]

    p50 = {"graph": statistics.median(step_ms(served, graph=True)),
           "program": statistics.median(step_ms(served_program, graph=True)),
           "eager": statistics.median(step_ms(art.prior_step)),
           "program_eager": statistics.median(step_ms(program))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = art.sample_prior(n_frames, seed=GENERATE_SEED)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    check(z.shape == (1, art.latent_size, n_frames) and bool(torch.isfinite(z).all()),
          f"sample_prior {tuple(z.shape)} or not finite")

    # (d) the unit at the path's shapes; an encode_latents batch and a sample's decode
    gen = torch.Generator(device="cuda").manual_seed(16)
    unit_rows = [kernel_row(gen, "prior", *shape) for shape in sorted(set(shapes.seen))]
    by_shape = {(r["B"], r["C"], r["T"], r["d"], r["mode"]): r for r in unit_rows}
    path_rows = [by_shape[shape] for shape in shapes.seen]  # one per launch
    unit_path = {"launches": len(path_rows), "ms": sum(r["ms"] for r in path_rows),
                 "plain_ms": sum(r["plain_ms"] for r in path_rows),
                 "bound_ms": sum(unit_bound([r], r["B"], "fp32")["bound_ms"] for r in path_rows),
                 "max_abs_err": max(r["max_abs_err"] for r in unit_rows)}
    x = probe.first_x
    eps = torch.randn(x.shape[0], art.cfg.latent_size, x.shape[-1] // decim,
                      generator=torch.Generator().manual_seed(17))
    z_enc = {}
    for dev in ("cuda", "cpu"):
        cfg_d, vae, _, _ = load_run(str(run_dir), device=dev)
        z_enc[dev] = encode_latents(cfg_d, vae, x.to(dev), pcfg["latent_size"],
                                    eps=eps.to(dev)).cpu()
        del vae
    encode_err = rel_err(z_enc["cuda"], z_enc["cpu"])
    decode_err = rel_err(art.decode(z, seed=GENERATE_SEED).cpu(),
                         cpu_art.decode(z.cpu(), seed=GENERATE_SEED))
    check(z_enc["cuda"].shape == (x.shape[0], pcfg["latent_size"], x.shape[-1] // decim)
          and encode_err <= MODEL_TOL and decode_err <= MODEL_TOL,
          f"prior path card vs CPU: encode_latents {tuple(z_enc['cuda'].shape)} "
          f"{encode_err:.3e}, a sample's decode {decode_err:.3e} > {MODEL_TOL}")
    host_artifact = keep_for_host("prior", path)  # streamed by phase `host`
    shutil.rmtree(work, ignore_errors=True)
    out = {"stock": stock, "host_artifact": host_artifact, "latent_size": pcfg["latent_size"], "artifact_latent_size":
           art.latent_size, "train_s": train_s, "encode_ms": [c["ms"] for c in enc],
           "decode_ms": [c["ms"] for c in dec], "ce": [r["latent_prediction"] for r in rows],
           "export_s": export_s, "generate_s": generate_s, "wav_samples": int(wav.shape[0]),
           "card_vs_cpu": codes, "program_steps_bit_equal": PRIOR_PROGRAM_STEPS,
           "step_ms_p50": p50, "frame_budget_ms": PRIOR_FRAME_MS,
           "graphs": graphs_line("prior", {"prior_step": p50}, {"prior_step": PRIOR_FRAME_MS}),
           "sample_prior_s": sample_s, "sample_frames": n_frames,
           "launches": launches, "launches_per_encode": UNITS_PER_HALF,
           "launches_per_decode": UNITS_PER_HALF, "unit_rows": unit_rows,
           "unit_path": unit_path, "card_vs_cpu_encode": encode_err,
           "card_vs_cpu_decode": decode_err, "seconds": time.perf_counter() - t_phase}
    print(f"prior: stock prior (latent {PRIOR_LATENT}, {stock['channels']} channels, rf "
          f"{stock['receptive_field']}, {stock['params']} params) B={TRAIN_BATCH} x "
          f"{PRIOR_FRAMES} frames: card vs CPU {stock['card_vs_cpu']:.2e}, "
          f"{PRIOR_STREAM_STEPS} chained steps vs offline {stock['stream_vs_offline']:.2e}; "
          f"Adam step {stock['step_ms']:.2f} ms, peak {stock['peak_gb']:.2f} GiB; "
          f"cli train_prior --smoke_test on the loop's run: latent_size {out['latent_size']} "
          f"(artifact {art.latent_size}), ce {out['ce']}, {UNITS_PER_HALF} launches per "
          f"encode_latents ({', '.join(f'{ms:.1f}' for ms in out['encode_ms'])} ms) and per "
          f"decode ({', '.join(f'{ms:.1f}' for ms in out['decode_ms'])} ms), {train_s:.1f} s; "
          f"export --prior {export_s:.1f} s; generate --prior_seconds {PRIOR_SECONDS:g} "
          f"{generate_s:.2f} s, {wav.shape[0]} samples; sample_prior({n_frames}) "
          f"{sample_s:.2f} s; argmax codes card vs CPU on the card's chain: "
          f"{codes['codes_differ']} of {codes['codes']} differ ({codes['code_ties']} ties; "
          f"{codes['codes_in_window']} codes' CPU top two within the tie window, the nearest "
          f"{codes['nearest_gap_windows']:.3g} windows apart), "
          f"own chains' latents {codes['own_chain_z_rel_err']:.2e}; prior_step.pt2 "
          f"and both served steps bit-equal over {PRIOR_PROGRAM_STEPS} steps; step p50 served "
          f"{p50['graph']:.3f} / .pt2 served {p50['program']:.3f} / eager {p50['eager']:.3f} / "
          f".pt2 eager {p50['program_eager']:.3f} ms (frame budget {PRIOR_FRAME_MS:.2f}); "
          f"{launches} "
          f"launches; card vs CPU encode_latents (B={x.shape[0]}) {encode_err:.2e}, a "
          f"sample's decode {decode_err:.2e} <= {MODEL_TOL}; unit at the path's "
          f"{len(unit_rows)} shapes: max rel err {max(r['rel_err'] for r in unit_rows):.2e} <= "
          f"{KERNEL_TOL}, its {launches} launches {unit_path['ms']:.3f} ms (plain "
          f"{unit_path['plain_ms']:.3f}, bound {unit_path['bound_ms']:.3f}); kernel/plain ms: "
          f"{shape_summary(unit_rows)}; {out['seconds']:.1f} s", flush=True)
    for kind, ms in p50.items():
        check(ms < PRIOR_FRAME_MS, f"prior step p50 ({kind}) {ms:.3f} ms over one latent "
                                   f"frame's {PRIOR_FRAME_MS:.2f} ms")
    return out


DISCRETE_UNITS = [(768, 256, (1, 3))]
DISCRETE_PREWARMUP_STEPS, DISCRETE_WARMED_STEPS = 2, 4  # after the k-means step; 2 critic
DISCRETE_LOOP = ["train.phase_1_duration=3", "train.update_discriminator_every=2",
                 "train.ema=0.999"]
DISCRETE_LOOP_STEPS, DISCRETE_RESUME_STEPS, DISCRETE_VAL_EVERY = 6, 8, 3
# card vs CPU codes on one shared latent: a code may differ only where its two
# float64 distances tie within this share of |r|^2 + |c|^2 (float32's rounding)
CODE_TIE = 1e-6


B1_PROGRAMS = (("gen_prewarmup", "gen", False), ("gen_adversarial", "gen", True),
               ("dis", "dis", True))


def _family_steps_b1(names, programs=B1_PROGRAMS) -> dict:
    """The first step of each of `programs` ((name, which, warmed)) of
    `names` from the seed-0 state at B=1 x n_signal, on the card and on the
    CPU with the same draws (drawn on the CPU): {name: {device: metrics}}.
    Each device's state is built once and copied for each program."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise

    cfg = compose(names)
    xb, _ = _b1_inputs(cfg)
    draws = draw_noise(cfg, xb, torch.Generator().manual_seed(9))
    steps = build_train_steps(cfg)  # no crop: the same on both devices
    out = {name: {} for name, _, _ in programs}
    for device in ("cuda", "cpu"):
        seed0 = create_train_state(cfg, seed=0, device=device)
        x, d = xb.to(device), draws.to(device)
        for name, which, warmed in programs:
            st = copy.deepcopy(seed0)
            st.step = cfg.train.phase_1_duration if warmed else 0
            m = (steps["gen"](st, x, warmed, draws=d) if which == "gen"
                 else steps["dis"](st, x, draws=d))
            out[name][device] = {k: float(v) for k, v in m.items()}
        del seed0
    return out


def _loss_err(a: dict, b: dict) -> float:
    return max(abs(a[k] - v) / max(abs(v), 1e-2) for k, v in b.items())


def codes_summary(c: dict) -> str:
    return (f"latents {c['z_rel_err']:.2e}, codes on the card's latent: "
            f"{c['shared_latent_codes_differ']} differ ({c['shared_latent_code_ties']} ties); "
            f"each its own latent: {c['index_agreement']:.4f} equal (reported)")


def check_codes(card_rvq, cpu_rvq, z_card, z_cpu, what: str) -> dict:
    """The RVQ on the card against the CPU's, from latents [B, D, T] that
    each device encoded: the latents within MODEL_TOL; then on one shared
    latent, the card's, each quantizer of the CPU fed the card's residual
    picks the card's code, unless the two codes tie (CODE_TIE). The share of
    equal codes when each device quantizes its own latent is reported only:
    near-ties flip between latents 1e-6 apart (ROADMAP C11)."""
    z_err = rel_err(z_card.cpu(), z_cpu)
    residual = z_card.transpose(1, 2).reshape(-1, z_card.shape[1])
    differ = ties = 0
    for card_vq, cpu_vq in zip(card_rvq.vq, cpu_rvq.vq):
        mine, shared = card_vq.codebook.encode(residual), residual.cpu()
        theirs, mine_cpu = cpu_vq.codebook.encode(shared), mine.cpu()
        bad = (mine_cpu != theirs).nonzero().flatten()
        if len(bad):
            r, codes = shared[bad].double(), cpu_vq.codebook.embed.double()
            d_mine = ((r - codes[mine_cpu[bad]]) ** 2).sum(-1)
            d_theirs = ((r - codes[theirs[bad]]) ** 2).sum(-1)
            scale = (r ** 2).sum(-1) + (codes[theirs[bad]] ** 2).sum(-1)
            differ += len(bad)
            ties += int(((d_mine - d_theirs).abs() <= CODE_TIE * scale).sum())
        residual = residual - card_vq.codebook.decode(mine)
    own = card_rvq.encode(z_card.transpose(1, 2)).cpu() == cpu_rvq.encode(z_cpu.transpose(1, 2))
    check(z_err <= MODEL_TOL and differ == ties,
          f"{what} card vs CPU: latents {z_err:.3e}; on the card's latent {differ} codes "
          f"differ, {ties} of them ties")
    return {"z_rel_err": z_err, "shared_latent_codes_differ": differ,
            "shared_latent_code_ties": ties, "index_agreement": float(own.float().mean())}


def _discrete_offline(cfg) -> dict:
    """B=16 x 131072 forward (timed, 22 launches) and, at phase `offline`'s
    B=1 x 65536, the encoder output, the RVQ codes and the decode of one
    index tensor on the card against the CPU."""
    import torch

    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.steps import draw_noise

    cpu_model = build_rave(cfg, seed=0, device="cpu").eval()
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    draws = draw_noise(cfg, x, gen)
    with torch.inference_mode():
        model(x, draws)  # warm
        torch.cuda.synchronize()
        reset_counts()
        y = model(x, draws)
        torch.cuda.synchronize()
        launches = dilated_unit.launches
        check(tuple(y.shape) == (BATCH, 1, N_SIGNAL) and bool(torch.isfinite(y).all()),
              f"discrete forward {tuple(y.shape)} or not finite")
        check(launches == 22 and dilated_unit.launches_bf16 == 0,
              f"{launches} launches ({dilated_unit.launches_bf16} bf16) in a discrete forward")
        t0 = time.perf_counter()
        for _ in range(5):
            model(x, draws)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / 5

        n = 65536
        xb = torch.randn(1, 1, n, generator=torch.Generator().manual_seed(2)) * 0.1
        z_cpu = cpu_model.encode(xb)
        codes = check_codes(model.encoder.rvq, cpu_model.encoder.rvq, model.encode(xb.cuda()),
                            z_cpu, "discrete")
        idx_cpu = cpu_model.encoder.encode_indices(z_cpu)
        noise = torch.randn(1, cfg.latent.noise_augmentation, z_cpu.shape[-1],
                            generator=torch.Generator().manual_seed(3))
        decode = lambda m, dev: m.decode(torch.cat(  # noqa: E731
            [m.encoder.decode_indices(idx_cpu.to(dev)), noise.to(dev)], 1))
        y_err = rel_err(decode(model, "cuda").cpu(), decode(cpu_model, "cpu"))
    check(y_err <= MODEL_TOL, f"discrete card vs CPU: decode of one index tensor {y_err:.3e}")
    return {"launches": launches, "forward_ms": sec * 1e3,
            "realtime_factor": BATCH * N_SIGNAL / SAMPLE_RATE / sec, **codes,
            "decode_rel_err": y_err}


def _discrete_steps(cfg) -> dict:
    """The k-means step (timed alone), pre-warmup steps, then steps picked by
    pick_phase past the warmup, at B=8 x 131072 on the card: 22 launches per
    step, finite losses, codebooks initialized once and updated by every
    program; codebook_health after."""
    import torch

    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.analysis import crop_frames, receptive_field
    from rave_tpu_torch.train.loop import codebook_health
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, pick_phase

    rf = receptive_field(cfg, device="cuda")
    steps = build_train_steps(cfg, crop_frames(cfg, rf))
    state = create_train_state(cfg, seed=0, device="cuda")
    x = torch.randn(cfg.data.batch, 1, cfg.data.n_signal, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
    noise = torch.Generator(device="cuda").manual_seed(7)
    codebooks = [m.codebook for m in state.model.encoder.rvq.vq]
    times, launches = {"kmeans": [], "gen_prewarmup": [], "gen_adversarial": [], "dis": []}, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def one_step(name: str, which: str, warmed: bool, quantize: bool) -> None:
        nonlocal launches
        before = [cb.embed.clone() for cb in codebooks]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        if which == "dis":
            m = steps["dis"](state, x, generator=noise, quantize=quantize)
        else:
            m = steps["gen"](state, x, warmed, generator=noise, quantize=quantize)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        check(dilated_unit.launches == 22 and dilated_unit.launches_bf16 == 0,
              f"discrete {name} step: {dilated_unit.launches} launches, expected 22 fp32")
        launches += 22
        bad = [k for k, v in m.items() if not math.isfinite(float(v))]
        check(not bad, f"discrete {name} step: non-finite {bad}")
        check(all(not torch.equal(cb.embed, b) for cb, b in zip(codebooks, before))
              and all(float(cb.inited) == 1.0 for cb in codebooks),
              f"discrete {name} step left a codebook as it was")

    check(rf == (0, 0), f"discrete receptive field {rf}, expected (0, 0) as in JAX")
    one_step("kmeans", "gen", False, True)
    for _ in range(DISCRETE_PREWARMUP_STEPS):
        one_step("gen_prewarmup", "gen", False, True)
    state.step = cfg.train.phase_1_duration
    for _ in range(DISCRETE_WARMED_STEPS):
        which, warmed, quantize = pick_phase(cfg, state.step)
        one_step("dis" if which == "dis" else "gen_adversarial", which, warmed, quantize)
    perplexity, usage = codebook_health(state.model)
    check(math.isfinite(perplexity) and perplexity > 1 and 0 < usage <= 1,
          f"codebook health {perplexity}, {usage}")
    ms = {k: statistics.mean(v[1:] if k != "kmeans" and len(v) > 1 else v) * 1e3
          for k, v in times.items()}
    return {"rf": list(rf), "ms_per_step": ms, "steps": {k: len(v) for k, v in times.items()},
            "step_ms": {k: [t * 1e3 for t in v] for k, v in times.items()},
            "launches": launches, "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "codebook_perplexity": perplexity, "codebook_usage": usage}


def _discrete_loop(cfg, work: Path, db: Path) -> dict:
    """`cli train --config discrete` on phase `loop`'s store, resumed once
    (the restored state, codebooks and `inited` included, bit-equal to its
    checkpoint; no second k-means), then `cli eval`."""
    import torch

    from rave_tpu_torch.utils import checkpoint

    common = ["--config", "discrete", "--db_path", db, "--out_path", work / "runs", "--batch",
              TRAIN_BATCH, "--n_signal", N_SIGNAL, "--device", "cuda", "--val_every",
              DISCRETE_VAL_EVERY, "--save_every", 1000, "--device_data", "on", "--name", "d"]
    for o in DISCRETE_LOOP:
        common += ["--override", o]
    with LoopProbe() as probe:
        out = _cli(["train", "--max_steps", DISCRETE_LOOP_STEPS, *common])
        run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
        first = probe.take()
        out2 = _cli(["train", "--max_steps", DISCRETE_RESUME_STEPS, *common])
        resumed = probe.take()
    before = LoopProbe.counts()
    ev = json.loads(_cli(["eval", "--run", run_dir, "--db_path", db, "--split", "val",
                          "--device", "cuda"]).strip().splitlines()[-1])
    ev["fp32"] = LoopProbe.counts()[0] - before[0]
    _check_steps(first, "fp32", 0, DISCRETE_LOOP_STEPS, probe=False)
    _check_steps(resumed, "fp32", DISCRETE_LOOP_STEPS, DISCRETE_RESUME_STEPS, probe=False)
    check(f"resumed at step {DISCRETE_LOOP_STEPS}" in out2, "the discrete run did not resume")
    phases = {e["phase"] for e in first if e["kind"] == "step"}
    check(phases == {"gen_prewarmup", "gen_adversarial", "dis"}, f"discrete phases {phases}")
    restores = [e for e in resumed if e["kind"] == "restore" and "state" in e]
    check(len(restores) == 1, f"discrete restores {len(restores)}")
    saved = torch.load(restores[0]["path"], map_location="cpu", weights_only=True)
    bad = unequal(restores[0]["state"], saved)
    inited = [k for k in saved["model"] if k.endswith("inited")]
    check(not bad and len(inited) == cfg.latent.num_quantizers
          and all(float(saved["model"][k]) == 1.0 for k in inited),
          f"discrete restore not bit-equal ({bad[:5]}) or codebooks not initialized")
    rows = [json.loads(r) for r in (run_dir / "metrics.jsonl").read_text().splitlines()]
    health = [r for r in rows if "codebook_perplexity" in r]
    check([r["step"] for r in health] == [3, 6, 8], f"codebook health rows {health}")
    check(all(math.isfinite(ev[k]) for k in EVAL_METRICS) and ev["fp32"] == 22 * ev["n_batches"],
          f"discrete eval {ev}")
    ckpts = [checkpoint.checkpoint_step(p) for p in checkpoint.list_checkpoints(str(run_dir))]
    return {"run_dir": run_dir, "checkpoints": ckpts, "eval": ev, "codebook_health": health,
            "launches": sum(e["fp32"] for e in first + resumed) + ev["fp32"],
            "step_ms": loop_ms(first + resumed)}


def _discrete_export(cfg, run_dir: Path, work: Path) -> dict:
    """`cli export --streaming` of the loop's run and `cli generate` of a 30 s
    file; the card against the CPU (codes agree, one index tensor decodes
    alike); `forward_step.pt2` bit-equal to the eager steps over 32 blocks;
    the streaming p50 against the block's budget."""
    import torch

    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal
    from rave_tpu_torch.ops.kernels import dilated_unit

    t0 = time.perf_counter()
    text = _cli(["export", "--run", run_dir, "--streaming", "--output", work / "export",
                 "--device", "cuda"])
    export_s = time.perf_counter() - t0
    path = Path(text.strip().splitlines()[-1].removeprefix("exported: "))
    manifest = json.loads((path / "manifest.json").read_text())
    want = (cfg.latent.num_quantizers, cfg.augmented_latent_size(), cfg.block_size())
    got = tuple(manifest[k] for k in ("latent_size", "full_latent_size", "block_size"))
    check(got == want, f"discrete manifest: latent, full latent, block {got}, expected {want}")
    wav = work / "discrete_in.wav"
    n = write_signal(wav, EXPORT_SECONDS, seed=22)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    _cli(["generate", "--model", path, "--input", wav, "--out_path", work / "generated",
          "--device", "cuda"])
    torch.cuda.synchronize()
    generate_s, launches = time.perf_counter() - t0, dilated_unit.launches
    check(launches == 22, f"discrete generate: {launches} launches, expected 22")

    art, cpu = ExportedRAVE(str(path), device="cuda"), ExportedRAVE(str(path), device="cpu")
    B = art.block_size
    x = load_signal(decode_file(str(wav), SAMPLE_RATE, 1), 1, 1, B).cuda()
    clip = x[..., : -(-int(CLIP_SECONDS * SAMPLE_RATE) // B) * B]
    with torch.inference_mode():
        codes = check_codes(art.model.encoder.rvq, cpu.model.encoder.rvq,
                            art.model.encode(clip), cpu.model.encode(clip.cpu()),
                            "discrete artifact")
    idx_cpu = cpu.encode(clip.cpu(), seed=3)
    y_err = rel_err(art.decode(idx_cpu.cuda(), seed=4).cpu(), cpu.decode(idx_cpu, seed=4))
    check(y_err <= MODEL_TOL, f"discrete artifact card vs CPU: decode {y_err:.3e}")

    budget = B / SAMPLE_RATE * 1e3
    lock = run_lockstep(art, x, 2000, art.load_program("forward"))
    equal = lock.program_equal
    check(equal, f"discrete forward_step.pt2 not bit-equal to the eager steps over "
                 f"{PROGRAM_BLOCKS} blocks")
    served = check_served("discrete", lock, budget)
    return {"export_s": export_s, "generate_s": generate_s, "generate_launches": launches,
            "realtime_factor_generate": n / SAMPLE_RATE / generate_s, **codes,
            "decode_rel_err": y_err, "program_bit_equal": equal, "served": served,
            "block_ms_p50": served["p50_ms"], "block_budget_ms": budget, "path": str(path)}


def _other_family(names) -> dict:
    """One generator step of `names` at B=8 x 131072 on the card (22
    launches, finite), its first pre-warmup step at B=1 on the card against
    the CPU, and the artifact's codec halves (`EncodeSide`, `DecodeSide`)
    of the stepped model, offline, on the card against the CPU. Phase
    `discrete`'s export checks `export_model` and the `.pt2` programs."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.export.artifact import DecodeSide, EncodeSide
    from rave_tpu_torch.export.export import user_latent_size
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps

    cfg = compose(names)
    state = create_train_state(cfg, seed=0, device="cuda")
    x = torch.randn(cfg.data.batch, 1, cfg.data.n_signal, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
    step = build_train_steps(cfg)["gen"]
    step(state, x, False, generator=torch.Generator(device="cuda").manual_seed(7))  # warm
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    m = step(state, x, False, generator=torch.Generator(device="cuda").manual_seed(8))
    torch.cuda.synchronize()
    ms, launches = (time.perf_counter() - t0) * 1e3, dilated_unit.launches
    check(launches == 22 and all(math.isfinite(float(v)) for v in m.values()),
          f"{cfg.latent.family} step: {launches} launches, metrics {m}")
    b1 = _family_steps_b1(names, B1_PROGRAMS[:1])["gen_prewarmup"]
    loss_err = _loss_err(b1["cuda"], b1["cpu"])
    latent_size = user_latent_size(cfg, None, 0.0)
    gpu = state.model.eval()
    cpu = copy.deepcopy(gpu).cpu()
    clip = torch.randn(1, 1, 16 * cfg.block_size(), generator=torch.Generator().manual_seed(5))
    clip = clip * 0.1
    seeds = {dev: (torch.tensor(1, device=dev), torch.tensor(2, device=dev))
             for dev in ("cuda", "cpu")}
    with torch.inference_mode():
        z_gpu = EncodeSide(gpu, cfg, latent_size)(clip.cuda(), seeds["cuda"][0]).cpu()
        z_cpu = EncodeSide(cpu, cfg, latent_size)(clip, seeds["cpu"][0])
        y_gpu = DecodeSide(gpu, cfg, latent_size)(z_cpu.cuda(), seeds["cuda"][1]).cpu()
        y_cpu = DecodeSide(cpu, cfg, latent_size)(z_cpu, seeds["cpu"][1])
    errs = {"encode": rel_err(z_gpu, z_cpu), "decode": rel_err(y_gpu, y_cpu)}
    check(loss_err <= MODEL_TOL and max(errs.values()) <= MODEL_TOL
          and z_gpu.shape[1] == latent_size and bool(torch.isfinite(y_gpu).all()),
          f"{cfg.latent.family} card vs CPU: step losses {loss_err:.3e}, codec {errs}, "
          f"latents {tuple(z_gpu.shape)}")
    return {"step_ms": ms, "launches": launches, "b1_loss_rel_err": loss_err,
            "codec_rel_err": errs, "latent_size": latent_size}


def phase_discrete() -> dict:
    """compose(["discrete"]) at full width; see the module docstring."""
    import torch

    from rave_tpu_torch.config import compose

    t_phase = time.perf_counter()
    work = ROOT / "build" / "discrete"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = compose(["discrete"])
    gen = torch.Generator(device="cuda").manual_seed(40)
    kernel_rows = [kernel_row(gen, "discrete", B, C, T, d, "centered")
                   for B in (BATCH, TRAIN_BATCH) for C, T, dils in DISCRETE_UNITS for d in dils]
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    reset_graph_counts()
    offline = timed("offline", _discrete_offline, cfg)
    train = timed("steps", _discrete_steps, cfg)
    b1 = timed("b1_card_vs_cpu", _family_steps_b1, ["discrete"])
    b1_err = {k: _loss_err(v["cuda"], v["cpu"]) for k, v in b1.items()}
    check(max(b1_err.values()) <= MODEL_TOL, f"discrete B=1 card vs CPU losses {b1_err}")
    loop = timed("loop", _discrete_loop, cfg, work, ROOT / "build" / "loop" / "db")
    export = timed("export", _discrete_export, cfg, loop["run_dir"], work)
    others = {names[-1]: timed(names[-1], _other_family, names)
              for names in (["v2", "wasserstein"], ["v2", "spherical"])}
    portable = timed("portable", export_portable_case, loop["run_dir"], "discrete")
    export["path"] = keep_for_host("discrete", export["path"])  # streamed by phase `host`
    shutil.rmtree(work, ignore_errors=True)
    launches = offline["launches"] + train["launches"] + loop["launches"] + \
        export["generate_launches"] + sum(o["launches"] for o in others.values())
    graphed = timed("graphed", family_lockstep, cfg, (0, 0), "discrete", 22)
    out = {"kernel_rows": kernel_rows, "offline": offline, "train": train,
           "graphed_steps": graphed,
           "b1_loss_rel_err": b1_err, "loop": {k: v for k, v in loop.items() if k != "run_dir"},
           "export": export, "others": others, "launches": launches, "part_seconds": seconds,
           "portable": portable,
           "graphs": graphs_line("discrete", {"discrete": export["block_ms_p50"]},
                                 {"discrete": export["block_budget_ms"]}),
           "seconds": time.perf_counter() - t_phase}
    print(f"discrete: units at C=768 T=256 kernel/plain ms {shape_summary(kernel_rows)} (max rel "
          f"err {max(r['rel_err'] for r in kernel_rows):.2e} <= {KERNEL_TOL}); forward B={BATCH} x "
          f"{N_SIGNAL} {offline['forward_ms']:.2f} ms = {offline['realtime_factor']:.1f}x "
          f"realtime, 22 launches; B=1 x 65536 card vs CPU: {codes_summary(offline)}, decode "
          f"{offline['decode_rel_err']:.2e}",
          flush=True)
    print(f"discrete steps B={TRAIN_BATCH} x {N_SIGNAL}: ms "
          + ", ".join(f"{k} {v:.1f} (x{train['steps'][k]})"
                      for k, v in train["ms_per_step"].items())
          + " (each: " + "; ".join(f"{k} " + ", ".join(f"{t:.1f}" for t in v)
                                   for k, v in train["step_ms"].items()) + ")"
          + f"; peak {train['peak_gb']:.2f} GiB; codebook perplexity "
          f"{train['codebook_perplexity']:.1f}, usage {train['codebook_usage']:.3f}; B=1 card vs "
          f"CPU losses " + ", ".join(f"{k} {v:.1e}" for k, v in b1_err.items())
          + f"; loop {DISCRETE_LOOP_STEPS} steps resumed to {DISCRETE_RESUME_STEPS} bit-equal "
          f"(codebooks, inited), checkpoints {loop['checkpoints']}, eval "
          f"{loop['eval']['spectral_distance']}", flush=True)
    print(f"discrete export: {export['export_s']:.1f} s; generate 30 s "
          f"{export['realtime_factor_generate']:.1f}x end to end, 22 launches; artifact card vs "
          f"CPU {codes_summary(export)}, decode {export['decode_rel_err']:.2e}"
          f"; forward_step.pt2 bit-equal over {PROGRAM_BLOCKS} blocks, the served forward "
          f"bit-equal to the eager steps across a reset; streaming p50 served "
          f"{export['block_ms_p50']['graph']:.3f} ms, .pt2 served "
          f"{export['block_ms_p50']['program']:.3f} ms, eager "
          f"{export['block_ms_p50']['eager']:.3f} ms, .pt2 eager "
          f"{export['block_ms_p50']['program_eager']:.3f} ms (budget "
          f"{export['block_budget_ms']:.2f} ms); "
          + "; ".join(f"{k}: step {o['step_ms']:.1f} ms, B=1 losses {o['b1_loss_rel_err']:.1e}, "
                      f"codec {o['codec_rel_err']['encode']:.1e} / "
                      f"{o['codec_rel_err']['decode']:.1e}" for k, o in others.items())
          + f"; {launches} launches on the path; phase {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ")", flush=True)
    return out


# the v3 phase: Snake units bypass the kernel (launches 0 everywhere on this path)
V3_PREWARMUP, V3_CYCLES = 2, 2  # steps of each precision: 2 pre-warmup, then 2 x 4 warmed
V3_LOOP = ["train.phase_1_duration=2", "train.update_discriminator_every=2", "train.ema=0.999"]
V3_LOOP_STEPS, V3_RESUME_STEPS, V3_VAL_EVERY = 4, 6, 2
V3_ADAIN_BLOCKS = 4  # streaming blocks that learn each statistic
V3_ATTRIBUTES = ["learn_target", "reset_target", "learn_source", "reset_source"]
V3_CRITIC_ITERS = 3
# a free-running AdaIN stream: the card's outputs with cuDNN off no further from a float64
# run of its own fixed kernels than this many times the CPU's from its own (0.14-1.34x
# read on an NVIDIA H100), or than FREE_FLOOR where both are at float32's rounding; the
# served stream's error over the later half of the transfer's read blocks no more than
# this many times its earlier half's (PERF.md section 6)
FREE_DRIFT, FREE_FLOOR = 3.0, 1e-5
# the transfer's blocks read for growth: those past the stream's reach (the receptive
# field's left side plus the delay), which see only transferred input
V3_READ_BLOCKS = 8


def learn_adain(model, cfg, target, source) -> None:
    """AdaIN's statistics learned as an artifact's `set_learn_target` /
    `set_learn_source` learn them: `target`, then `source` ([1, 1, n *
    block] waveforms) streamed through the model with the flag of each on;
    learning off after, so that in eval mode the transfer acts."""
    import torch

    from rave_tpu_torch.models.blocks import AdaIN
    from rave_tpu_torch.nn.streaming import init_stream_state

    adains = [m for m in model.modules() if isinstance(m, AdaIN)]
    block = cfg.block_size()
    with torch.no_grad():
        for side, clip in (("y", target), ("x", source)):
            for m in adains:
                setattr(m, f"learn_{side}", torch.ones_like(m.learn_y))
                m.learning = True
            init_stream_state(model, 1)
            for i in range(0, clip.shape[-1], block):
                z = model.step_encode(clip[..., i:i + block])
                model.step_decode(z[:, :cfg.latent_size])
            for m in adains:
                setattr(m, f"learn_{side}", torch.zeros_like(m.learn_y))
                m.learning = False
    init_stream_state(model, 1)


def as_float64(art):
    """An `ExportedRAVE` turned into float64: its model, its codec halves
    (which hold the latent PCA) and its state."""
    for module in (art.model, art.encode_side, art.decode_side):
        module.double()
    art.state = [s.double() if s.is_floating_point() else s for s in art.state]
    return art


def float64_twin(art, device: str = "cpu"):
    """`art` in float64 on `device`, with `art`'s own fixed kernels: each
    device fixes them from (v, g) in its own float32 arithmetic
    (`freeze_weights`), so the card's and the CPU's differ in the last bits."""
    from rave_tpu_torch.export.artifact import ExportedRAVE

    twin = ExportedRAVE(str(art.path), device=device)
    twin.model.load_state_dict({k: v.to(device) for k, v in art.model.state_dict().items()})
    return as_float64(twin)


def adain_stream(art, segments: dict, seed0: int = 500, seeds=None) -> dict:
    """The AdaIN attributes driven free over one stream from a fresh state,
    as a live user drives them: `segments` {"learn_target", "learn_source",
    "transfer"} ([1, 1, n * block], on the artifact's device and dtype) go
    through `forward(streaming=True)` block by block, learning the target,
    then the source, then transferring, the i-th block of the stream with
    seed `seeds[i]` (default seed0 + i): {segment: outputs} and the AdaIN
    state after, each flat on the CPU in float64."""
    import torch

    B, i = art.block_size, 0
    art.reset_target()
    art.reset_source()
    art.reset_stream()
    out = {}
    for name, flags in (("learn_target", (True, False)), ("learn_source", (False, True)),
                        ("transfer", (False, False))):
        art.set_learn_target(flags[0])
        art.set_learn_source(flags[1])
        ys, signal = [], segments[name]
        for t in range(0, signal.shape[-1], B):
            seed = seed0 + i if seeds is None else seeds[i]
            ys.append(art.forward(signal[..., t:t + B], streaming=True, seed=seed).cpu())
            i += 1
        out[name] = torch.cat(ys, -1).double().reshape(-1)
    out["adain_state"] = torch.cat([art.state[j].cpu().double().reshape(-1)
                                    for j in art.adain_indices])
    return out


def _v3_offline(cfg) -> dict:
    """B=16 x 131072 forwards (timed; training mode: AdaIN keeps statistics
    for 8 batch slots, as JAX's and the reference's, so an eval batch holds
    at most 8) and B=8 in eval mode with AdaIN's statistics learned from a
    seeded target and source (timed); no unit launch in either; at B=1 x
    65536 in eval mode the card against the CPU, and the transfer acting
    (training mode differs)."""
    import torch

    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.steps import draw_noise

    cpu_model = build_rave(cfg, seed=0, device="cpu")
    clips = torch.randn(2, 1, 1, V3_ADAIN_BLOCKS * cfg.block_size(),
                        generator=torch.Generator().manual_seed(30))
    learn_adain(cpu_model, cfg, clips[0] * 0.03, clips[1] * 0.2)
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    draws = draw_noise(cfg, x, gen)
    out = {}
    with torch.inference_mode():
        for mode, b in (("train", BATCH), ("eval", TRAIN_BATCH)):
            model.train(mode == "train")
            xb, db = x[:b], draws.to("cuda")
            db.eps = db.eps[:b]
            model(xb, db)  # warm
            torch.cuda.synchronize()
            reset_counts()
            y = model(xb, db)
            torch.cuda.synchronize()
            launches = dilated_unit.launches
            check(tuple(y.shape) == (b, 1, N_SIGNAL) and bool(torch.isfinite(y).all())
                  and launches == 0 and dilated_unit.launches_bf16 == 0,
                  f"v3 {mode} forward {tuple(y.shape)}, {launches} unit launches (expected 0)")
            t0 = time.perf_counter()
            for _ in range(5):
                model(xb, db)
            torch.cuda.synchronize()
            sec = (time.perf_counter() - t0) / 5
            out[mode] = {"batch": b, "launches": launches, "forward_ms": sec * 1e3,
                         "realtime_factor": b * N_SIGNAL / SAMPLE_RATE / sec}
        n = 65536
        xb = torch.randn(1, 1, n, generator=torch.Generator().manual_seed(2)) * 0.1
        eb = draw_noise(cfg, xb, torch.Generator().manual_seed(3))
        model.eval(), cpu_model.eval()
        y_cpu, y_gpu = cpu_model(xb, eb), model(xb.cuda(), eb.to("cuda")).cpu()
        err = rel_err(y_gpu, y_cpu)
        transfer = rel_err(model.train()(xb.cuda(), eb.to("cuda")).cpu(), y_gpu)
    check(err <= MODEL_TOL and transfer > 1e-2,
          f"v3 B=1 eval card vs CPU {err:.3e} (<= {MODEL_TOL}); training mode differs by "
          f"{transfer:.3e} (> 1e-2: AdaIN's transfer acts in eval mode)")
    return {**out, "b1_rel_err": err, "transfer_rel_change": transfer}


def _critic_ms(cfg) -> dict:
    """The descript critic alone, forward and backward on the 16-row real+fake
    batch of a B=8 step, device ms by CUDA events (`cuda_ms`): whole, its
    MPDs and its MRDs (the parts on the critic's normalized input)."""
    import torch

    from rave_tpu_torch.factory import build_discriminator

    critic = build_discriminator(cfg, seed=1, device="cuda")
    xy = torch.randn(2 * TRAIN_BATCH, 1, N_SIGNAL, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(4)) * 0.1
    xn = xy - xy.mean(-1, keepdim=True)
    xn = 0.8 * xn / (xn.abs().amax(-1, keepdim=True) + 1e-9)
    mpds = [m for n, m in critic.named_children() if n.startswith("mpd")]
    mrds = [m for n, m in critic.named_children() if n.startswith("mrd")]

    def fwd_bwd(feature_lists):
        def run():
            critic.zero_grad(set_to_none=True)
            sum(fm[-1].mean() for fm in feature_lists()).backward()
        return run

    return {"all": cuda_ms(fwd_bwd(lambda: critic(xy)), V3_CRITIC_ITERS),
            "mpd": cuda_ms(fwd_bwd(lambda: [m(xn) for m in mpds]), V3_CRITIC_ITERS),
            "mrd": cuda_ms(fwd_bwd(lambda: [m(xn) for m in mrds]), V3_CRITIC_ITERS)}


def _v3_steps(cfg) -> dict:
    """The receptive-field probe, then fp32 and `train.bf16` + `bf16_dis`
    steps of the three programs at B=8 x 131072 (`_train_run`, no unit
    launch), the fp32 programs eager and through `TrainGraphs`
    (`family_lockstep`, bit-equal), the first step of each program at B=1 on
    the card against the CPU, and the critic's fwd+bwd split."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.analysis import crop_frames, receptive_field

    reset_counts()
    rf = receptive_field(cfg, device="cuda")
    check(dilated_unit.launches == 0, f"v3 receptive-field probe: {dilated_unit.launches} launches")
    crop = crop_frames(cfg, rf)
    x = torch.randn(TRAIN_BATCH, 1, N_SIGNAL, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
    runs = {}
    for kind, extra in (("fp32", []), ("bf16", ["train.bf16=true", "train.bf16_dis=true"])):
        runs[kind] = _train_run(compose(["v3"], extra), crop, x, bf16=kind == "bf16",
                                per_step=0, prewarmup=V3_PREWARMUP, cycles=V3_CYCLES)
    graphed = family_lockstep(cfg, crop, "v3", 0)
    b1 = _family_steps_b1(["v3"])
    b1_err = {k: _loss_err(v["cuda"], v["cpu"]) for k, v in b1.items()}
    check(max(b1_err.values()) <= MODEL_TOL, f"v3 B=1 card vs CPU losses {b1_err}")
    return {"rf": list(rf), "crop_frames": list(crop), "runs": runs, "b1_loss_rel_err": b1_err,
            "critic_fwd_bwd_ms": _critic_ms(cfg), "graphed_steps": graphed}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, no autotuning; both put back on exit."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _v3_loop(work: Path, db: Path) -> dict:
    """`cli train --config v3` on phase `loop`'s store: a short warmup and a
    critic step every other step, validation every other step, resumed once
    (the restored state, AdaIN's buffers included, bit-equal to its
    checkpoint); `cli eval` twice, equal. AdaIN's calls are recorded with the
    model's mode: training in the steps, eval in validation, eval and the
    probe."""
    import collections

    import torch

    from rave_tpu_torch.models.blocks import AdaIN
    from rave_tpu_torch.train import loop
    from rave_tpu_torch.utils import checkpoint

    common = ["--config", "v3", "--db_path", db, "--out_path", work / "runs", "--batch",
              TRAIN_BATCH, "--n_signal", N_SIGNAL, "--device", "cuda", "--val_every",
              V3_VAL_EVERY, "--save_every", 1000, "--device_data", "on", "--name", "v3"]
    for o in V3_LOOP:
        common += ["--override", o]
    modes, where = collections.Counter(), ["step"]
    forward = AdaIN.forward

    def recorded(self, x):
        modes[(where[-1], "train" if self.training else "eval")] += 1
        return forward(self, x)

    def labelled(label, fn):
        def call(*args, **kwargs):
            where.append(label)
            try:
                return fn(*args, **kwargs)
            finally:
                where.pop()
        return call

    AdaIN.forward = recorded
    try:
        # deterministic cuDNN: one tree trains one set of weights, and phase v3's
        # free-running drift check reads one ratio (ROADMAP C15)
        with LoopProbe() as probe, deterministic_cudnn():
            loop.run_validation = labelled("validation", loop.run_validation)
            loop.receptive_field = labelled("probe", loop.receptive_field)
            out = _cli(["train", "--max_steps", V3_LOOP_STEPS, *common])
            run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
            first = probe.take()
            out2 = _cli(["train", "--max_steps", V3_RESUME_STEPS, *common])
            resumed = probe.take()
        before = LoopProbe.counts()
        where.append("eval")
        evals = [json.loads(_cli(["eval", "--run", run_dir, "--db_path", db, "--split", "val",
                                  "--device", "cuda"]).strip().splitlines()[-1])
                 for _ in range(2)]
    finally:
        AdaIN.forward = forward
    eval_launches = LoopProbe.counts()[0] - before[0]
    _check_steps(first, "fp32", 0, V3_LOOP_STEPS, per_step=0)
    _check_steps(resumed, "fp32", V3_LOOP_STEPS, V3_RESUME_STEPS, per_step=0)
    check(f"resumed at step {V3_LOOP_STEPS}" in out2, "the v3 run did not resume")
    phases = {e["phase"] for e in first if e["kind"] == "step"}
    check(phases == {"gen_prewarmup", "gen_adversarial", "dis"}, f"v3 phases {phases}")
    check(modes[("step", "eval")] == 0 and modes[("step", "train")] > 0
          and modes[("validation", "train")] == 0 and modes[("validation", "eval")] > 0
          and modes[("eval", "train")] == 0 and modes[("eval", "eval")] > 0
          and modes[("probe", "train")] == 0, f"AdaIN calls by (where, mode): {dict(modes)}")
    restores = [e for e in resumed if e["kind"] == "restore" and "state" in e]
    check(len(restores) == 1, f"v3 restores {len(restores)}")
    saved = torch.load(restores[0]["path"], map_location="cpu", weights_only=True)
    bad = unequal(restores[0]["state"], saved)
    adain = [k for k in saved["model"] if k.rsplit(".", 1)[-1] in AdaIN.STATE]
    check(not bad and len(adain) == 22 * len(AdaIN.STATE),
          f"v3 restore not bit-equal ({bad[:5]}) or {len(adain)} AdaIN buffers")
    check(evals[0] == evals[1] and all(math.isfinite(evals[0][k]) for k in EVAL_METRICS)
          and eval_launches == 0, f"v3 eval {evals} ({eval_launches} launches)")
    ckpts = [checkpoint.checkpoint_step(p) for p in checkpoint.list_checkpoints(str(run_dir))]
    return {"run_dir": run_dir, "checkpoints": ckpts, "eval": evals[0],
            "adain_calls": {f"{k[0]}/{k[1]}": v for k, v in modes.items()},
            "launches": sum(e["fp32"] + e["bf16"] for e in first + resumed) + eval_launches,
            "step_ms": loop_ms(first + resumed),
            "validation_ms": [e["ms"] for e in first + resumed if e["kind"] == "validation"],
            "save_s": [e["ms"] / 1e3 for e in first + resumed if e["kind"] == "save"]}


def _v3_export(run_dir: Path, work: Path) -> dict:
    """`cli export --streaming` of the loop's run and `cli generate` of a 30 s
    file; the AdaIN attributes driven on the artifact on the card and on the
    CPU alike (learn a target, learn a source, transfer; each call on the
    card from the CPU's state, against the CPU's call); the
    `.pt2` forward bit-equal to the eager steps over 32 blocks while the
    target learns, AdaIN's state included; the resets bring the identity
    back; the streaming p50 against the block's budget."""
    import torch

    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.analysis import receptive_field

    t0 = time.perf_counter()
    text = _cli(["export", "--run", run_dir, "--streaming", "--output", work / "export",
                 "--device", "cuda"])
    export_s = time.perf_counter() - t0
    path = Path(text.strip().splitlines()[-1].removeprefix("exported: "))
    manifest = json.loads((path / "manifest.json").read_text())
    leaves = manifest["aot"]["forward_step"]["state_leaves"]
    check(manifest["attributes"] == V3_ATTRIBUTES and all(
        sum(n.endswith(op["leaf"]) for n in leaves) == 22
        for ops in manifest["attribute_ops"].values() for op in ops),
        f"v3 manifest attributes {manifest['attributes']}, ops {manifest['attribute_ops']}")
    wav = work / "v3_in.wav"
    n = write_signal(wav, EXPORT_SECONDS, seed=23)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    _cli(["generate", "--model", path, "--input", wav, "--out_path", work / "generated",
          "--device", "cuda"])
    torch.cuda.synchronize()
    generate_s, launches = time.perf_counter() - t0, dilated_unit.launches
    check(launches == 0, f"v3 generate: {launches} unit launches, expected 0")

    art, cpu = ExportedRAVE(str(path), device="cuda"), ExportedRAVE(str(path), device="cpu")
    B = art.block_size
    x = load_signal(decode_file(str(wav), SAMPLE_RATE, 1), 1, 1, B).cuda()
    k = V3_ADAIN_BLOCKS * B
    target, source, clip = x[..., :k] * 0.3, x[..., k:2 * k], x[..., 2 * k:4 * k]
    identity = art.forward(clip, seed=3)

    # Each call on the card starts from the CPU artifact's state, so that the
    # card is held to the CPU call by call at 1e-3: in a free-running stream
    # each device learns its own statistics, which the transfer divides by;
    # that stream is held below against float64 runs
    def same_state():
        art.state = [s.to("cuda") for s in cpu.state]

    def adain_err():
        return rel_err(torch.cat([art.state[i].cpu().reshape(-1) for i in art.adain_indices]),
                       torch.cat([cpu.state[i].reshape(-1) for i in cpu.adain_indices]),
                       1e-6)

    def stream(signal, seed0):
        y_err = state_err = 0.0
        for i in range(0, signal.shape[-1], B):
            same_state()
            y_gpu = art.forward(signal[..., i:i + B], streaming=True, seed=seed0 + i).cpu()
            y_cpu = cpu.forward(signal[..., i:i + B].cpu(), streaming=True, seed=seed0 + i)
            y_err, state_err = max(y_err, rel_err(y_gpu, y_cpu)), max(state_err, adain_err())
        return {"y": y_err, "adain_state": state_err}

    errs = {}
    for a in (art, cpu):
        a.set_learn_target(True)
    errs["learn_target"] = stream(target, 100)
    for a in (art, cpu):
        a.set_learn_target(False)
        a.set_learn_source(True)
    errs["learn_source"] = stream(source, 200)
    for a in (art, cpu):
        a.set_learn_source(False)
    errs["transfer_stream"] = stream(clip, 300)
    same_state()
    y_gpu = art.forward(clip, seed=3)
    errs["transfer_offline"] = {"y": rel_err(y_gpu.cpu(), cpu.forward(clip.cpu(), seed=3))}
    moved = rel_err(y_gpu, identity)
    check(max(v for e in errs.values() for v in e.values()) <= MODEL_TOL and moved > 1e-2,
          f"v3 artifact card vs CPU per call {errs} (<= {MODEL_TOL}); the transfer moved the "
          f"output {moved:.3e} (> 1e-2)")

    # the served forward, its eager twin and the .pt2 (direct and served) in lockstep
    # while the target learns, a reset_stream halfway; then the target's learning
    # off and reset, a few blocks more
    art.set_learn_target(True)
    lock = run_lockstep(art, x, 2000, art.load_program("forward"))
    equal = lock.program_equal
    learned = [float(art.state[i]) for i in art.adain_indices
               if art.slots[i][2] == "num_update_y"]
    check(equal and learned == [float(V3_ADAIN_BLOCKS + PROGRAM_BLOCKS)] * 22,
          f"v3 forward_step.pt2 not bit-equal to the eager steps over {PROGRAM_BLOCKS} blocks "
          f"({equal}) or the target's updates {learned[:3]}...")
    lock.attribute("set_learn_target", False)
    lock.attribute("reset_target")
    for i in range(PROGRAM_BLOCKS, PROGRAM_BLOCKS + V3_ADAIN_BLOCKS):
        lock.block(x[..., i * B:(i + 1) * B], 2000 + i)
    budget = B / SAMPLE_RATE * 1e3
    lockstep = check_served("v3", lock, budget)
    art.set_learn_target(False)
    art.reset_target()
    art.reset_source()
    back = rel_err(art.forward(clip, seed=3), identity)
    check(back <= 1e-6, f"v3 reset: offline forward {back:.3e} from the identity")

    # The same calls free-running from a fresh state, as a live user drives
    # them, each against a float64 run of its own fixed kernels on the CPU
    # (each device fixes them in float32, a few ulps apart). With cuDNN off,
    # the card's outputs no further than FREE_DRIFT x the CPU's. As the card
    # serves, with cuDNN, the transfer amplifies cuDNN's float32 rounding
    # 2-25x further than the CPU's, by the trained weights (PERF.md section
    # 6): there the error must not grow over the transfer's blocks. A block
    # output within the stream's reach of the transfer's start still sees
    # the learning segments, so the growth is read over the V3_READ_BLOCKS
    # blocks past it.
    left, _ = receptive_field(art.cfg, device="cuda")
    settle = -(-(left + manifest["latency"]["total_samples"]) // B)
    n_blocks = settle + V3_READ_BLOCKS
    transfer = x[..., 2 * k:2 * k + n_blocks * B]
    check(transfer.shape[-1] == n_blocks * B, f"v3: {x.shape[-1]} samples hold no "
                                              f"{n_blocks}-block transfer")
    segments = {"learn_target": target, "learn_source": source, "transfer": transfer}
    on_cpu = {k: v.cpu() for k, v in segments.items()}
    in_f64 = {k: v.double() for k, v in on_cpu.items()}
    ref = {"card": adain_stream(float64_twin(art), in_f64),
           "cpu": adain_stream(float64_twin(cpu), in_f64)}
    served, cpu_run = adain_stream(art, segments), adain_stream(cpu, on_cpu)
    captured = len(art.graphs["forward"].graphs)
    enabled, torch.backends.cudnn.enabled = torch.backends.cudnn.enabled, False
    try:
        plain = adain_stream(art, segments)
    finally:
        torch.backends.cudnn.enabled = enabled
    # the cuDNN-off stream replayed a graph of its own, captured with cuDNN off
    cudnn_off = [k for k in art.graphs["forward"].graphs if not k[3][0]]
    new = len(art.graphs["forward"].graphs) - captured
    check(new == 1 and len(cudnn_off) == 1, f"v3: {new} graphs captured for the cuDNN-off "
                                            f"stream, {len(cudnn_off)} keyed cuDNN off")
    drift = {k: {"card": rel_err(served[k], v), "card_cudnn_off": rel_err(plain[k], v),
                 "cpu": rel_err(cpu_run[k], ref["cpu"][k])} for k, v in ref["card"].items()}
    blocks = [rel_err(a, b) for a, b in zip(served["transfer"].reshape(n_blocks, -1),
                                            ref["card"]["transfer"].reshape(n_blocks, -1))]
    read = blocks[settle:]
    half = len(read) // 2
    drift_ratio = max(read[half:]) / max(read[:half])
    check(all(drift[k]["card_cudnn_off"] <= max(FREE_DRIFT * drift[k]["cpu"], FREE_FLOOR)
              for k in segments) and drift_ratio <= FREE_DRIFT,
          f"v3 artifact free-running from float64 {drift} (the card with cuDNN off over "
          f"{FREE_DRIFT}x the CPU?), the served transfer by block {blocks}, read past block "
          f"{settle} (grows?)")
    kernels = max(rel_err(v.cpu(), cpu.model.state_dict()[k], 1e-30)
                  for k, v in art.model.state_dict().items() if k.endswith(".w"))
    return {"export_s": export_s, "generate_s": generate_s, "generate_launches": launches,
            "realtime_factor_generate": n / SAMPLE_RATE / generate_s, "card_vs_cpu": errs,
            "free_stream_vs_float64": drift, "free_transfer_by_block": blocks,
            "free_transfer_settle_blocks": settle, "free_drift_ratio": drift_ratio,
            "fixed_kernels_card_vs_cpu": kernels,
            "transfer_rel_change": moved,
            "reset_rel_err": back, "program_bit_equal": equal, "served": lockstep,
            "cudnn_off_graphs": len(cudnn_off), "block_ms_p50": lockstep["p50_ms"],
            "block_budget_ms": budget, "path": str(path)}


def _v3_discrete() -> dict:
    """compose(["discrete_v3"]): the B=16 forward (timed); at B=8 x 131072 the
    k-means step apart, then one step of each program (no unit launch); the
    first step of each program at B=1 on the card against the CPU; and the
    codes of a B=1 x 65536 clip on the card against the CPU."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise, pick_phase

    cfg = compose(["discrete_v3"])
    cpu_model = build_rave(cfg, seed=0, device="cpu").eval()
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    draws = draw_noise(cfg, x, gen)
    with torch.inference_mode():
        model(x, draws)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(5):
            y = model(x, draws)
        torch.cuda.synchronize()
        forward_s = (time.perf_counter() - t0) / 5
        launches = dilated_unit.launches
        check(tuple(y.shape) == (BATCH, 1, N_SIGNAL) and bool(torch.isfinite(y).all())
              and launches == 0, f"discrete_v3 forward {tuple(y.shape)}, {launches} launches")
        xb = torch.randn(1, 1, 65536, generator=torch.Generator().manual_seed(2)) * 0.1
        codes = check_codes(model.encoder.rvq, cpu_model.encoder.rvq, model.encode(xb.cuda()),
                            cpu_model.encode(xb), "discrete_v3")

    state = create_train_state(cfg, seed=0, device="cuda")
    steps = build_train_steps(cfg)
    xt = x[:TRAIN_BATCH]
    noise = torch.Generator(device="cuda").manual_seed(7)
    step_ms = {}
    for name in ("kmeans", "gen_prewarmup", "dis", "gen_adversarial"):
        if name == "dis":
            state.step = cfg.train.phase_1_duration
        which, warmed, quantize = pick_phase(cfg, state.step)
        check(which == ("dis" if name == "dis" else "gen"), f"discrete_v3 {name}: {which}")
        torch.cuda.synchronize()
        dilated_unit.launches = 0
        t0 = time.perf_counter()
        m = (steps["dis"](state, xt, generator=noise, quantize=quantize) if which == "dis"
             else steps["gen"](state, xt, warmed, generator=noise, quantize=quantize))
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t0) * 1e3
        check(dilated_unit.launches == 0 and all(math.isfinite(float(v)) for v in m.values()),
              f"discrete_v3 {name} step: {dilated_unit.launches} launches, metrics {m}")
    b1 = _family_steps_b1(["discrete_v3"])
    b1_err = {k: _loss_err(v["cuda"], v["cpu"]) for k, v in b1.items()}
    check(max(b1_err.values()) <= MODEL_TOL, f"discrete_v3 card vs CPU: B=1 losses {b1_err}")
    return {"forward_ms": forward_s * 1e3,
            "realtime_factor": BATCH * N_SIGNAL / SAMPLE_RATE / forward_s,
            "step_ms": step_ms, "b1_loss_rel_err": b1_err, **codes}


def phase_v3() -> dict:
    """compose(["v3"]) and compose(["discrete_v3"]) at full width; see the module docstring."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit

    t_phase = time.perf_counter()
    work = ROOT / "build" / "v3"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = compose(["v3"])
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return result

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    reset_graph_counts()
    offline = timed("offline", _v3_offline, cfg)
    train = timed("steps", _v3_steps, cfg)
    loop = timed("loop", _v3_loop, work, ROOT / "build" / "loop" / "db")
    export = timed("export", _v3_export, loop["run_dir"], work)
    discrete = timed("discrete_v3", _v3_discrete)
    portable = timed("portable", export_portable_case, loop["run_dir"], "v3")
    export["path"] = keep_for_host("v3", export["path"])  # streamed by phase `host`
    shutil.rmtree(work, ignore_errors=True)
    launches = (sum(o["launches"] for o in (offline["train"], offline["eval"]))
                + sum(r["launches"] for r in train["runs"].values()) + loop["launches"]
                + export["generate_launches"])
    check(launches == 0, f"{launches} unit launches on the v3 path, expected 0")
    out = {"offline": offline, "train": train,
           "loop": {k: v for k, v in loop.items() if k != "run_dir"}, "export": export,
           "discrete_v3": discrete, "launches": launches, "part_seconds": seconds,
           "portable": portable,
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
           "graphs": graphs_line("v3", {"v3": export["block_ms_p50"]},
                                 {"v3": export["block_budget_ms"]}),
           "seconds": time.perf_counter() - t_phase}
    runs, crit = train["runs"], train["critic_fwd_bwd_ms"]
    print(f"v3: forward B={BATCH} x {N_SIGNAL} (training mode) {offline['train']['forward_ms']:.2f}"
          f" ms = {offline['train']['realtime_factor']:.1f}x realtime, B={TRAIN_BATCH} eval with "
          f"learned AdaIN {offline['eval']['forward_ms']:.2f} ms; B=1 eval card vs CPU "
          f"{offline['b1_rel_err']:.2e}; 0 unit launches (Snake bypasses the kernel); steps "
          f"B={TRAIN_BATCH} x {N_SIGNAL} ms " + "; ".join(
              f"{kind} " + ", ".join(f"{k} {v:.1f} (x{r['steps'][k] - 1})"
                                     for k, v in r["ms_per_step"].items())
              + f", peak {r['peak_gb']:.2f} GiB" for kind, r in runs.items())
          + "; B=1 card vs CPU losses " + ", ".join(
              f"{k} {v:.1e}" for k, v in train["b1_loss_rel_err"].items())
          + f"; critic fwd+bwd (16 rows, device) {crit['all']:.2f} ms: MPDs {crit['mpd']:.2f}, "
          f"MRDs {crit['mrd']:.2f}", flush=True)
    print(f"v3 loop: {V3_LOOP_STEPS} steps resumed to {V3_RESUME_STEPS} bit-equal (AdaIN "
          f"included), checkpoints {loop['checkpoints']}, AdaIN calls {loop['adain_calls']}, "
          f"eval {loop['eval']['spectral_distance']} (twice); export {export['export_s']:.1f} s; "
          f"generate 30 s {export['realtime_factor_generate']:.1f}x end to end; attributes, "
          f"card vs CPU per call: " + ", ".join(
              f"{k} " + " / ".join(f"{v:.1e}" for v in e.values())
              for k, e in export["card_vs_cpu"].items())
          + "; free-running from float64, card / card with cuDNN off / CPU: " + ", ".join(
              f"{k} {e['card']:.1e} / {e['card_cudnn_off']:.1e} / {e['cpu']:.1e}"
              for k, e in export["free_stream_vs_float64"].items())
          + ", the served transfer by block " + " ".join(
              f"{e:.1e}" for e in export["free_transfer_by_block"])
          + f" (past block {export['free_transfer_settle_blocks']}, later / earlier half "
          f"{export['free_drift_ratio']:.2f}x, <= {FREE_DRIFT})"
          + f" (fixed kernels card vs CPU {export['fixed_kernels_card_vs_cpu']:.1e})"
          + f"; transfer moved {export['transfer_rel_change']:.2e}, reset back "
          f"{export['reset_rel_err']:.1e}; forward_step.pt2 bit-equal over {PROGRAM_BLOCKS} "
          f"blocks, the served forward bit-equal to the eager steps over "
          f"{export['served']['blocks']} blocks across a reset and the target's learning off "
          f"and reset, {export['cudnn_off_graphs']} graph captured with cuDNN off for its "
          f"stream; streaming p50 served {export['block_ms_p50']['graph']:.3f} ms, .pt2 served "
          f"{export['block_ms_p50']['program']:.3f} ms, eager "
          f"{export['block_ms_p50']['eager']:.3f} ms, .pt2 eager "
          f"{export['block_ms_p50']['program_eager']:.3f} ms (budget "
          f"{export['block_budget_ms']:.2f}"
          f" ms)", flush=True)
    print(f"discrete_v3: forward B={BATCH} {discrete['forward_ms']:.2f} ms = "
          f"{discrete['realtime_factor']:.1f}x realtime; steps B={TRAIN_BATCH} ms "
          + ", ".join(f"{k} {v:.1f}" for k, v in discrete["step_ms"].items())
          + "; B=1 card vs CPU losses " + ", ".join(
              f"{k} {v:.1e}" for k, v in discrete["b1_loss_rel_err"].items())
          + f"; B=1 x 65536 {codes_summary(discrete)}; {launches} unit launches on the "
          f"v3 path; phase {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ")", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase `portable`: the portable full graph (export/portable.py) of the runs
# phases `v1` (the loop's v2 run), `discrete` and `v3` export, run by a
# consumer that imports torch alone (tools/torch_portable_run.py)
# ---------------------------------------------------------------------------

PORTABLE_DIR = ROOT / "build" / "portable"  # one folder per case, deleted by phase `portable`
PORTABLE_TOL, PORTABLE_SEED, PORTABLE_ITERS = 1e-5, 97, 5
PORTABLE_CONSUMER = ROOT / "tools" / "torch_portable_run.py"
UNIT_OP = "rave_tpu_torch::dilated_unit"


def portable_plans(path: Path) -> list:
    """The plan of each unit node of `path`'s forward.ts, in graph order."""
    import torch

    plans = []
    for node in torch.jit.load(str(path / "forward.ts"), map_location="cpu").inlined_graph.nodes():
        if node.kind() == UNIT_OP:
            plan = node.inputsAt(6)
            if plan.node().kind() == "prim::ListConstruct":
                plans.append([v.toIValue() for v in plan.node().inputs()])
            else:
                plans.append(list(plan.toIValue()))
    return plans


def export_portable_case(run_dir: Path, case: str, batch: int = 1,
                         n_signal: int = N_SIGNAL) -> dict:
    """`cli export_onnx --batch --n_signal` of `run_dir` on the card (the
    .onnx where the run has one, and the portable program, moved to
    build/portable/<case>), then the live model's forward (`PortableForward`,
    the ctypes kernel) on the card on a seeded input and seed, TF32 off,
    saved beside the program as check.pt for phase `portable`; the export's
    seconds."""
    import torch

    from rave_tpu_torch.export.portable import PortableForward
    from rave_tpu_torch.train.loop import fp32_exact
    from rave_tpu_torch.utils.checkpoint import load_run

    out = PORTABLE_DIR / f"{case}.out"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = _cli(["export_onnx", "--run", run_dir, "--output", out, "--batch", batch,
                 "--n_signal", n_signal, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    path = PORTABLE_DIR / case
    shutil.rmtree(path, ignore_errors=True)
    shutil.move(text.strip().splitlines()[-1].removeprefix("exported: "), path)
    shutil.rmtree(out, ignore_errors=True)
    manifest = json.loads((path / "manifest.json").read_text())
    check(manifest["input"][0] == batch and manifest["input"][-1] == n_signal,
          f"{case}: the portable program takes {manifest['input']}")
    cfg, model, n_channels, _ = load_run(str(run_dir), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(PORTABLE_SEED)
    x = 0.3 * torch.randn(batch, n_channels, n_signal, device="cuda", generator=gen)
    seed = torch.tensor(PORTABLE_SEED, dtype=torch.int64, device="cuda")
    with torch.no_grad(), fp32_exact():
        y = PortableForward(model, cfg)(x, seed)
    torch.save({"x": x.cpu(), "seed": seed.cpu(), "y": y.cpu()}, path / "check.pt")
    del model
    torch.cuda.empty_cache()
    return {"path": str(path.relative_to(ROOT)), "batch": batch, "n_signal": n_signal,
            "units": manifest["units"], "plans": portable_plans(path), "export_s": seconds,
            "mib": sum(f.stat().st_size for f in path.iterdir()) / 2**20}


def op_row(gen, B: int, C: int, T: int, d: int, mode: str) -> dict:
    """The op's CUDA implementation on one seeded shape: bit-equal to the
    ctypes wrapper (`fused_dilated_unit`, the same kernel and plan), within
    KERNEL_TOL of the plain version, and its device ms."""
    import torch

    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels.dilated_unit import (
        fused_dilated_unit, fused_dilated_unit_reference,
    )
    from rave_tpu_torch.ops.kernels.unit_op import unit_op

    x = torch.randn(B, C, T, device="cuda", generator=gen)
    w1, w2 = unit_weights(C, gen, torch.float32)
    left, right = get_padding(3, 1, d, mode)
    args = (x, w1, w2, d, left, right)
    with torch.inference_mode():
        y_op = unit_op(*args)
        y_k = fused_dilated_unit(*args)
        y_p = fused_dilated_unit_reference(*args)
        torch.cuda.synchronize()
        err = rel_err(y_op, y_p)
        check(torch.equal(y_op, y_k), f"the op vs fused_dilated_unit at B={B} C={C} T={T} d={d} "
                                      f"{mode}: not bit-equal")
        check(err <= KERNEL_TOL, f"the op vs plain at B={B} C={C} T={T} d={d} {mode}: rel err "
                                 f"{err:.3e} > {KERNEL_TOL}")
        ms = cuda_ms(lambda: unit_op(*args), 10) if B == BATCH else None
    return {"B": B, "C": C, "T": T, "d": d, "mode": mode, "rel_err": err,
            "max_abs_err": float((y_op - y_p).abs().max()), "ms": ms}


def phase_portable(cases: dict, offline: dict) -> dict:
    """The op's CUDA implementation at every v2 unit shape of B=16 and B=1 x
    N_SIGNAL (`op_row`); then each case's portable program in one process
    that imports torch and never the port (tools/torch_portable_run.py,
    checked through its `sys.modules`): the .ts on the card, TF32 off,
    within PORTABLE_TOL of the live forward on the same input and seed, the
    .pt2 within PORTABLE_TOL of the .ts, one call's op launches equal to its
    unit nodes and the timed calls' likewise, and a profiled call's device
    kernels: one `prepare_weights_f32` per unit and one `unit_kernel` per
    fused plan, two per split one; ms per forward and the realtime factor
    printed beside phase `offline`'s live forward."""
    import torch

    from rave_tpu_torch.ops.kernels import unit_op

    t0 = time.perf_counter()
    unit_op.load_unit_op()
    gen = torch.Generator(device="cuda").manual_seed(21)
    shapes = sorted(set(v2_unit_shapes(BATCH, N_SIGNAL) + v2_unit_shapes(1, N_SIGNAL)))
    rows = [op_row(gen, *shape) for shape in shapes]
    op_seconds = time.perf_counter() - t0
    paths = [str(ROOT / c["path"]) for c in cases.values()]
    result = PORTABLE_DIR / "consumer.json"
    _run([sys.executable, PORTABLE_CONSUMER, *paths, "--profile", "--iters", PORTABLE_ITERS,
          "--out", result], "the portable programs' consumer")
    runs = json.loads(result.read_text())
    check(not runs["foreign_modules"], f"the consumer imported {runs['foreign_modules'][:5]}")
    programs = {}
    for (case, c), r in zip(cases.items(), runs["programs"]):
        units, want_kernels = c["units"], sum(1 if p[0] else 2 for p in c["plans"])
        prof = r["profile"]
        check(r["finite"] and r["shape"][0] == c["batch"], f"portable {case}: output {r['shape']}"
                                                           f" (finite {r['finite']})")
        check(r["max_abs_err_live"] <= PORTABLE_TOL,
              f"portable {case}: .ts vs the live forward {r['max_abs_err_live']:.3e}")
        check(r["max_abs_err_pt2"] <= PORTABLE_TOL,
              f"portable {case}: .pt2 vs .ts {r['max_abs_err_pt2']:.3e}")
        check(len(c["plans"]) == units and r["launches_first_call"] == units
              and r["launches_timed"] == units * (PORTABLE_ITERS + 1),
              f"portable {case}: {r['launches_first_call']} op launches in a call, "
              f"{r['launches_timed']} in {PORTABLE_ITERS + 1}, expected {units} per call")
        check(prof["prepare_weights_f32"] == units and prof["unit_kernel"] == want_kernels
              and prof["prepare_weights_bf16"] == 0,
              f"portable {case}: the profiled call ran {prof}, expected {units} weight "
              f"preparations and {want_kernels} unit kernels")
        programs[case] = {**c, **{k: r[k] for k in (
            "max_abs_err_live", "bit_equal_live", "max_abs_err_pt2", "bit_equal_pt2", "ms",
            "realtime_factor", "launches_first_call", "profile")}}
    shutil.rmtree(PORTABLE_DIR, ignore_errors=True)
    out = {"op_rows": rows, "programs": programs,
           "launches": sum(p["launches_first_call"] for p in programs.values()),
           "op_max_abs_err": max(r["max_abs_err"] for r in rows),
           "op_ms_b16": sum(r["ms"] for r in rows if r["ms"] is not None) * 2,
           "op_seconds": op_seconds, "seconds": time.perf_counter() - t0}
    b16 = next(p for p in programs.values() if p["batch"] == BATCH)
    print(f"portable: the op at {len(rows)} v2 unit shapes bit-equal to fused_dilated_unit, max "
          f"rel err vs plain {max(r['rel_err'] for r in rows):.2e} <= {KERNEL_TOL}, B={BATCH} "
          f"units {out['op_ms_b16']:.3f} ms; programs (a process without the port): " + "; ".join(
              f"{k} B={p['batch']} x {p['n_signal']} {p['units']} units, export "
              f"{p['export_s']:.1f} s, {p['mib']:.1f} MiB, vs live {p['max_abs_err_live']:.1e}"
              f"{' (bit-equal)' if p['bit_equal_live'] else ''}, .pt2 vs .ts "
              f"{p['max_abs_err_pt2']:.1e}, kernels {p['profile']['prepare_weights_f32']} / "
              f"{p['profile']['unit_kernel']} of {p['profile']['kernels']}, {p['ms']:.2f} ms"
              for k, p in programs.items())
          + f"; .ts at B={BATCH}: {b16['ms']:.2f} ms per forward = {b16['realtime_factor']:.1f}x "
          f"realtime (live, phase offline: {offline['forward_ms']:.2f} ms = "
          f"{offline['realtime_factor']:.1f}x); {out['launches']} op launches; phase "
          f"{out['seconds']:.1f} s (op rows {op_seconds:.1f})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase `variants`: v2_small (the noise synth), v2_nopqmf (raw-waveform
# output) and hybrid (mel input, a 2-layer GRU) at full width
# ---------------------------------------------------------------------------

VARIANTS = ("v2_small", "v2_nopqmf", "hybrid")
# the residual units of one forward at B x 131072 samples, in launch order:
# (C, T, dilations) of each stage, the encoder's then the decoder's
VARIANT_UNITS = {
    "v2_small": [(48, 8192, (1, 3, 9)), (96, 2048, (1, 3, 9)), (192, 1024, (1, 3, 9)),
                 (384, 512, (1, 3)), (384, 512, (1, 3)), (192, 1024, (1, 3, 9)),
                 (96, 2048, (1, 3, 9)), (48, 8192, (1, 3, 9))],
    "v2_nopqmf": [(64, 8192, (1, 3, 9)), (128, 2048, (1, 3, 9)), (256, 512, (1, 3, 9)),
                  (512, 128, (1, 3)), (512, 256, (1, 3)), (256, 2048, (1, 3, 9)),
                  (128, 16384, (1, 3, 9)), (64, 131072, (1, 3, 9))],
    "hybrid": [(96, 512, (1,)), (192, 256, (1,)), (384, 128, (1,)), (768, 128, (1, 3)),
               (384, 512, (1, 3, 9)), (192, 2048, (1, 3, 9)), (96, 8192, (1, 3, 9))],
}
VARIANT_LAUNCHES = {k: sum(len(d) for _, _, d in v) for k, v in VARIANT_UNITS.items()}
# the variants whose bf16 steps phase `train_bf16` drives: hybrid's mel input has no
# bf16 step in rave_tpu (its rfft refuses bfloat16; ROADMAP C14), and the port refuses it
VARIANT_BF16 = ("v2_small", "v2_nopqmf")
# hybrid's receptive field, 21759 / 21503 samples (architectural: the probe on the CPU at
# capacity 2), divided by the channels alone as rave_tpu/train/loop.py:168 does under mel
# input, crops more band frames than a 131072-sample clip has (ROADMAP C12): its steps and
# run train without the crop
VARIANT_OVERRIDES = {"hybrid": ["train.valid_signal_crop=false"]}
# the run: a pre-warmup, an adversarial and a critic step, on the device dataset
VARIANT_LOOP = ["train.phase_1_duration=1", "train.update_discriminator_every=2",
                "data.augmentations=[]"]
VARIANT_LOOP_STEPS, VARIANT_B1_SIGNAL = 3, 65536
VARIANT_STREAM_BLOCKS = 16  # timed streaming forward blocks


def variant_unit_cases(batch: int) -> list:
    """The kernel cases of the variants' unit shapes that v2's do not cover,
    centered at `batch`; then at each channel count new to the kernel, at
    its longest T and widest dilation there, a ragged length (T - 21) at
    `batch` and the length itself at B=1."""
    v2 = {(C, T, d) for C, T, dils in UNIT_SHAPES for d in dils}
    shapes = sorted({(C, T, d) for units in VARIANT_UNITS.values() for C, T, dils in units
                     for d in dils} - v2)
    cases = [("variant", batch, C, T, d, "centered") for C, T, d in shapes]
    widths = {C for C, _, _ in UNIT_SHAPES}
    widest = {}
    for C, T, d in shapes:
        if C not in widths:
            widest[C] = max(widest.get(C, (0, 0)), (T, d))
    for C, (T, d) in sorted(widest.items()):
        cases += [("ragged", batch, C, T - 21, d, "centered"), ("b1", 1, C, T, d, "centered")]
    return cases


def unit_rows_of(rows, preset: str, batch: int) -> list:
    """The kernel phases' rows of one forward's units of `preset` at `batch`
    (each launch once), centered."""
    table = {(r["C"], r["T"], r["d"]): r for r in rows
             if r["B"] == batch and r["mode"] == "centered" and r["case"] in ("main", "variant")}
    return [table[(C, T, d)] for C, T, dils in VARIANT_UNITS[preset] for d in dils]


def variant_cfg(preset: str):
    from rave_tpu_torch.config import compose

    return compose([preset], VARIANT_OVERRIDES.get(preset, []))


def _variant_draws(cfg, x, gen):
    """The variational eps and the noise synth's uniforms of a pass over x."""
    import torch

    from rave_tpu_torch.models.blocks import LatentDraws

    B, T_lat = x.shape[0], x.shape[-1] // cfg.decimation()
    eps = torch.randn(B, cfg.latent_size, T_lat, device=x.device, generator=gen)
    shape = cfg.noise_shape(x.shape[1], B, T_lat)
    uniform = None if shape is None else torch.rand(shape, device=x.device, generator=gen)
    return LatentDraws(eps=eps, uniform=uniform)


def _variant_offline(preset: str, cfg) -> dict:
    """B=16 x 131072 forward (exact launches, the units' shapes, timed), and
    B=1 x 65536 card against CPU."""
    import torch

    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit

    cpu_model = build_rave(cfg, seed=0, device="cpu").eval()
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    draws = _variant_draws(cfg, x, gen)
    want = VARIANT_LAUNCHES[preset]
    with torch.inference_mode():
        model(x, draws)  # warm
        torch.cuda.synchronize()
        before = (dilated_unit.launches, dilated_unit.launches_bf16)
        with UnitShapes() as shapes:
            y = model(x, draws)
        torch.cuda.synchronize()
        launches = dilated_unit.launches - before[0]
        seen = [(C, T, d) for _, C, T, d, _ in shapes.seen]
        units = [(C, T, d) for C, T, dils in VARIANT_UNITS[preset] for d in dils]
        check(seen == units, f"{preset}: the forward's units {seen}, expected {units}")
        check(launches == want and dilated_unit.launches_bf16 == before[1],
              f"{preset}: {launches} launches in one forward, expected {want} fp32")
        check(tuple(y.shape) == (BATCH, 1, N_SIGNAL) and bool(torch.isfinite(y).all()),
              f"{preset}: output {tuple(y.shape)} or not finite")
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x, draws)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / iters
        n = VARIANT_B1_SIGNAL
        xb = torch.randn(1, 1, n, generator=torch.Generator().manual_seed(2)) * 0.1
        db = _variant_draws(cfg, xb, torch.Generator().manual_seed(3))
        y_cpu = cpu_model(xb, db)
        y_gpu = model(xb.cuda(), db.to("cuda")).cpu()
        err = rel_err(y_gpu, y_cpu)
        check(err <= MODEL_TOL, f"{preset}: card vs CPU forward {err:.3e} > {MODEL_TOL}")
    return {"launches_per_forward": want, "forward_ms": sec * 1e3,
            "realtime_factor": BATCH * N_SIGNAL / SAMPLE_RATE / sec, "b1_rel_err": err}


def _variant_stream(preset: str, cfg) -> dict:
    """Streamed blocks of block_size() against the offline output past the
    delays (encode; decode on the noise synth's offline draws shifted by its
    lag); then 32 streaming forward blocks (encode + decode) served by
    `graphed_stream` beside the model's own steps (`model_lockstep`): bit-equal,
    the served p50 under the block's budget."""
    import torch

    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.nn.streaming import init_stream_state

    model = build_rave(cfg, stream_batch=1, seed=4, device="cuda").eval()
    block, D, dec = cfg.block_size(), cfg.latent_size, cfg.decimation()
    gen = torch.Generator(device="cuda").manual_seed(5)
    frames = block // dec
    with torch.inference_mode():
        De = model.encode_delay
        n_enc = 8 + 2 * -(-De * dec // block)
        x = torch.randn(1, 1, block * n_enc, device="cuda", generator=gen) * 0.1
        init_stream_state(model, 1)
        z_st = torch.cat([model.step_encode(x[..., i * block:(i + 1) * block])
                          for i in range(n_enc)], -1)
        z_off = model.encode(x)
        z_err = rel_err(z_st[..., 2 * De:], z_off[..., De:z_off.shape[-1] - De])

        Dd = model.decode_delay
        n_dec = 8 + 2 * -(-Dd // block)
        n_lat = frames * n_dec
        latent = torch.randn(1, D, n_lat, device="cuda", generator=gen)
        shape, u_off, u_st = cfg.noise_shape(1, 1, n_lat), None, [None] * n_dec
        if shape is not None:
            noise = model.decoder.synth.branches[-1]  # the noise synth, v2's or v1's
            lag = noise.delay // noise.target_size
            u_off = torch.rand(shape, device="cuda", generator=gen)
            shifted = torch.cat([torch.zeros_like(u_off[:, :lag]), u_off[:, :shape[1] - lag]], 1)
            u_st = shifted.split(shape[1] // n_dec, dim=1)
        init_stream_state(model, 1)
        y_st = torch.cat([model.step_decode(latent[..., i * frames:(i + 1) * frames], u_st[i])
                          for i in range(n_dec)], -1)
        y_off = model.decode(latent, u_off)
        y_err = rel_err(y_st[..., 2 * Dd:], y_off[..., Dd:y_off.shape[-1] - Dd])
        check(bool(torch.isfinite(y_st).all()) and y_st.shape == y_off.shape,
              f"{preset}: stream {tuple(y_st.shape)} or not finite")
        check(z_err <= MODEL_TOL and y_err <= MODEL_TOL,
              f"{preset}: stream vs offline past the delays z {z_err:.3e}, y {y_err:.3e}")

        xs = torch.randn(1, 1, block * VARIANT_STREAM_BLOCKS, device="cuda", generator=gen)
        shape = cfg.noise_shape(1, 1, frames)
        uniforms = None if shape is None else [torch.rand(shape, device="cuda", generator=gen)
                                                for _ in range(VARIANT_STREAM_BLOCKS)]
    served = model_lockstep(model, cfg, xs, VARIANT_STREAM_BLOCKS, uniforms)
    budget = block / SAMPLE_RATE * 1e3
    check(served["graph_bit_equal"], f"{preset}: graphed_stream not bit-equal to the model's "
                                     f"steps ({served['graph_max_rel_err']:.3e})")
    check(served["p50_ms"]["graph"] < budget, f"{preset}: the model's served stream p50 "
                                              f"{served['p50_ms']} over the {budget:.2f} ms budget")
    return {"block": block, "encode_delay": De, "decode_delay": Dd, "z_rel_err": z_err,
            "y_rel_err": y_err, "block_ms_p50": served["p50_ms"]["eager"], "served": served,
            "block_budget_ms": budget}


def _variant_state(cfg, device: str, step: int):
    from rave_tpu_torch.train.state import create_train_state

    st = create_train_state(cfg, seed=0, device=device)
    st.step = step
    return st


def batch_stats(model) -> dict:
    """BatchNorm's running statistics by name, on the CPU (none without v1's BatchNorm)."""
    return {n: b.detach().cpu() for n, b in model.named_buffers()
            if n.endswith((".bn.mean", ".bn.var"))}


def _variant_steps(preset: str, cfg, want: int = None) -> dict:
    """The receptive-field crop, one step of each program at B=8 x 131072
    after one warm step each (exact launches, `want` per step, times, peak
    memory), for the GRAPHED_FAMILIES the programs eager and through
    `TrainGraphs` (`family_lockstep`: bit-equal, exact launches), and the
    first step of each program at B=1 on the card against the CPU (losses,
    and BatchNorm's running statistics after the step)."""
    import torch

    from rave_tpu_torch.train.analysis import crop_frames, receptive_field
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise

    rf = receptive_field(cfg, device="cuda") if cfg.train.valid_signal_crop else (0, 0)
    crop = crop_frames(cfg, rf)
    steps = build_train_steps(cfg, crop)
    t1 = cfg.train.phase_1_duration
    programs = {"gen_prewarmup": ("gen", False, 0), "gen_adversarial": ("gen", True, t1 + 1),
                "dis": ("dis", True, t1)}
    want = VARIANT_LAUNCHES[preset] if want is None else want
    timed = _timed_steps(cfg, crop, False, programs, want)
    if preset in GRAPHED_FAMILIES:
        timed["graphed_steps"] = family_lockstep(cfg, crop, preset, want)

    xb = torch.randn(1, 1, VARIANT_B1_SIGNAL, generator=torch.Generator().manual_seed(8)) * 0.1
    db = draw_noise(cfg, xb, torch.Generator().manual_seed(9))
    errs, stats_errs = {}, {}
    for name, (which, warmed, step) in programs.items():
        losses, stats = {}, {}
        for device in ("cuda", "cpu"):
            s = _variant_state(cfg, device, step)
            d = db.to(device)
            m = (steps["gen"](s, xb.to(device), warmed, draws=d) if which == "gen"
                 else steps["dis"](s, xb.to(device), draws=d))
            losses[device] = {k: float(v) for k, v in m.items() if _is_loss(k)}
            stats[device] = batch_stats(s.model)
        errs[name] = _loss_err(losses["cuda"], losses["cpu"])
        check(errs[name] <= LOSS_TOL, f"{preset} {name} B=1 card vs CPU losses "
                                      f"{errs[name]:.3e} > {LOSS_TOL}: {losses}")
        if stats["cpu"]:
            stats_errs[name] = max(rel_err(v, stats["cpu"][k]) for k, v in stats["cuda"].items())
            check(stats_errs[name] <= LOSS_TOL, f"{preset} {name} B=1 card vs CPU running "
                                                f"statistics {stats_errs[name]:.3e} > {LOSS_TOL}")
    return {"receptive_field": list(rf), "crop_frames": list(crop), **timed,
            "b1_loss_rel_err": errs, "b1_stats_rel_err": stats_errs}


def _variant_loop_export(preset: str, cfg, work: Path, db: Path) -> dict:
    """`cli train --config <preset>` a few steps on phase `loop`'s store
    (device dataset), `cli export --streaming`, `cli generate` of a 30 s
    file; the artifact on the card against the CPU (3 s clip offline and 8
    streaming blocks, the same seeds), `forward_step.pt2` against the eager
    steps over 32 blocks (<= 1e-5), the streaming p50."""
    import torch

    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal
    from rave_tpu_torch.ops.kernels import dilated_unit

    want = VARIANT_LAUNCHES[preset]
    args = ["train", "--config", preset, "--db_path", db, "--out_path", work / "runs",
            "--batch", TRAIN_BATCH, "--n_signal", N_SIGNAL, "--device", "cuda", "--val_every",
            1000, "--save_every", 1000, "--device_data", "on", "--name", preset,
            "--max_steps", VARIANT_LOOP_STEPS]
    for o in VARIANT_LOOP + VARIANT_OVERRIDES.get(preset, []):
        args += ["--override", o]
    with LoopProbe() as probe:
        out = _cli(args)
        events = probe.take()
    run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
    check("device-resident dataset" in out, f"{preset}: the run did not use the device dataset")
    check(GRAPHED_STEPS in out, f"{preset}: the run did not graph its steps")
    _check_steps(events, "fp32", 0, VARIANT_LOOP_STEPS, probe=cfg.train.valid_signal_crop,
                 per_step=want)
    phases = [e["phase"] for e in events if e["kind"] == "step"]
    check(phases == ["gen_prewarmup", "gen_adversarial", "dis"], f"{preset} phases {phases}")

    t0 = time.perf_counter()
    text = _cli(["export", "--run", run_dir, "--streaming", "--output", work / "export",
                 "--device", "cuda"])
    export_s = time.perf_counter() - t0
    path = Path(text.strip().splitlines()[-1].removeprefix("exported: "))
    manifest = json.loads((path / "manifest.json").read_text())
    check(manifest["block_size"] == cfg.block_size(), f"{preset} manifest block size")
    wav = work / f"{preset}_in.wav"
    n = write_signal(wav, EXPORT_SECONDS, seed=23)
    torch.cuda.synchronize()
    before = dilated_unit.launches
    t0 = time.perf_counter()
    _cli(["generate", "--model", path, "--input", wav, "--out_path", work / "generated",
          "--device", "cuda"])
    torch.cuda.synchronize()
    generate_s, gen_launches = time.perf_counter() - t0, dilated_unit.launches - before
    check(gen_launches == want, f"{preset} generate: {gen_launches} launches, expected {want}")

    art, cpu = ExportedRAVE(str(path), device="cuda"), ExportedRAVE(str(path), device="cpu")
    B = art.block_size
    x = load_signal(decode_file(str(wav), SAMPLE_RATE, 1), 1, 1, B).cuda()
    clip = x[..., : -(-int(CLIP_SECONDS * SAMPLE_RATE) // B) * B]
    off_err = rel_err(art.forward(clip, seed=11).cpu(), cpu.forward(clip.cpu(), seed=11))
    ys_card, ys_cpu = [], []
    for i in range(CPU_STREAM_BLOCKS):
        xb = x[..., i * B:(i + 1) * B]
        ys_card.append(art.forward(xb, streaming=True, seed=100 + i).cpu())
        ys_cpu.append(cpu.forward(xb.cpu(), streaming=True, seed=100 + i))
    st_err = rel_err(torch.cat(ys_card, -1), torch.cat(ys_cpu, -1))
    check(off_err <= MODEL_TOL and st_err <= MODEL_TOL,
          f"{preset} artifact card vs CPU: offline {off_err:.3e}, streaming {st_err:.3e}")

    budget = B / SAMPLE_RATE * 1e3
    lock = run_lockstep(art, x, 3000, art.load_program("forward"), state_floor=1.0)
    worst = max(lock.program_y_err, lock.program_state_err)
    check(worst <= PROGRAM_TOL, f"{preset} forward_step.pt2 vs eager {worst:.3e} > {PROGRAM_TOL}")
    served = check_served(f"{preset} artifact", lock, budget)
    return {"loop_ms": loop_ms(events), "export_s": export_s, "generate_s": generate_s,
            "realtime_factor_generate": n / SAMPLE_RATE / generate_s,
            "generate_launches": gen_launches, "card_vs_cpu": {"offline": off_err,
                                                               "streaming": st_err},
            "program_vs_eager": worst, "served": served, "block_ms_p50": served["p50_ms"],
            "block_budget_ms": budget}


def phase_variants() -> dict:
    """v2_small, v2_nopqmf and hybrid at full width; see the module docstring."""
    import torch

    from rave_tpu_torch.ops.kernels import dilated_unit

    t_phase = time.perf_counter()
    work = ROOT / "build" / "variants"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    db = ROOT / "build" / "loop" / "db"
    out = {}
    torch.cuda.synchronize()
    reset_counts()
    reset_graph_counts()
    for preset in VARIANTS:
        start = dilated_unit.launches
        cfg = variant_cfg(preset)
        parts = {"offline": lambda: _variant_offline(preset, cfg),
                 "stream": lambda: _variant_stream(preset, cfg),
                 "steps": lambda: _variant_steps(preset, cfg),
                 "loop_export": lambda: _variant_loop_export(preset, cfg, work / preset, db)}
        t0, res, seconds = time.perf_counter(), {}, {}
        for name, run in parts.items():
            t = time.perf_counter()
            res[name] = run()
            seconds[name] = time.perf_counter() - t
        res["launches"] = dilated_unit.launches - start
        res["seconds"], res["part_seconds"] = time.perf_counter() - t0, seconds
        out[preset] = res
        o, s, st, le = res["offline"], res["stream"], res["steps"], res["loop_export"]
        print(f"variants {preset}: forward B={BATCH} x {N_SIGNAL} {o['forward_ms']:.2f} ms = "
              f"{o['realtime_factor']:.1f}x realtime, {o['launches_per_forward']} launches per "
              f"forward; B=1 card vs CPU {o['b1_rel_err']:.2e}; stream vs offline z "
              f"{s['z_rel_err']:.2e} y {s['y_rel_err']:.2e}, p50 eager {s['block_ms_p50']:.3f} ms,"
              f" served {s['served']['p50_ms']['graph']:.3f} ms (bit-equal over "
              f"{s['served']['blocks']} blocks across a reset) per {s['block']}-sample block "
              f"(budget {s['block_budget_ms']:.2f}); steps B="
              f"{TRAIN_BATCH} ms " + ", ".join(f"{k} {v:.1f}" for k, v in st["ms_per_step"].items())
              + f", peak {st['peak_gb']:.2f} GiB, rf {st['receptive_field']}; B=1 card vs CPU "
              "losses " + ", ".join(f"{k} {v:.1e}" for k, v in st["b1_loss_rel_err"].items())
              + f"; cli train/export/generate: generate 30 s {le['realtime_factor_generate']:.1f}x"
              f", artifact card vs CPU {le['card_vs_cpu']['offline']:.1e} / "
              f"{le['card_vs_cpu']['streaming']:.1e}, .pt2 vs eager {le['program_vs_eager']:.1e}"
              f", served forward bit-equal to the eager steps; p50 served "
              f"{le['block_ms_p50']['graph']:.3f} / .pt2 served {le['block_ms_p50']['program']:.3f}"
              f" / eager {le['block_ms_p50']['eager']:.3f} / .pt2 eager "
              f"{le['block_ms_p50']['program_eager']:.3f} ms; {res['launches']} launches; "
              f"{res['seconds']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    launches = dilated_unit.launches
    check(dilated_unit.launches_bf16 == 0 and all(r["launches"] > 0 for r in out.values()),
          f"variants: launches {[r['launches'] for r in out.values()]}, "
          f"{dilated_unit.launches_bf16} bf16")
    p50s, budgets = {}, {}
    for p, r in out.items():  # the model's stream and the artifact's, one block each
        p50s[f"{p}_model"] = r["stream"]["served"]["p50_ms"]
        p50s[f"{p}_artifact"] = r["loop_export"]["block_ms_p50"]
        budgets[f"{p}_model"] = budgets[f"{p}_artifact"] = r["stream"]["block_budget_ms"]
    return {"presets": out, "launches": launches, "graphs": graphs_line("variants", p50s, budgets),
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# phase `v1`: the v1 preset at full width (EncoderV1 with BatchNorm, GeneratorV1
# with its noise synth), and `export_onnx --verify`
# ---------------------------------------------------------------------------

# a pre-warmup, an adversarial and a critic step, resumed after the second
V1_LOOP = ["train.phase_1_duration=1", "train.update_discriminator_every=2", "train.ema=0.999"]
V1_LOOP_STEPS, V1_RESUME_STEPS = 2, 3
ONNX_LOOP, ONNX_LOOP_STEPS = ["train.phase_1_duration=1"], 2  # a pre-warmup, then a critic step
V1_STATS = 8  # BatchNorm's running mean and var in each of v1's 4 strided stages


def _v1_offline(cfg) -> dict:
    """The B=16 x 131072 forward in eval mode (BatchNorm on its running
    statistics; no unit launch: v1 has no DilatedUnit), timed, and at B=1 x
    65536 the card against the CPU on the same weights and draws."""
    import torch

    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit

    cpu_model = build_rave(cfg, seed=0, device="cpu").eval()
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    draws = _variant_draws(cfg, x, gen)
    with torch.inference_mode():
        model(x, draws)  # warm
        torch.cuda.synchronize()
        before = dilated_unit.launches
        y = model(x, draws)
        torch.cuda.synchronize()
        launches = dilated_unit.launches - before
        check(tuple(y.shape) == (BATCH, 1, N_SIGNAL) and bool(torch.isfinite(y).all())
              and launches == 0, f"v1 forward {tuple(y.shape)}, {launches} unit launches")
        t0 = time.perf_counter()
        for _ in range(5):
            model(x, draws)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / 5
        xb = torch.randn(1, 1, VARIANT_B1_SIGNAL, generator=torch.Generator().manual_seed(2)) * 0.1
        db = _variant_draws(cfg, xb, torch.Generator().manual_seed(3))
        err = rel_err(model(xb.cuda(), db.to("cuda")).cpu(), cpu_model(xb, db))
    check(err <= MODEL_TOL, f"v1 B=1 card vs CPU forward {err:.3e} > {MODEL_TOL}")
    return {"launches": launches, "forward_ms": sec * 1e3,
            "realtime_factor": BATCH * N_SIGNAL / SAMPLE_RATE / sec, "b1_rel_err": err}


def _v1_loop_export(work: Path, db: Path) -> dict:
    """`cli train --config v1` on phase `loop`'s store, resumed once (the
    restored state, BatchNorm's running statistics included, bit-equal to its
    checkpoint; the statistics moved by the steps); `cli export --streaming`
    and `cli generate` of a 30 s file; the artifact on the card against the
    CPU; `forward_step.pt2` bit-equal to the eager steps over 32 blocks; the
    streaming p50 of a block, eager and `.pt2`, under the block's budget."""
    import torch

    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.utils import checkpoint

    common = ["--config", "v1", "--db_path", db, "--out_path", work / "runs", "--batch",
              TRAIN_BATCH, "--n_signal", N_SIGNAL, "--device", "cuda", "--val_every", 2,
              "--save_every", 1000, "--device_data", "on", "--name", "v1"]
    for o in V1_LOOP:
        common += ["--override", o]
    with LoopProbe() as probe:
        out = _cli(["train", "--max_steps", V1_LOOP_STEPS, *common])
        run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
        first = probe.take()
        out2 = _cli(["train", "--max_steps", V1_RESUME_STEPS, *common])
        resumed = probe.take()
    _check_steps(first, "fp32", 0, V1_LOOP_STEPS, per_step=0)
    _check_steps(resumed, "fp32", V1_LOOP_STEPS, V1_RESUME_STEPS, per_step=0)
    check(f"resumed at step {V1_LOOP_STEPS}" in out2, "the v1 run did not resume")
    phases = [e["phase"] for e in first + resumed if e["kind"] == "step"]
    check(phases == ["gen_prewarmup", "gen_adversarial", "dis"], f"v1 phases {phases}")
    restores = [e for e in resumed if e["kind"] == "restore" and "state" in e]
    check(len(restores) == 1, f"v1 restores {len(restores)}")
    saved = torch.load(restores[0]["path"], map_location="cpu", weights_only=True)
    bad = unequal(restores[0]["state"], saved)
    stats = {k: v for k, v in saved["model"].items() if k.endswith((".bn.mean", ".bn.var"))}
    moved = sum(not torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else
                                torch.ones_like(v)) for k, v in stats.items())
    check(not bad and len(stats) == V1_STATS and moved == V1_STATS,
          f"v1 restore not bit-equal ({bad[:5]}), or {len(stats)} running statistics "
          f"({moved} moved)")

    t0 = time.perf_counter()
    text = _cli(["export", "--run", run_dir, "--streaming", "--output", work / "export",
                 "--device", "cuda"])
    export_s = time.perf_counter() - t0
    path = Path(text.strip().splitlines()[-1].removeprefix("exported: "))
    wav = work / "v1_in.wav"
    n = write_signal(wav, EXPORT_SECONDS, seed=24)
    torch.cuda.synchronize()
    before = dilated_unit.launches
    t0 = time.perf_counter()
    _cli(["generate", "--model", path, "--input", wav, "--out_path", work / "generated",
          "--device", "cuda"])
    torch.cuda.synchronize()
    generate_s, gen_launches = time.perf_counter() - t0, dilated_unit.launches - before
    check(gen_launches == 0, f"v1 generate: {gen_launches} unit launches, expected 0")

    art, cpu = ExportedRAVE(str(path), device="cuda"), ExportedRAVE(str(path), device="cpu")
    final = torch.load(checkpoint.latest_checkpoint(str(run_dir)), map_location="cpu",
                       weights_only=True)["model"]
    check(not unequal(batch_stats(art.model), {k: final[k] for k in stats}),
          "the artifact's running statistics are not the run's")
    B = art.block_size
    x = load_signal(decode_file(str(wav), SAMPLE_RATE, 1), 1, 1, B).cuda()
    clip = x[..., : -(-int(CLIP_SECONDS * SAMPLE_RATE) // B) * B]
    off_err = rel_err(art.forward(clip, seed=11).cpu(), cpu.forward(clip.cpu(), seed=11))
    ys_card, ys_cpu = [], []
    for i in range(CPU_STREAM_BLOCKS):
        xb = x[..., i * B:(i + 1) * B]
        ys_card.append(art.forward(xb, streaming=True, seed=100 + i).cpu())
        ys_cpu.append(cpu.forward(xb.cpu(), streaming=True, seed=100 + i))
    st_err = rel_err(torch.cat(ys_card, -1), torch.cat(ys_cpu, -1))
    check(off_err <= MODEL_TOL and st_err <= MODEL_TOL,
          f"v1 artifact card vs CPU: offline {off_err:.3e}, streaming {st_err:.3e}")

    lock = run_lockstep(art, x, 3000, art.load_program("forward"))
    equal = lock.program_equal
    check(equal, f"v1 forward_step.pt2 not bit-equal to the eager steps over {PROGRAM_BLOCKS} "
                 "blocks")
    budget = B / SAMPLE_RATE * 1e3
    served = check_served("v1", lock, budget)
    p50 = served["p50_ms"]
    ckpts = [e["mb"] for e in first + resumed if e["kind"] == "save"]
    return {"loop_ms": loop_ms(first + resumed), "checkpoint_mb": ckpts, "export_s": export_s,
            "generate_s": generate_s, "realtime_factor_generate": n / SAMPLE_RATE / generate_s,
            "launches": sum(e["fp32"] + e["bf16"] for e in first + resumed) + gen_launches,
            "card_vs_cpu": {"offline": off_err, "streaming": st_err},
            "program_bit_equal": equal, "served": served, "block_ms_p50": p50,
            "block_budget_ms": budget}


def _export_onnx(run_dir: Path, out: Path) -> dict:
    """`cli export_onnx --verify --skip_stablehlo` of `run_dir` on the card
    (the portable program is phase `portable`'s): its seconds, the file's
    size, the verify's error, and the unit launches it made (its live
    forward's)."""
    import torch

    from rave_tpu_torch.ops.kernels import dilated_unit

    torch.cuda.synchronize()
    before = (dilated_unit.launches, dilated_unit.launches_bf16)
    t0 = time.perf_counter()
    text = _cli(["export_onnx", "--run", run_dir, "--output", out, "--verify", "--device",
                 "cuda", "--skip_stablehlo"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = text.strip().splitlines()
    path = Path(next(v for v in lines if v.startswith("exported: ")).removeprefix("exported: "))
    err = float(next(v for v in lines if v.startswith("verify: ")).split("= ")[1].split()[0])
    check(err < 1e-4, f"export_onnx --verify of {run_dir.name}: {err:.3e}")
    return {"seconds": seconds, "mib": path.stat().st_size / 2**20, "verify_max_abs_err": err,
            "launches": dilated_unit.launches - before[0],
            "launches_bf16": dilated_unit.launches_bf16 - before[1]}


def _v1_onnx(work: Path, db: Path, v2_run: Path) -> dict:
    """`cli train --config onnx` two steps on phase `loop`'s store, then `cli
    export_onnx --verify` of it (no unit launch: v1) and of phase `loop`'s v2
    run (its live forward's 22 launches, exactly; the kernel held against its
    plain version at each shape they gave it)."""
    import torch

    args = ["train", "--config", "onnx", "--db_path", db, "--out_path", work / "runs",
            "--batch", TRAIN_BATCH, "--n_signal", N_SIGNAL, "--device", "cuda", "--val_every",
            1000, "--save_every", 1000, "--device_data", "on", "--name", "onnx",
            "--max_steps", ONNX_LOOP_STEPS]
    for o in ONNX_LOOP:
        args += ["--override", o]
    out = _cli(args)
    run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
    onnx = _export_onnx(run_dir, work / "onnx")
    with UnitShapes() as shapes:
        v2 = _export_onnx(v2_run, work / "onnx_v2")
    check(onnx["launches"] == 0 and v2["launches"] == 22 and v2["launches_bf16"] == 0
          and len(shapes.seen) == v2["launches"],
          f"export_onnx --verify launches: onnx {onnx['launches']} (expected 0), v2 "
          f"{v2['launches']} (expected 22, {len(shapes.seen)} unit shapes seen)")
    # the kernel against its plain version at each shape the verify's live forward gave it
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = {shape: kernel_row(gen, "onnx_verify", *shape) for shape in sorted(set(shapes.seen))}
    path = [rows[shape] for shape in shapes.seen]  # one per launch
    v2["unit_path"] = {"shapes": len(rows), "ms": sum(r["ms"] for r in path),
                       "plain_ms": sum(r["plain_ms"] for r in path),
                       "bound_ms": sum(unit_bound([r], r["B"], "fp32")["bound_ms"] for r in path),
                       "max_abs_err": max(r["max_abs_err"] for r in path),
                       "max_rel_err": max(r["rel_err"] for r in path)}
    return {"onnx": onnx, "v2": v2}


def phase_v1(v2_run: Path, db: Path) -> dict:
    """compose(["v1"]) at full width and `export_onnx`; see the module docstring."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit

    t_phase = time.perf_counter()
    work = ROOT / "build" / "v1"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = compose(["v1"])
    seconds, out = {}, {}
    parts = {"offline": lambda: _v1_offline(cfg),
             "stream": lambda: _variant_stream("v1 causal", compose(["v1", "causal"])),
             "steps": lambda: _variant_steps("v1", cfg, want=0),
             "loop_export": lambda: _v1_loop_export(work, db)}
    torch.cuda.synchronize()
    reset_counts()
    reset_graph_counts()
    for name, run in parts.items():
        t0 = time.perf_counter()
        out[name] = run()
        seconds[name] = time.perf_counter() - t0
    out["graphs"] = graphs_line(
        "v1", {"v1_causal_model": out["stream"]["served"]["p50_ms"],
               "v1_artifact": out["loop_export"]["block_ms_p50"]},
        {"v1_causal_model": out["stream"]["block_budget_ms"],
         "v1_artifact": out["loop_export"]["block_budget_ms"]})
    launches = dilated_unit.launches
    check(launches == 0 and dilated_unit.launches_bf16 == 0,
          f"{launches} unit launches on the v1 path, expected 0")
    t0 = time.perf_counter()
    out["onnx"] = _v1_onnx(work, db, v2_run)
    seconds["onnx"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["portable"] = {"v2_b1": export_portable_case(v2_run, "v2_b1"),
                       "v2_b16": export_portable_case(v2_run, "v2_b16", BATCH)}
    seconds["portable"] = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    out.update({"launches": launches, "launches_onnx_verify": out["onnx"]["v2"]["launches"],
                "part_seconds": seconds, "seconds": time.perf_counter() - t_phase})
    o, s, st, le, ox = (out[k] for k in ("offline", "stream", "steps", "loop_export", "onnx"))
    print(f"v1: forward B={BATCH} x {N_SIGNAL} (eval) {o['forward_ms']:.2f} ms = "
          f"{o['realtime_factor']:.1f}x realtime, {launches} unit launches; B=1 card vs CPU "
          f"{o['b1_rel_err']:.2e}; causal stream vs offline z {s['z_rel_err']:.2e} y "
          f"{s['y_rel_err']:.2e}; steps B={TRAIN_BATCH} x {N_SIGNAL} ms " + ", ".join(
              f"{k} {v:.1f}" for k, v in st["ms_per_step"].items())
          + f", peak {st['peak_gb']:.2f} GiB; B=1 card vs CPU losses " + ", ".join(
              f"{k} {v:.1e}" for k, v in st["b1_loss_rel_err"].items())
          + ", running statistics " + ", ".join(
              f"{k} {v:.1e}" for k, v in st["b1_stats_rel_err"].items())
          + f"; cli train {V1_LOOP_STEPS} steps resumed to {V1_RESUME_STEPS} bit-equal "
          f"(running statistics included); export {le['export_s']:.1f} s, generate 30 s "
          f"{le['realtime_factor_generate']:.1f}x, artifact card vs CPU "
          f"{le['card_vs_cpu']['offline']:.1e} / {le['card_vs_cpu']['streaming']:.1e}, "
          f"forward_step.pt2 bit-equal over {PROGRAM_BLOCKS} blocks, the served forward and "
          f"the causal model's served stream bit-equal to the eager steps, streaming p50 served "
          f"{le['block_ms_p50']['graph']:.3f} ms, .pt2 served {le['block_ms_p50']['program']:.3f}"
          f" ms, eager {le['block_ms_p50']['eager']:.3f} ms, .pt2 eager "
          f"{le['block_ms_p50']['program_eager']:.3f} ms (budget {le['block_budget_ms']:.2f} ms)"
          f"; export_onnx --verify: onnx "
          f"{ox['onnx']['seconds']:.1f} s, {ox['onnx']['mib']:.2f} MiB, err "
          f"{ox['onnx']['verify_max_abs_err']:.1e}, {ox['onnx']['launches']} launches; v2 "
          f"{ox['v2']['seconds']:.1f} s, {ox['v2']['mib']:.2f} MiB, err "
          f"{ox['v2']['verify_max_abs_err']:.1e}, {ox['v2']['launches']} launches at "
          f"{ox['v2']['unit_path']['shapes']} shapes, kernel vs plain max abs err "
          f"{ox['v2']['unit_path']['max_abs_err']:.1e} (rel "
          f"{ox['v2']['unit_path']['max_rel_err']:.1e}), {ox['v2']['unit_path']['ms']:.3f} ms "
          f"(plain {ox['v2']['unit_path']['plain_ms']:.3f}, bound "
          f"{ox['v2']['unit_path']['bound_ms']:.3f}); phase "
          f"{out['seconds']:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + ")", flush=True)
    return out


SPECTRAL = ["v2", "spectral_discriminator"]
SPECTRAL_BF16 = ["train.bf16=true", "train.bf16_dis=true"]
# the other distances, each in one adversarial generator step of v2
DISTANCE_KINDS = {"encodec": ['distance.kind="encodec"'],
                  "instantaneous": ['distance.kind="instantaneous"'],
                  "mel64": ["distance.num_mels=64"]}
SPECTRAL_CRITIC_ITERS = 3


def _timed_steps(cfg, crop, bf16: bool, programs: dict, want: int = 22) -> dict:
    """Each of `programs` ({name: (which, warmed, step)}) at B=8 x 131072 from
    the seed-0 state: a warm step, then a timed one, each with exactly `want`
    launches of the step's variant (fp32, or bf16 under `train.bf16`) and
    `bwd_per_step` of the gradient kernel's, finite metrics; ms per step and
    the peak memory."""
    import torch

    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise

    steps = build_train_steps(cfg, crop)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(TRAIN_BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    st = _variant_state(cfg, "cuda", 0)
    kind = "bf16" if bf16 else "fp32"
    ms, bwd_counts = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, (which, warmed, step) in programs.items():
        times = []
        for _ in range(2):  # a warm step, then the timed one
            st.step = step
            draws = draw_noise(cfg, x, gen)
            torch.cuda.synchronize()
            before = LoopProbe.counts()
            t0 = time.perf_counter()
            m = (steps["gen"](st, x, warmed, draws=draws) if which == "gen"
                 else steps["dis"](st, x, draws=draws))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            n32, n_bf16, bwd32, bwd_bf16 = (a - b for a, b in zip(LoopProbe.counts(), before))
            n, bwd, want_bwd = n32 + n_bf16, bwd32 + bwd_bf16, bwd_per_step(name, want)
            check(n == want and n_bf16 == (want if bf16 else 0),
                  f"{cfg.name} {kind} {name}: {n} launches ({n_bf16} bf16), expected {want} "
                  f"{kind}")
            check(bwd == want_bwd and bwd_bf16 == (want_bwd if bf16 else 0),
                  f"{cfg.name} {kind} {name}: {bwd} gradient kernel launches ({bwd_bf16} "
                  f"bf16), expected {want_bwd} {kind}")
            bwd_counts[name] = bwd
            bad = [k for k, v in m.items() if not math.isfinite(float(v))]
            check(not bad, f"{cfg.name} {kind} {name}: non-finite {bad}")
        ms[name] = times[-1] * 1e3
    return {"ms_per_step": ms, "launches_backward_per_step": bwd_counts,
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30}


def _b1_losses(cfg, programs: dict) -> dict:
    """The first step of each of `programs` at B=1 x 65536 from the seed-0
    state on the card and on the CPU, the same draws: each loss term's
    relative difference (as `_loss_err`, term by term)."""
    import torch

    from rave_tpu_torch.train.steps import build_train_steps, draw_noise

    steps = build_train_steps(cfg)  # no crop: the same on both devices
    xb = torch.randn(1, 1, VARIANT_B1_SIGNAL, generator=torch.Generator().manual_seed(8)) * 0.1
    db = draw_noise(cfg, xb, torch.Generator().manual_seed(9))
    errs = {}
    for name, (which, warmed, step) in programs.items():
        losses = {}
        for device in ("cuda", "cpu"):
            s = _variant_state(cfg, device, step)
            d = db.to(device)
            m = (steps["gen"](s, xb.to(device), warmed, draws=d) if which == "gen"
                 else steps["dis"](s, xb.to(device), draws=d))
            losses[device] = {k: float(v) for k, v in m.items() if _is_loss(k)}
        errs[name] = {k: abs(losses["cuda"][k] - v) / max(abs(v), 1e-2)
                      for k, v in losses["cpu"].items()}
    return errs


def _spectral_critic_ms(cfg, bf16: bool) -> dict:
    """The critic of `spectral` alone, forward and backward on the 16-row
    real+fake batch of a B=8 step, device ms by `cuda_ms`: whole, its
    multiscale part and its spectral part (EncodecConvNets on 5 STFTs)."""
    import torch

    from rave_tpu_torch.factory import build_discriminator

    critic = build_discriminator(cfg, seed=1, device="cuda")
    xy = torch.randn(2 * TRAIN_BATCH, 1, N_SIGNAL, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(4)) * 0.1
    if bf16:
        xy = xy.to(torch.bfloat16)
    parts = {"all": critic, "multiscale": critic.discriminators_0,
             "spectral": critic.discriminators_1}

    def fwd_bwd(module):
        def run():
            critic.zero_grad(set_to_none=True)
            sum(fm[-1].float().mean() for fm in module(xy)).backward()
        return run

    return {k: cuda_ms(fwd_bwd(m), SPECTRAL_CRITIC_ITERS) for k, m in parts.items()}


def spectral_flop(cfg, rows: int, n_signal: int) -> float:
    """Multiply-adds x 2 of the spectral critic's convs, forward, over `rows`
    signals: each scale's image [2, bins, frames] through ENCODEC_LAYERS and
    conv_out (the count PERF.md's prediction rests on)."""
    from rave_tpu_torch.models.discriminators import ENCODEC_LAYERS

    cap, total = cfg.discriminator.encodec_capacity, 0.0
    for scale in cfg.discriminator.spectral_scales:
        h, w, ch = scale // 2 + 1, (n_signal - scale) // (scale // 4) + 1, 2
        for (kh, kw), (sh, _), _ in ENCODEC_LAYERS:
            h = (h - 1) // sh + 1
            total += 2 * h * w * ch * cap * kh * kw
            ch = cap
        total += 2 * h * w * ch * 9
    return total * rows


def phase_spectral(crop) -> dict:
    """compose(["v2", "spectral_discriminator"]) and the other distances at
    full width; see the module docstring."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit

    t_phase = time.perf_counter()
    t1 = compose(SPECTRAL).train.phase_1_duration
    programs = {"gen_prewarmup": ("gen", False, 0), "gen_adversarial": ("gen", True, t1 + 1),
                "dis": ("dis", True, t1)}
    adversarial = {"gen_adversarial": programs["gen_adversarial"]}
    cfgs = {"fp32": compose(SPECTRAL), "bf16": compose(SPECTRAL, SPECTRAL_BF16),
            **{k: compose(["v2"], o) for k, o in DISTANCE_KINDS.items()}}
    # the main path: 2 steps of each program (a warm one, a timed one), 22 launches each
    torch.cuda.synchronize()
    reset_counts()
    out = {k: _timed_steps(c, crop, k == "bf16", programs if k in ("fp32", "bf16")
                           else adversarial) for k, c in cfgs.items()}
    launches, launches_bf16 = dilated_unit.launches, dilated_unit.launches_bf16
    n_steps = 2 * (2 * len(programs) + len(DISTANCE_KINDS))
    check(launches == 22 * n_steps and launches_bf16 == 22 * 2 * len(programs),
          f"phase spectral: {launches} launches ({launches_bf16} bf16), expected "
          f"{22 * n_steps} ({22 * 2 * len(programs)} bf16)")
    b1 = {"fp32": _b1_losses(cfgs["fp32"], programs),
          **{k: _b1_losses(cfgs[k], adversarial) for k in DISTANCE_KINDS}}
    critic = {k: _spectral_critic_ms(cfgs["fp32"], k == "bf16") for k in ("fp32", "bf16")}
    graphed = family_lockstep(cfgs["fp32"], crop, "spectral", 22)
    out.update({"launches": launches, "launches_bf16": launches_bf16, "b1_loss_rel_err": b1,
                "graphed_steps": graphed,
                "critic_fwd_bwd_ms": critic, "spectral_critic_tflop_fwd":
                spectral_flop(cfgs["fp32"], 2 * TRAIN_BATCH, N_SIGNAL) / 1e12,
                "seconds": time.perf_counter() - t_phase})
    f, b = out["fp32"], out["bf16"]
    print(f"spectral: v2 + spectral_discriminator B={TRAIN_BATCH} x {N_SIGNAL}, ms per step "
          f"fp32 " + ", ".join(f"{k} {v:.1f}" for k, v in f["ms_per_step"].items())
          + f" (peak {f['peak_gb']:.2f} GiB), bf16 " + ", ".join(
              f"{k} {v:.1f}" for k, v in b["ms_per_step"].items())
          + f" (peak {b['peak_gb']:.2f} GiB); critic fwd+bwd on {2 * TRAIN_BATCH} rows ms fp32 "
          + ", ".join(f"{k} {v:.1f}" for k, v in critic["fp32"].items()) + ", bf16 "
          + ", ".join(f"{k} {v:.1f}" for k, v in critic["bf16"].items())
          + f" (spectral forward {out['spectral_critic_tflop_fwd']:.3f} TFLOP); adversarial "
          "generator steps " + ", ".join(
              f"{k} {out[k]['ms_per_step']['gen_adversarial']:.1f} ms "
              f"({out[k]['peak_gb']:.2f} GiB)" for k in DISTANCE_KINDS)
          + "; B=1 card vs CPU, the largest loss term's error: " + "; ".join(
              f"{k} {name} {max(e for t, e in terms.items() if 'phase' not in t):.1e}"
              + "".join(f", {t} {e:.1e}" for t, e in terms.items() if "phase" in t)
              for k, errs in b1.items() for name, terms in errs.items())
          + f"; {launches} launches ({launches_bf16} bf16, 22 per step); "
          f"{out['seconds']:.1f} s", flush=True)
    for k, errs in b1.items():  # the phase terms too: their weighted form damps the
        for name, terms in errs.items():  # near-silent bins that cuFFT and the CPU round apart
            for t, e in terms.items():
                check(e <= LOSS_TOL, f"spectral {k} {name} B=1 card vs CPU {t}: {e:.3e} > "
                                     f"{LOSS_TOL}")
    return out


IMPORT_GIN = 'include "configs/v2.gin"\n'  # the reference's v2, as a run's config.gin names it
IMPORT_TOL = 1e-5  # imported vs source forward: the weight norm re-decomposed in float32


def _source_model(cfg):
    """v2 at full width with seeded weights and latent buffers (an orthogonal
    PCA, a mean, a rising fidelity curve), as a trained reference run has."""
    import torch

    from rave_tpu_torch.factory import build_rave

    model = build_rave(cfg, seed=21, device="cpu")
    D, gen = cfg.latent_size, torch.Generator().manual_seed(22)
    q, _ = torch.linalg.qr(torch.randn(D, D, generator=gen, dtype=torch.float64))
    with torch.no_grad():
        model.latent_pca.copy_(q.float())
        model.latent_mean.copy_(torch.randn(D, generator=gen) * 0.1)
        model.fidelity.copy_(torch.linspace(0.5, 1.0, D))
    return model


def phase_import() -> dict:
    """A reference checkpoint of v2 into the port; see the module docstring."""
    import torch
    from scipy.io import wavfile

    sys.path.insert(0, str(ROOT / "tools"))
    from torch_reference_ckpt import reference_state_dict, save_reference_ckpt

    from rave_tpu_torch import config as config_lib
    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal
    from rave_tpu_torch.nn.conv import ConvTranspose1d
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.loop import fp32_exact
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.utils.checkpoint import load_run, save_checkpoint
    from rave_tpu_torch.utils.convert import jax_path, to_jax_variables

    t_phase = time.perf_counter()
    reset_graph_counts()
    work = ROOT / "build" / "import"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gin = work / "config.gin"
    gin.write_text(IMPORT_GIN)
    cfg = config_lib.compose([str(gin)])
    source = _source_model(cfg)
    t0 = time.perf_counter()
    sd = reference_state_dict(to_jax_variables(source), transposed={
        jax_path(n) for n, m in source.named_modules() if isinstance(m, ConvTranspose1d)})
    save_reference_ckpt(work / "run.ckpt", sd)
    ckpt_s, ckpt_mb = time.perf_counter() - t0, (work / "run.ckpt").stat().st_size / 2**20
    # the same weights as a port run, exported alike: the referee of the imported artifact
    (work / "source").mkdir()
    (work / "source" / "config.json").write_text(config_lib.snapshot(cfg))
    state = create_train_state(cfg, device="cpu")
    state.model.load_state_dict(source.state_dict())
    save_checkpoint(str(work / "source"), state)
    del state

    # the main path: import_torch -> export --streaming -> generate of a 30 s file
    wav = work / "in.wav"
    n = write_signal(wav, EXPORT_SECONDS, seed=25)
    seconds, counts = {}, {}

    def cli_step(step: str, args) -> str:
        before = dilated_unit.launches
        t0 = time.perf_counter()
        text = _cli([*args, "--device", "cuda"])
        torch.cuda.synchronize()
        seconds[step], counts[step] = time.perf_counter() - t0, dilated_unit.launches - before
        return text.strip().splitlines()[-1]

    torch.cuda.synchronize()
    reset_counts()
    with UnitShapes() as shapes:
        run_dir = Path(cli_step("import_torch", [
            "import_torch", "--ckpt", work / "run.ckpt", "--config", gin, "--name", "imported",
            "--out_path", work / "runs"]).removeprefix("imported into: "))
        art_path = Path(cli_step("export", ["export", "--streaming", "--run", run_dir,
                                            "--output", work / "art"]).removeprefix("exported: "))
        cli_step("generate", ["generate", "--model", art_path, "--input", wav, "--out_path",
                              work / "gen"])
    launches = dilated_unit.launches
    check(counts == {"import_torch": 0, "export": UNITS_PER_HALF, "generate": 22}
          and dilated_unit.launches_bf16 == 0 and len(shapes.seen) == launches,
          f"import path launches {counts} ({len(shapes.seen)} unit calls seen); expected "
          f"import_torch 0, export {UNITS_PER_HALF} (its smoke decode), generate 22")
    gen_units = sorted(shapes.seen[-counts["generate"]:])
    check(gen_units == sorted(v2_unit_shapes(1, -(-n // 2048) * 2048) * 2),
          f"generate's unit shapes {gen_units}")

    # the imported model and artifact against the source's
    _cli(["export", "--streaming", "--run", work / "source", "--output", work / "src_art",
          "--device", "cuda"])
    x = load_signal(decode_file(str(wav), SAMPLE_RATE, 1), 1, 1, 2048).cuda()
    clip = x[..., : 64 * 2048]
    _, imported, _, _ = load_run(str(run_dir), device="cuda")
    src = source.cuda().eval()
    with torch.inference_mode(), fp32_exact():
        y = {}
        for key, m in (("imported", imported), ("source", src)):
            z = m.encode(clip)
            y[key] = m.decode(z[:, : cfg.latent_size])
        model_err = rel_err(y["imported"], y["source"])
    art = ExportedRAVE(str(art_path), device="cuda")
    src_art = ExportedRAVE(str(work / "src_art" / art_path.name), device="cuda")
    with fp32_exact():
        art_err = rel_err(art.forward(clip, seed=5), src_art.forward(clip, seed=5))
    check(model_err <= IMPORT_TOL and art_err <= IMPORT_TOL,
          f"imported vs source: model forward {model_err:.3e}, artifact {art_err:.3e} > "
          f"{IMPORT_TOL}")
    budget = art.block_size / SAMPLE_RATE * 1e3
    served = check_served("imported artifact", run_lockstep(
        art, x, 4000, art.load_program("forward")), budget)
    p50 = served["p50_ms"]
    sr, y_wav = wavfile.read(work / "gen" / "in_reconstructed.wav")
    check(sr == SAMPLE_RATE and y_wav.shape == (n,) and abs(y_wav).max() > 0,
          f"generated wav {sr} Hz {y_wav.shape}")

    gen = torch.Generator(device="cuda").manual_seed(26)
    rows = {shape: kernel_row(gen, "import", *shape) for shape in sorted(set(shapes.seen))}
    path = [rows[shape] for shape in shapes.seen]  # one per launch
    unit_path = {"shapes": len(rows), "ms": sum(r["ms"] for r in path),
                 "plain_ms": sum(r["plain_ms"] for r in path),
                 "bound_ms": sum(unit_bound([r], r["B"], "fp32")["bound_ms"] for r in path),
                 "max_abs_err": max(r["max_abs_err"] for r in path),
                 "max_rel_err": max(r["rel_err"] for r in path)}
    shutil.rmtree(work, ignore_errors=True)
    out = {"launches": launches, "launches_by_step": counts, "seconds_by_step": seconds,
           "ckpt_s": ckpt_s, "ckpt_mb": ckpt_mb, "reference_tensors": len(sd),
           "model_rel_err": model_err, "artifact_rel_err": art_err, "block_ms_p50": p50,
           "block_budget_ms": budget, "served": served,
           "graphs": graphs_line("import", {"imported": p50}, {"imported": budget}),
           "realtime_factor_generate": n / SAMPLE_RATE
           / seconds["generate"], "unit_rows": list(rows.values()), "unit_path": unit_path,
           "seconds": time.perf_counter() - t_phase}
    print(f"import: v2 at full width ({len(sd)} reference tensors, {ckpt_mb:.1f} MiB .ckpt in "
          f"{ckpt_s:.1f} s) -> cli import_torch --config {gin.name} {seconds['import_torch']:.1f} s"
          f", export --streaming {seconds['export']:.1f} s, generate {EXPORT_SECONDS:g} s "
          f"{seconds['generate']:.2f} s ({out['realtime_factor_generate']:.1f}x); launches "
          f"{counts}; imported vs source forward {model_err:.2e}, artifact {art_err:.2e} <= "
          f"{IMPORT_TOL}; the served forward bit-equal to the eager steps over "
          f"{served['blocks']} blocks across a reset, streaming p50 served {p50['graph']:.3f} ms,"
          f" .pt2 served {p50['program']:.3f} ms, eager {p50['eager']:.3f} ms, .pt2 eager "
          f"{p50['program_eager']:.3f} ms (budget {budget:.2f}); unit at {len(rows)} shapes: "
          f"max rel err "
          f"{unit_path['max_rel_err']:.1e}, its {launches} launches {unit_path['ms']:.3f} ms "
          f"(plain {unit_path['plain_ms']:.3f}, bound {unit_path['bound_ms']:.3f}); "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# ---- the native sampler, the remote dataset and data parallelism (A17, A18, A14) ----------

NATIVE_STEPS, NATIVE_WARMUP = 10, 4  # each `cli train --device_data off` run: all three programs
NATIVE_TOL, NATIVE_SEED = 1e-6, 3  # the sampler against its numpy twin
REMOTE_BATCHES = 3
DP_RANKS, DP_BATCH = 2, 4  # the worker's ranks and rows per rank: the global batch of TRAIN_BATCH
DP_LOSS_TOL = 1e-4  # step 0's loss, two ranks against one process over the global batch
# step 0's averaged gradient, relative L2 over all parameters, two ranks against one process:
# twice the largest of 20 readings (worker seeds 1-10 on this tree and its parent, 4.9e-5 to
# 1.918e-3; 7.4e-5 at the worker's seed; tools/torch_dp_spread.py). A sum for a mean reads 1.
DP_GRAD_TOL = 4e-3
# the worker at v2's widths and n_signal, at log_epsilon 1e-3 (ROADMAP C4): at v2's 1e-7 the
# float32 pre-warmup gradient is rounding noise in many elements (~3% from float64), Adam's
# first update is lr * sign(g), and two summation orders of one step part after it (PERF.md)
DP_WORKER_ARGS = ["--full", "--override", "distance.log_epsilon=1e-3"]
DP_LOOP_BATCH, DP_LOOP_STEPS, DP_LOOP_RESUME = 1, 4, 6  # one validation record per rank
DP_TIMEOUT = 600
# the gradient kernel's launches in mpworker's schedule: pre-warmup, adversarial, critic
DP_BWD_LAUNCHES = [bwd_per_step(p, 22) for p in ("gen_prewarmup", "gen_adversarial", "dis")]


def free_port(avoid: int = None) -> int:
    """A free localhost port, other than `avoid` (one already handed out)."""
    import socket

    while True:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        if port != avoid:
            return port


def _run(cmd, what: str) -> str:
    """Run `cmd` from the checkout's root in its own session; its standard output.
    A non-zero exit (a dead rank) or the time limit fails the phase, and the
    whole session is killed on the way out."""
    import os
    import signal

    proc = subprocess.Popen([str(c) for c in cmd], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DP_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    check(proc.returncode == 0, f"{what} exited {proc.returncode}: {err[-3000:]}")
    return out


def grads_rel_l2(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every tensor of two name -> gradient maps, in float64."""
    check(got.keys() == want.keys(),
          f"gradients differ in names: {sorted(got.keys() ^ want.keys())}")
    num = sum(float((got[n].double() - want[n].double()).square().sum()) for n in want)
    den = sum(float(want[n].double().square().sum()) for n in want)
    return math.sqrt(num / den)


def torchrun(ranks: int, port: int = None):
    return [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", ranks,
            "--master_addr", "127.0.0.1", "--master_port", port or free_port(), "-m"]


def _in_threads(calls) -> list:
    """Each of `calls` (no arguments) at once, one thread each: their results
    in order; the first failure raises once every call has ended."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(call) for call in calls]
    return [f.result() for f in futures]


def _run_together(*jobs) -> list:
    """`_run` of each (cmd, what) at once, one thread each: [(standard output,
    seconds)] in order. Each waits for its own process group; the first
    failure raises once every job has ended."""
    def timed_run(cmd, what):
        t0 = time.perf_counter()
        return _run(cmd, what), time.perf_counter() - t0

    return _in_threads([functools.partial(timed_run, cmd, what) for cmd, what in jobs])


def phase_native(loop: dict) -> dict:
    """The C++ sampler and the training driver on it; see the module docstring."""
    import numpy as np
    import torch

    from rave_tpu_torch.data import native
    from rave_tpu_torch.data.store import ArsReader, read_metadata
    from rave_tpu_torch.ops.kernels import build, dilated_unit
    from rave_tpu_torch.train import loop as loop_module

    t_phase = time.perf_counter()
    db, work = ROOT / "build" / "loop" / "db", ROOT / "build" / "native"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    lib = build.build_host(native.SOURCE)
    build_s = time.perf_counter() - t0
    meta = read_metadata(str(db))
    records = ArsReader(str(db)).records()
    sampler = native.NativeSampler(str(db), meta["num_signal"], meta["channels"], N_SIGNAL,
                                   SAMPLE_RATE, seed=NATIVE_SEED)
    idx = np.arange(TRAIN_BATCH) * 13 % len(records)
    got = sampler.sample(idx, epoch_tag=1)
    t0 = time.perf_counter()
    plain = native.sample_plain(records, idx, N_SIGNAL, SAMPLE_RATE, seed=NATIVE_SEED,
                                epoch_tag=1)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(got - plain).max())
    check(got.shape == (TRAIN_BATCH, N_SIGNAL, meta["channels"]) and bool(np.isfinite(got).all())
          and err <= NATIVE_TOL, f"native sampler vs sample_plain: {err:.2e} > {NATIVE_TOL}")
    check(not np.array_equal(got, records[idx].astype(np.float32) / 32767),
          "the sampler mangled and dithered nothing")
    t0 = time.perf_counter()
    for _ in range(5):
        sampler.sample(idx, epoch_tag=1)
    sample_ms = (time.perf_counter() - t0) * 1e3 / 5

    fed = {"batches": 0}
    real = loop_module.NativeLoader

    class CountedLoader(real):
        def _make_batch(self, *args):
            fed["batches"] += 1
            return super()._make_batch(*args)

    common = ["--config", "v2", "--db_path", db, "--out_path", work / "runs", "--batch",
              TRAIN_BATCH, "--n_signal", N_SIGNAL, "--device", "cuda", "--max_steps",
              NATIVE_STEPS, "--val_every", 1000, "--save_every", 1000, "--device_data", "off",
              "--no_resume"]
    for o in LOOP_SCHEDULE + [f"train.phase_1_duration={NATIVE_WARMUP}"]:
        common += ["--override", o]
    runs, by_step = {}, {}
    torch.cuda.synchronize()
    reset_counts()
    loop_module.NativeLoader = CountedLoader
    try:
        with LoopProbe() as probe:
            for kind, flags in (("fp32", []), ("bf16", ["--bf16"])):
                before = fed["batches"]
                out = _cli(["train", "--name", f"native_{kind}", *flags, *common])
                events = probe.take()
                check("using the native (C++) input pipeline" in out,
                      f"the {kind} run did not take the native loader")
                check(GRAPHED_STEPS in out, f"the {kind} run did not graph its steps")
                check(fed["batches"] - before >= NATIVE_STEPS,
                      f"the native loader made {fed['batches'] - before} batches")
                _check_steps(events, kind, 0, NATIVE_STEPS, per_step=2 * UNITS_PER_HALF)
                runs[kind] = loop_ms(events)
                by_step[kind] = [e[kind] for e in events if e["kind"] == "step"]
    finally:
        loop_module.NativeLoader = real
    torch.cuda.synchronize()
    launches = {"fp32": dilated_unit.launches - dilated_unit.launches_bf16,
                "bf16": dilated_unit.launches_bf16,
                "bwd_fp32": dilated_unit.launches_backward - dilated_unit.launches_backward_bf16,
                "bwd_bf16": dilated_unit.launches_backward_bf16}
    shutil.rmtree(work, ignore_errors=True)
    out = {"library": str(lib.relative_to(ROOT)), "build_s": build_s, "sample_rows": len(idx),
           "max_abs_err": err, "sample_ms": sample_ms, "plain_sample_ms": plain_ms,
           "loop_ms": runs, "host_loader_loop_ms": loop["loop_ms"], "launches": launches,
           "launches_by_step": by_step,
           "batches_fed": fed["batches"], "seconds": time.perf_counter() - t_phase}
    summary = "; ".join(f"{kind} {ph} {v['loop_ms']:.1f} (step {v['step_ms']:.1f}, x{v['n']})"
                        for kind, t in runs.items() for ph, v in sorted(t.items()))
    host = "; ".join(f"{ph} {v['loop_ms']:.1f} (step {v['step_ms']:.1f})"
                     for ph, v in sorted(loop["loop_ms"]["bf16"].items()))
    print(f"native: {out['library']} by g++ in {build_s:.2f} s; B={len(idx)} x {N_SIGNAL} "
          f"(mangle, dither) vs sample_plain max abs err {err:.2e} <= {NATIVE_TOL}; sampler "
          f"{sample_ms:.2f} ms per batch (host; numpy twin {plain_ms:.0f} ms); cli train "
          f"--device_data off {NATIVE_STEPS} steps fp32 and bf16 on the native loader "
          f"({fed['batches']} batches), {2 * UNITS_PER_HALF} launches per step, {launches['fp32']} fp32 + "
          f"{launches['bf16']} bf16; loop ms per step (bare step): {summary}; phase loop's "
          f"threaded host loader, bf16: {host}; {out['seconds']:.1f} s", flush=True)
    return out


def phase_remote(crop) -> dict:
    """`cli remote_dataset` and the HTTP dataset; see the module docstring."""
    import numpy as np
    import torch

    from rave_tpu_torch import config as config_lib
    from rave_tpu_torch.data.dataset import HTTPAudioDataset, get_dataset, split_dataset
    from rave_tpu_torch.data.loader import Loader
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train import graphs as train_graphs
    from rave_tpu_torch.train.graphs import TrainGraphs
    from rave_tpu_torch.train.loop import fp32_exact
    from rave_tpu_torch.train.loop import train as train_loop
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise, pick_phase
    from rave_tpu_torch.utils.rng import step_generator

    t_phase = time.perf_counter()
    db, work = ROOT / "build" / "loop" / "db", ROOT / "build" / "remote"
    shutil.rmtree(work, ignore_errors=True)
    port = free_port()
    server = subprocess.Popen(
        [sys.executable, "-m", "rave_tpu_torch.cli", "remote_dataset", "--db_path", str(db),
         "--port", str(port)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = server.stdout.readline()
        check("serving" in line, f"remote_dataset did not start: {line!r} "
                                 f"{server.stderr.read()[-2000:] if server.poll() else ''}")
        url = f"http://127.0.0.1:{port}"
        local, remote = (get_dataset(p, SAMPLE_RATE, N_SIGNAL) for p in (str(db), url))
        check(isinstance(remote, HTTPAudioDataset) and len(remote) == len(local),
              f"remote dataset of {len(remote)} records")
        idx = split_dataset(local)[0][: REMOTE_BATCHES * TRAIN_BATCH]

        def batches(dataset):
            t0 = time.perf_counter()
            xs = list(Loader(dataset, idx, TRAIN_BATCH, seed=0, workers=8).epoch(0))
            return xs, (time.perf_counter() - t0) * 1e3 / len(xs)

        got, http_ms = batches(remote)
        want, local_ms = batches(local)
        check(len(got) == REMOTE_BATCHES and all(np.array_equal(g, w) for g, w in zip(got, want)),
              "the remote Loader's batches are not the local Loader's")
        cfg = config_lib.compose(["v2"])
        state = create_train_state(cfg, device="cuda")
        # a warm-up step, a capture (and its replay), a replay of it
        graphs = TrainGraphs(build_train_steps(cfg, crop))
        steps = {"gen": graphs.gen, "dis": graphs.dis}
        counts, counts_bwd, want, want_bwd, replayed, losses, ms = [], [], [], [], [], [], []
        torch.cuda.synchronize()
        reset_counts()
        with fp32_exact():
            for xb in got:
                x = torch.from_numpy(xb).cuda()
                which, warmed, quantize = pick_phase(cfg, state.step)
                draws = draw_noise(cfg, x, step_generator(1, state.step, "cuda"))
                torch.cuda.synchronize()
                served = train_graphs.captures, train_graphs.replays
                n0, b0, t0 = (dilated_unit.launches, dilated_unit.launches_backward,
                              time.perf_counter())
                m = (steps["gen"](state, x, warmed, draws=draws, quantize=quantize)
                     if which == "gen" else steps["dis"](state, x, draws=draws,
                                                         quantize=quantize))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                # a replay runs no Python: the wrappers count a warm-up's and a capture's
                replayed.append((train_graphs.captures, train_graphs.replays)
                                == (served[0], served[1] + 1))
                counts.append(dilated_unit.launches - n0)
                phase = "dis" if which == "dis" else (
                    "gen_adversarial" if warmed else "gen_prewarmup")
                counts_bwd.append(dilated_unit.launches_backward - b0)
                want.append(0 if replayed[-1] else 2 * UNITS_PER_HALF)
                want_bwd.append(0 if replayed[-1] else bwd_per_step(phase, 22))
                losses.append(float(m["loss_gen" if which == "gen" else "loss_dis"]))
        check(replayed == [False] * 2 + [True] * (REMOTE_BATCHES - 2),
              f"remote steps: replays {replayed}, expected a warm-up, a capture, then replays")
        check(counts == want and dilated_unit.launches_bf16 == 0,
              f"remote steps' launches {counts}, expected {want}")
        check(counts_bwd == want_bwd and dilated_unit.launches_backward_bf16 == 0,
              f"remote steps' gradient kernel launches {counts_bwd}, expected {want_bwd}")
        check(all(math.isfinite(v) for v in losses), f"remote steps' losses {losses}")
        check(len(graphs.graphs) == 1, f"remote steps: {len(graphs.graphs)} graphs captured")
        # C20: the JAX package's train cannot take a URL, nor can the port's
        check(refuses(lambda: train_loop(copy.deepcopy(cfg), url, out_path=str(work),
                                         device="cuda"), FileNotFoundError),
              "train on a URL did not raise FileNotFoundError (ROADMAP C20)")
        check(not work.exists(), "train on a URL wrote a run directory")
    finally:
        server.kill()
        server.wait()
    out = {"url": url, "records": len(remote), "batches": REMOTE_BATCHES, "http_batch_ms": http_ms,
           "local_batch_ms": local_ms, "launches": sum(counts), "launches_by_step": counts,
           "launches_backward": sum(counts_bwd), "launches_backward_by_step": counts_bwd,
           "losses": losses, "step_ms": ms, "seconds": time.perf_counter() - t_phase}
    print(f"remote: cli remote_dataset on :{port} ({len(remote)} records) -> get_dataset(url) "
          f"through Loader: {REMOTE_BATCHES} batches of B={TRAIN_BATCH} x {N_SIGNAL} bit-equal "
          f"to the local store's; {http_ms:.1f} ms per batch over HTTP, {local_ms:.1f} locally; "
          f"v2 steps on them (TrainGraphs: a warm-up step, a capture, a replay): wrapper "
          f"launches {counts}, ms "
          f"{', '.join(f'{v:.1f}' for v in ms)}, losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; train on the URL raises "
          f"FileNotFoundError (C20); {out['seconds']:.1f} s", flush=True)
    return out


def phase_parallel() -> dict:
    """Two ranks on one card with gloo; see the module docstring."""
    import torch

    from rave_tpu_torch.utils.checkpoint import checkpoint_step, list_checkpoints

    t_phase = time.perf_counter()
    work, db = ROOT / "build" / "parallel", ROOT / "build" / "loop" / "db"
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks are processes of their own on this card
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = [kernel_row(gen, "dp_b4", DP_BATCH, C, T, d, "centered") for C, T, dils in UNIT_SHAPES
            for d in dils]
    worker = ["rave_tpu_torch.parallel.mpworker", "--device", "cuda", "--deterministic",
              "--step0_grads", *DP_WORKER_ARGS]
    # `cli train` in two ranks: native loader, lockstep validation, rank 0 saves
    common = ["rave_tpu_torch.cli", "train", "--name", "dp", "--config", "v2", "--db_path", db,
              "--out_path", work / "runs", "--batch", DP_LOOP_BATCH, "--n_signal", N_SIGNAL,
              "--device", "cuda", "--device_data", "off", "--val_every", 2, "--save_every", 1000]
    for o in LOOP_SCHEDULE:
        common += ["--override", o]
    # the workers beside the two `cli train` runs (independent process groups on the card): in
    # turn they took ~90 s more (an H100 80GB HBM3 host: 178.7 s against 87.7), which the smoke's
    # time limit cannot hold; the workers' step ms are printed, not held, and taken beside them
    port = free_port()
    (out_two, two_s), (out1, first_s) = _run_together(
        (torchrun(DP_RANKS, port) + worker + ["--batch", DP_BATCH, "--out_dir", work / "two"],
         "the 2-rank worker"),
        (torchrun(DP_RANKS, free_port(avoid=port)) + common + ["--max_steps", DP_LOOP_STEPS],
         "2-rank cli train"))
    (_, one_s), (out2, resume_s) = _run_together(
        ([sys.executable, "-m", *worker, "--batch", DP_RANKS * DP_BATCH, "--out_dir",
          work / "one"], "the one-process worker"),
        (torchrun(DP_RANKS) + common + ["--max_steps", DP_LOOP_RESUME],
         "2-rank cli train (resume)"))
    loop_s = first_s + resume_s
    ranks = [json.loads((work / "two" / f"rank{r}.json").read_text()) for r in range(DP_RANKS)]
    single = json.loads((work / "one" / "rank0.json").read_text())
    check("backend gloo" in out_two, f"the ranks' backend: {out_two[:300]}")
    losses = [k for k in single if k.startswith("step") and "_loss_" in k]
    check(len(losses) == 3, f"worker losses {losses}")
    for r in ranks:
        check(r["world_size"] == DP_RANKS and r["global_batch"] == DP_RANKS * DP_BATCH,
              f"rank {r['rank']}: world {r['world_size']}, global batch {r['global_batch']}")
        check(r["digest"] == ranks[0]["digest"] and all(r[k] == ranks[0][k] for k in losses),
              f"rank {r['rank']} is not bit-equal to rank 0")
        check(r["launches"] == [22, 22, 22], f"rank {r['rank']} launches {r['launches']}")
        check(r["launches_backward"] == DP_BWD_LAUNCHES,
              f"rank {r['rank']} gradient kernel launches {r['launches_backward']}")
    check(single["launches"] == [22, 22, 22], f"one-process launches {single['launches']}")
    check(single["launches_backward"] == DP_BWD_LAUNCHES,
          f"one-process gradient kernel launches {single['launches_backward']}")
    errs = {k: abs(ranks[0][k] - single[k]) / max(abs(single[k]), 1e-12) for k in losses}
    grad_err = grads_rel_l2(torch.load(work / "two" / "step0_grads.pt"),
                            torch.load(work / "one" / "step0_grads.pt"))
    check(all(math.isfinite(ranks[0][k]) for k in losses), f"2-rank losses not finite: {errs}")
    check(errs[losses[0]] <= DP_LOSS_TOL,
          f"2 ranks vs one process: {losses[0]} {errs[losses[0]]:.3e} > {DP_LOSS_TOL}")
    check(grad_err <= DP_GRAD_TOL,
          f"2 ranks vs one process: step 0's gradient {grad_err:.3e} > {DP_GRAD_TOL}")

    check(out1.count("using the native (C++) input pipeline") == 1
          and "data parallel: 2 ranks, backend gloo" in out1, f"2-rank train: {out1[-1500:]}")
    check(out1.count(EAGER_DP_STEPS) == 1 and GRAPHED_STEPS not in out1,
          f"2-rank train did not run its steps eagerly: {out1[-1500:]}")
    check(out2.count(f"resumed at step {DP_LOOP_STEPS}") == 1, f"2-rank resume: {out2[-1500:]}")
    run_dir = Path(out1.strip().splitlines()[-1].removeprefix("run dir: "))
    vals = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    val_steps = [r["step"] for r in vals if "validation" in r]
    check(val_steps == list(range(2, DP_LOOP_RESUME + 1, 2)), f"validation rows at {val_steps}")
    check([r["step"] for r in vals if "loss_gen" in r] == [1, 2], "loss rows not once per step")
    check(all(math.isfinite(v) for r in vals for v in r.values()), "non-finite metrics row")
    ckpts = [checkpoint_step(p) for p in list_checkpoints(str(run_dir))]
    check(ckpts == val_steps, f"checkpoints at {ckpts}")
    shutil.rmtree(work, ignore_errors=True)
    by_step = lambda r: [f"{v:.1f}" for v in r["ms"]]  # noqa: E731
    out = {"ranks": DP_RANKS, "batch_per_rank": DP_BATCH, "backend": "gloo",
           "losses": {k: ranks[0][k] for k in losses}, "one_process_losses":
           {k: single[k] for k in losses}, "loss_rel_err": errs,
           "step0_grad_rel_l2": grad_err, "digest": ranks[0]["digest"],
           "ms_by_rank": [r["ms"] for r in ranks], "one_process_ms": single["ms"],
           "launches": sum(sum(r["launches"]) for r in ranks),
           "launches_by_step": [r["launches"] for r in ranks], "worker_s": two_s,
           "launches_backward": sum(sum(r["launches_backward"]) for r in ranks),
           "launches_backward_by_step": [r["launches_backward"] for r in ranks],
           "one_process_s": one_s, "loop_s": loop_s, "validations": val_steps,
           "checkpoints": ckpts, "unit_rows": rows, "seconds": time.perf_counter() - t_phase}
    print(f"parallel: mpworker at v2's widths, {DP_RANKS} ranks x B={DP_BATCH} x {N_SIGNAL} on one "
          f"card (gloo), cuDNN deterministic: ranks bit-equal, losses "
          f"{', '.join(f'{ranks[0][k]:.6f}' for k in losses)} vs one process B="
          f"{DP_RANKS * DP_BATCH} {', '.join(f'{single[k]:.6f}' for k in losses)} (rel "
          f"{', '.join(f'{v:.3e}' for v in errs.values())}; step 0's {errs[losses[0]]:.1e} <= "
          f"{DP_LOSS_TOL}), step 0's gradient rel L2 {grad_err:.3e} <= {DP_GRAD_TOL}; 22 "
          f"launches per step per rank; step ms "
          f"rank 0 {by_step(ranks[0])}, one process {by_step(single)}; worker {two_s:.1f} s, one "
          f"process {one_s:.1f} s; 2-rank cli train (native loader, B={DP_LOOP_BATCH} per rank) "
          f"validated at {val_steps}, rank 0 saved {ckpts}, resumed at {DP_LOOP_STEPS}, "
          f"{loop_s:.1f} s, its steps eager by rule (gloo's collectives cannot be captured); "
          f"unit at the 11 centered B={DP_BATCH} shapes: max rel err "
          f"{max(r['rel_err'] for r in rows):.1e}, kernel/plain ms: {shape_summary(rows)}; "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# ---- the native artifact host (csrc/rtpu_host.cc) on the artifacts of earlier phases -------

HOST_ARTIFACTS = ROOT / "build" / "host" / "artifacts"
HOST_BLOCKS = 32  # streamed blocks per command
HOST_BENCH_BLOCKS = 128  # timed blocks of `bench` per artifact, each path (8 warm ones before)
HOST_PRIOR_FRAMES = 64
HOST_SEED = 4242
WAV_TOL = 1 / 32767 + 1e-7  # a wav's int16 rounding (truncation toward zero), as `generate`'s


class HostBuild:
    """The artifact host's g++ build (rave_tpu_torch/export/native_host.py),
    or another g++ build `build` (the op library's,
    ops/kernels/unit_op.py::ensure_library), started in a thread on the
    host's CPU beside the phases that work the card; `result()` waits for it
    and raises what it raised."""

    def __init__(self, build=None):
        import threading

        self.build = build
        self.path, self.error, self.seconds = None, None, None
        self.thread = threading.Thread(target=self._build, daemon=True)
        self.thread.start()

    def _build(self):
        from rave_tpu_torch.export.native_host import ensure_host

        t0 = time.perf_counter()
        try:
            self.path = (self.build or ensure_host)()
        except BaseException as e:  # re-raised in the main thread by result()
            self.error = e
        self.seconds = time.perf_counter() - t0

    def result(self) -> tuple:
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.path, self.seconds


class Host:
    """The built host binary; `run` runs one command of it (`_run`: a
    non-zero exit fails the phase) and keeps its seconds in `seconds`;
    `stream` runs a streaming command and checks that one captured CUDA graph
    served its `steps` steps, keeping its warm-up and capture seconds in
    `capture_s`."""

    def __init__(self, path: str):
        self.path, self.seconds, self.capture_s = path, {}, {}

    def run(self, what: str, *args) -> str:
        t0 = time.perf_counter()
        out = _run([self.path, *args], f"rtpu_host {what}")
        self.seconds[what] = time.perf_counter() - t0
        return out

    def stream(self, what: str, steps: int, *args) -> str:
        out = self.run(what, *args)
        self.capture_s[what] = graph_steps(out, what, steps)
        return out


def graph_steps(out: str, what: str, steps: int) -> float:
    """The host's `steps:` line in `out`: one CUDA graph captured, `steps`
    replays; the capture's seconds (its two warm-ups included)."""
    import re

    m = re.search(r"^steps: cuda graph, (\d+) captures?, (\d+) replays "
                  r"\(warm-up and capture ([0-9.]+) s\)$", out, re.M)
    check(m is not None and (int(m.group(1)), int(m.group(2))) == (1, steps),
          f"rtpu_host {what}: {m.group(0) if m else 'no steps line'}; expected one CUDA graph "
          f"captured and {steps} replays")
    return float(m.group(3))


def keep_for_host(name: str, path) -> str:
    """Move the artifact `path` out of its phase's work directory, which the
    phase deletes, to where phase `host` streams it; its new place."""
    dest = HOST_ARTIFACTS / name
    shutil.rmtree(dest, ignore_errors=True)
    dest.parent.mkdir(parents=True, exist_ok=True)
    shutil.move(str(path), str(dest))
    return str(dest.relative_to(ROOT))


def host_info(host: Host, path: Path, name: str) -> dict:
    """`rtpu_host <path> info` as {key: [values]}."""
    fields = {}
    for line in host.run(f"{name} info", path, "info").splitlines():
        key, _, value = line.partition(": ")
        fields.setdefault(key, []).append(value)
    return fields


def check_info(fields: dict, man: dict, what: str) -> None:
    """`info` against the manifest, and the host on the card with the served path's flags."""
    import torch

    ratio = man["methods"]["encode"]["out_ratio"]
    want = {"name": [man["name"]], "sampling_rate": [str(man["sampling_rate"])],
            "block_size": [str(man["block_size"])], "n_channels": [str(man["n_channels"])],
            "stream_batch": [str(man["stream_batch"])], "latent_size": [str(man["latent_size"])],
            "latent_family": [man["latent_family"]],
            "frames_per_block": [str(man["block_size"] // ratio)],
            "total_latency_samples": [str(man["latency"]["total_samples"])],
            "device": [f"cuda:0 ({torch.cuda.get_device_name(0)})"], "steps": ["cuda graph"],
            "cudnn": ["enabled 1 deterministic 0 benchmark 0 allow_tf32 0"],
            "matmul": ["allow_tf32 0"],
            "torchscript": ["profiling_executor 0 profiling_mode 0 optimize 0"],
            "aot_method": sorted(man["aot"]), "attribute": man["attributes"]}
    got = {k: sorted(fields.get(k, [])) if k == "aot_method" else fields.get(k, [])
           for k in want}
    check(got == want, f"{what}: rtpu_host info {got}, expected {want}")


def host_signal(path: Path, n: int, seed: int, scale: float = 0.3):
    """A seeded mono float32 wav of `n` samples (read back exactly by both sides)."""
    import numpy as np
    from scipy.io import wavfile

    x = (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)
    wavfile.write(path, SAMPLE_RATE, x)
    return x


def host_blocks(x, block: int):
    """`x` zero-padded to whole blocks, as the host streams it: [1, 1, block] tensors."""
    import numpy as np
    import torch

    n = -(-len(x) // block)
    xp = np.zeros(n * block, np.float32)
    xp[:len(x)] = x
    return [torch.from_numpy(xp[i * block:(i + 1) * block]).reshape(1, 1, block)
            for i in range(n)]


def eager_stream(art, method: str, blocks, seed_base: int, state=None, fills=()):
    """`method` streamed eagerly (`art.stream_steps`, called directly) over
    `blocks` on the card from `state` (the artifact's initial state), block i
    with the host's seed of block i, after the AdaIN `fills` ((leaf, value));
    the outputs concatenated on the CPU, and the state after."""
    import torch

    from rave_tpu_torch.export.artifact import prior_step_seed
    from rave_tpu_torch.train.loop import fp32_exact

    state = [t.clone() for t in (art.stream_state if state is None else state)]
    for leaf, value in fills:
        for i in art.adain_indices:
            if art.slots[i][2] == leaf:
                state[i].fill_(value)
    outs = []
    with torch.no_grad(), fp32_exact():
        for i, xb in enumerate(blocks):
            seed = torch.tensor(prior_step_seed(seed_base, i), dtype=torch.int64, device="cuda")
            y, state = art.stream_steps[method](state, xb.cuda(), seed)
            outs.append(y.cpu())
    return torch.cat(outs, -1), state


def wav_err(path: Path, y) -> float:
    """The wav `path` (int16) against the float output `y` [T] clamped to [-1, 1]."""
    import numpy as np
    from scipy.io import wavfile

    sr, written = wavfile.read(path)
    want = y.clamp(-1, 1).numpy()
    check(sr == SAMPLE_RATE and written.shape == want.shape,
          f"{path.name}: {sr} Hz, {written.shape}, expected {want.shape}")
    return float(np.abs(written / 32767 - want).max())


def state_equal(path: Path, state) -> bool:
    from rave_tpu_torch.export.native_host import read_state

    return states_equal(read_state(path, [t.cpu() for t in state]), [t.cpu() for t in state])


def host_bench(host: Host, path: Path, what: str) -> dict:
    """`rtpu_host bench` of the forward: p50 and p95 ms per block (upload,
    step, fetch, synchronize) of the graph replays the commands serve and of
    the eager interpreter on the same blocks, the budget it prints; the
    graph's outputs and final state bit-equal to the eager ones."""
    import re

    out = host.stream(f"{what} bench", HOST_BENCH_BLOCKS + 8, path, "bench", HOST_BENCH_BLOCKS,
                      "forward")
    times = {k: re.search(rf"per-block forward{tag}: p50 ([0-9.]+) ms\s+p95 ([0-9.]+) ms", out)
             for k, tag in (("graph", ""), ("eager", " eager"))}
    b = re.search(r"budget ([0-9.]+) ms/block", out)
    equal = re.search(r"graph vs eager over (\d+) blocks: outputs bit-equal (\d), state "
                      r"bit-equal (\d)", out)
    check(all(times.values()) and b is not None and "device: cuda:0 (" in out
          and equal is not None, f"rtpu_host bench {what}: {out[-800:]}")
    check(equal.groups() == (str(HOST_BENCH_BLOCKS + 8), "1", "1"),
          f"rtpu_host bench {what}: {equal.group(0)}")
    return {"p50_ms": float(times["graph"].group(1)), "p95_ms": float(times["graph"].group(2)),
            "eager_p50_ms": float(times["eager"].group(1)),
            "eager_p95_ms": float(times["eager"].group(2)), "budget_ms": float(b.group(1)),
            "graph_bit_equal": True}


def phase_host(build: HostBuild, artifacts: dict, python_p50: dict, card: str) -> dict:
    """The artifact host on the card (`card`: its name and power limit), on
    the artifacts of phases `export` (v2), `prior`, `discrete` and `v3`, each
    streaming command served by one captured CUDA graph; `python_p50` is the
    served (`graph`) and `eager` p50 of each family's artifact as its phase
    timed it (`Lockstep`: blocks already on the card, nothing fetched),
    printed beside the host's; see the module docstring."""
    import numpy as np
    import torch

    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.ops.kernels import dilated_unit

    t_phase = time.perf_counter()
    binary, build_s = build.result()
    host = Host(binary)
    work = ROOT / "build" / "host" / "work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    paths = {k: ROOT / v for k, v in artifacts.items()}
    reset_counts()
    out = {"build_s": build_s, "binary": str(Path(binary).relative_to(ROOT)), "families": {},
           # what the TorchScript programs add to each artifact
           "artifact_mib": {name: {kind: sum(f.stat().st_size for f in path.glob(pattern)) / 2**20
                                   for kind, pattern in (("all", "*"), ("ts", "*.ts"),
                                                         ("state", "*.state"))}
                            for name, path in paths.items()}}
    infos = _in_threads([functools.partial(host_info, host, path, name)
                         for name, path in paths.items()])
    for (name, path), fields in zip(paths.items(), infos):
        check_info(fields, json.loads((path / "manifest.json").read_text()), name)

    # v2 and discrete: encode bit-equal, forward (and v2's decode) within the wav's rounding;
    # the host's commands of both families run side by side (processes of their own; v2's
    # decode reads its encode's latents), then each family's eager stream is compared
    arts, xs = {}, {}
    for name in ("v2", "discrete"):
        arts[name] = ExportedRAVE(str(paths[name]), device="cuda")
        xs[name] = host_signal(work / f"{name}.wav", HOST_BLOCKS * arts[name].block_size - 100,
                               seed=len(name))

    def encode(name):
        host.stream(f"{name} encode", HOST_BLOCKS, "--save-state", work / f"{name}_enc.state",
                    paths[name], "encode", work / f"{name}.wav", work / f"{name}_z.f32",
                    HOST_SEED)
        if name == "v2":
            host.stream("v2 decode", HOST_BLOCKS, "--save-state", work / "v2_dec.state",
                        paths[name], "decode", work / "v2_z.f32", work / "v2_dec.wav",
                        HOST_SEED + 2)

    def forward(name):
        host.stream(f"{name} forward", HOST_BLOCKS, "--save-state", work / f"{name}_fwd.state",
                    paths[name], "forward", work / f"{name}.wav", work / f"{name}_fwd.wav",
                    HOST_SEED + 1)

    _in_threads([functools.partial(run, name) for name in arts for run in (encode, forward)])
    for name in ("v2", "discrete"):
        path, art, x = paths[name], arts.pop(name), xs[name]
        B, L = art.block_size, art.latent_size
        blocks = host_blocks(x, B)
        r = {"block": B}
        z = np.fromfile(work / f"{name}_z.f32", np.float32).reshape(-1, L)
        z_py, state = eager_stream(art, "encode", blocks, HOST_SEED)
        z_py = z_py[0].T.numpy()
        r["encode_bit_equal"] = z.shape == z_py.shape and bool(np.array_equal(z, z_py))
        r["encode_max_abs_err"] = float(np.abs(z - z_py).max()) if z.shape == z_py.shape else None
        r["encode_state_bit_equal"] = state_equal(work / f"{name}_enc.state", state)
        check(r["encode_bit_equal"], f"{name}: the host's encode latents {z.shape} are not "
                                     f"bit-equal to the Python eager stream's {z_py.shape} "
                                     f"(max abs err {r['encode_max_abs_err']})")
        y, state = eager_stream(art, "forward", blocks, HOST_SEED + 1)
        r["forward_wav_err"] = wav_err(work / f"{name}_fwd.wav", y[0, 0, :len(x)])
        r["forward_state_bit_equal"] = state_equal(work / f"{name}_fwd.state", state)
        if name == "v2":
            frames = B // art.cfg.decimation()
            zb = [torch.from_numpy(z[i * frames:(i + 1) * frames].T.copy())[None]
                  for i in range(len(blocks))]
            y, state = eager_stream(art, "decode", zb, HOST_SEED + 2)
            r["decode_wav_err"] = wav_err(work / "v2_dec.wav", y[0, 0])
            r["decode_state_bit_equal"] = state_equal(work / "v2_dec.state", state)
        errs = {k: v for k, v in r.items() if k.endswith("wav_err")}
        check(max(errs.values()) <= WAV_TOL, f"{name}: host wavs {errs} > 1/32767")
        r["bench"] = host_bench(host, path, name)
        out["families"][name] = r
        del art

    # v3: learn the target, learn the source, transfer, each a process of its own
    path = paths["v3"]
    art = ExportedRAVE(str(path), device="cuda")
    B, n_blocks = art.block_size, 8
    target = host_signal(work / "target.wav", n_blocks * B, seed=31, scale=0.5)
    source = host_signal(work / "source.wav", n_blocks * B, seed=32, scale=0.1)
    plan = [(["--attr", "learn_target=1"], "target", [("learn_y", 1.0)]),
            (["--attr", "learn_target=0", "--attr", "learn_source=1"], "source",
             [("learn_y", 0.0), ("learn_x", 1.0)]),
            (["--attr", "learn_source=0"], "source", [("learn_x", 0.0)])]
    state, r = None, {"block": B, "wav_err": [], "state_bit_equal": []}
    for k, (flags, which, fills) in enumerate(plan):
        load = ["--load-state", work / f"v3_{k - 1}.state"] if k else []
        host.stream(f"v3 forward {k}", n_blocks, *flags, *load, "--save-state",
                    work / f"v3_{k}.state", path, "forward", work / f"{which}.wav",
                    work / f"v3_{k}.wav", HOST_SEED + 10 * k)
        x = target if which == "target" else source
        y, state = eager_stream(art, "forward", host_blocks(x, B), HOST_SEED + 10 * k, state,
                                fills)
        r["wav_err"].append(wav_err(work / f"v3_{k}.wav", y[0, 0]))
        r["state_bit_equal"].append(state_equal(work / f"v3_{k}.state", state))
    learned = [float(s.flatten()[0]) for (n, _, _), s in zip(art.slots, state)
               if n.endswith("num_update_y") or n.endswith("num_update_x")]
    check(max(r["wav_err"]) <= WAV_TOL and min(learned) > 0,
          f"v3 AdaIN across processes: wavs {r['wav_err']} > 1/32767, or a statistic not "
          f"learned ({min(learned)} updates)")
    r["bench"] = host_bench(host, path, "v3")
    out["families"]["v3"] = r
    del art

    # the prior: dithered, against sample_prior on the card
    path = paths["prior"]
    art = ExportedRAVE(str(path), device="cuda")
    host.stream("prior", HOST_PRIOR_FRAMES - 1 + art.prior_step.prior.latent_size, path, "prior",
                HOST_PRIOR_FRAMES, work / "prior_z.f32", HOST_SEED)
    z = np.fromfile(work / "prior_z.f32", np.float32).reshape(HOST_PRIOR_FRAMES, -1)
    z_py = art.sample_prior(HOST_PRIOR_FRAMES, seed=HOST_SEED)[0].T.cpu().numpy()
    bit_equal = z.shape == z_py.shape and bool(np.array_equal(z, z_py))
    check(bit_equal, f"prior: the host's latents {z.shape} are not bit-equal to sample_prior's "
                     f"{z_py.shape}")
    out["prior"] = {"frames": HOST_PRIOR_FRAMES, "steps": HOST_PRIOR_FRAMES - 1 +
                    art.prior_step.prior.latent_size, "bit_equal": bit_equal}
    del art
    check(dilated_unit.launches == 0, f"phase host: {dilated_unit.launches} unit launches")
    for name, r in out["families"].items():
        check(r["bench"]["p50_ms"] < r["bench"]["budget_ms"],
              f"{name}: the host's p50 {r['bench']['p50_ms']:.3f} ms per block over the "
              f"{r['bench']['budget_ms']:.2f} ms budget")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(HOST_ARTIFACTS, ignore_errors=True)
    for name, r in out["families"].items():
        r["python_p50_ms"] = python_p50[name]
    out["launches"] = dilated_unit.launches
    out["command_s"], out["capture_s"] = host.seconds, host.capture_s
    out["seconds"] = time.perf_counter() - t_phase
    fam = out["families"]
    print(f"host: rtpu_host built in {build_s:.1f} s (g++ against torch {torch.__version__}); "
          f"info agrees with the manifests, cuda:0 ({torch.cuda.get_device_name(0)}); "
          f"{HOST_BLOCKS} blocks of v2 and discrete: encode bit-equal to the Python eager "
          f"stream (states bit-equal: v2 {fam['v2']['encode_state_bit_equal']}, discrete "
          f"{fam['discrete']['encode_state_bit_equal']}); wavs from the eager stream: v2 forward "
          f"{fam['v2']['forward_wav_err']:.2e}, decode {fam['v2']['decode_wav_err']:.2e}, "
          f"discrete forward {fam['discrete']['forward_wav_err']:.2e} <= 1/32767; v3 AdaIN in "
          f"3 processes {', '.join(f'{e:.2e}' for e in fam['v3']['wav_err'])} (states bit-equal "
          f"{fam['v3']['state_bit_equal']}); prior {HOST_PRIOR_FRAMES} frames bit-equal to "
          f"sample_prior; every command's steps one captured CUDA graph, replayed per block "
          f"(warm-up and capture {min(host.capture_s.values()):.2f}-"
          f"{max(host.capture_s.values()):.2f} s per process); 0 unit launches; artifacts "
          + ", ".join(f"{k} {v['all']:.1f} MiB (.ts {v['ts']:.1f}, .state {v['state']:.2f})"
                      for k, v in out["artifact_mib"].items())
          + f"; phase {out['seconds']:.1f} s, of which host commands "
          f"{sum(host.seconds.values()):.1f} s ({len(host.seconds)} processes)", flush=True)
    print(f"host bench on {card} (ms per block, upload + step + fetch + synchronize, "
          f"{HOST_BENCH_BLOCKS} blocks): " + "; ".join(
              f"{k} host graph p50 {r['bench']['p50_ms']:.3f} p95 {r['bench']['p95_ms']:.3f}, "
              f"eager p50 {r['bench']['eager_p50_ms']:.3f} p95 {r['bench']['eager_p95_ms']:.3f}, "
              f"graph bit-equal to eager; Python served {r['python_p50_ms']['graph']:.3f} eager "
              f"{r['python_p50_ms']['eager']:.3f} (its phase's blocks on the card, nothing "
              f"fetched) (budget {r['bench']['budget_ms']:.2f})" for k, r in fam.items()),
          flush=True)
    return out


def main() -> None:
    if not (ROOT / KERNEL_SOURCE).is_file():
        raise SystemExit(f"chip_smoke: {KERNEL_SOURCE} not found; run from a checkout")
    sys.path.insert(0, str(ROOT))
    import torch

    card = phase_device()
    seconds = {}

    def timed(name: str, phase, *args):
        t0 = time.perf_counter()
        result = phase(*args)
        seconds[name] = time.perf_counter() - t0
        return result

    host_build = HostBuild()  # g++ on the CPU while the phases below work the card
    build_info = timed("build", phase_build)
    from rave_tpu_torch.ops.kernels.unit_op import ensure_library

    op_build = HostBuild(ensure_library)  # the op library links the kernel library just built
    rows = timed("kernel", phase_kernel)
    rows_bf16 = timed("kernel_bf16", phase_kernel_bf16)
    offline = timed("offline", phase_offline)
    grad = timed("grad", phase_grad)
    train = timed("train", phase_train)
    train_bf16 = timed("train_bf16", phase_train_bf16, tuple(train["crop_frames"]))
    remat = timed("remat", phase_remat, tuple(train["crop_frames"]))
    train_graph = timed("train_graph", phase_train_graph, tuple(train["crop_frames"]))
    loop = timed("loop", phase_loop, train["ms_per_step"], train_bf16["ms_per_step"])
    export = timed("export", phase_export, ROOT / loop["run_dir"])
    db = ROOT / "build" / "loop" / "db"
    prior = timed("prior", phase_prior, ROOT / loop["run_dir"], db)
    op_library, op_build_s = op_build.result()
    print(f"op library: {Path(op_library).relative_to(ROOT)} built by g++ in {op_build_s:.1f} s"
          f" beside the phases above", flush=True)
    v1 = timed("v1", phase_v1, ROOT / loop["run_dir"], db)
    v2_artifact = keep_for_host("v2", ROOT / export["artifacts"]["streaming_ema"]["path"])
    shutil.rmtree(ROOT / "build" / "loop" / "runs", ignore_errors=True)  # ~0.7 GB per checkpoint
    shutil.rmtree(ROOT / "build" / "loop" / "export", ignore_errors=True)
    spectral = timed("spectral", phase_spectral, tuple(train["crop_frames"]))
    imported = timed("import", phase_import)
    native = timed("native", phase_native, loop)
    remote = timed("remote", phase_remote, tuple(train["crop_frames"]))
    parallel = timed("parallel", phase_parallel)
    discrete = timed("discrete", phase_discrete)
    stream = timed("stream", phase_stream)  # phases whose served streams are new run last
    variants = timed("variants", phase_variants)
    v3 = timed("v3", phase_v3)
    portable = timed("portable", phase_portable, {
        **v1["portable"], "discrete": discrete["portable"], "v3": v3["portable"]}, offline)
    host = timed("host", phase_host, host_build, {
        "v2": v2_artifact, "prior": prior["host_artifact"],
        "discrete": discrete["export"]["path"], "v3": v3["export"]["path"]}, {
        "v2": export["served"]["v2"]["p50_ms"], "discrete": discrete["export"]["served"]["p50_ms"],
        "v3": v3["export"]["served"]["p50_ms"]}, card)
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "rave_tpu"))
    check(not foreign, f"the port loaded the JAX package or jax: {foreign[:5]}")

    # one main-path call's 22 units: each centered shape in encoder and decoder
    main_rows = [r for r in rows if r["case"] == "main" and r["mode"] == "centered"] * 2
    main_bf16 = [r for r in rows_bf16 if r["case"] == "main" and r["mode"] == "centered"
                 and r["B"] == TRAIN_BATCH] * 2
    bound32 = unit_bound(main_rows, BATCH, "fp32")
    bound16 = unit_bound(main_bf16, TRAIN_BATCH, "bf16")
    export_rows = export["unit_b1"] * 2  # generate's forward: each shape in encoder and decoder
    parallel_rows = parallel["unit_rows"] * 2  # a rank's forward at B=4: encoder and decoder
    # the discrete forward's 22 units at B=16: v2's shapes but C=768 at T=256
    discrete_rows = [r for r in main_rows if r["C"] != 768] + [
        r for r in discrete["kernel_rows"] if r["B"] == BATCH] * 2
    bounds = {"fp32_b16_forward": bound32, "bf16_b8_forward": bound16,
              "fp32_b1_generate_forward": unit_bound(export_rows, 1, "fp32"),
              "fp32_b16_discrete_forward": unit_bound(discrete_rows, BATCH, "fp32"),
              "fp32_b4_dp_forward": unit_bound(parallel_rows, DP_BATCH, "fp32"),
              **{f"{k}_b8_fwd_bwd": unit_bound(grad[f"{k}_v2"] * 2, TRAIN_BATCH, k,
                                               backward=True) for k in ("fp32", "bf16")},
              **{f"{k}_b8_backward": unit_bwd_bound(grad[f"{k}_v2"] * 2, TRAIN_BATCH, k)
                 for k in ("fp32", "bf16")}}
    # each variant's forward: its units at B=16 (fp32, its path) and B=8 (bf16)
    variant_units = {f"{p}_{kind}": unit_rows_of(r, p, b) for p in VARIANTS
                     for kind, r, b in (("fp32_b16", rows, BATCH), ("bf16_b8", rows_bf16,
                                                                     TRAIN_BATCH))}
    bounds.update({f"{k}_forward": unit_bound(v, BATCH if "b16" in k else TRAIN_BATCH,
                                              k.split("_")[-2])
                   for k, v in variant_units.items()})
    print("bounds (a forward's units): " + "; ".join(
        f"{k} {b['bound_ms']:.3f} ms ({b['bound_by']})" for k, b in bounds.items()), flush=True)

    def per_variant(kind: str) -> dict:
        return {key: {p: (sum(r[key] for r in variant_units[f"{p}_{kind}"]) if key != "bound_ms"
                          else bounds[f"{p}_{kind}_forward"]["bound_ms"]) for p in VARIANTS}
                for key in ("ms", "plain_ms", "bound_ms")}
    def backward_entry(kind: str, run: dict) -> dict:
        """The gradient kernel of `kind`: its launches on the main path (phase
        `train`'s steps, `bwd_per_step` each) and elsewhere, and its times at
        a B=8 pre-warmup step's 22 units (each v2 shape in encoder and decoder)."""
        units = grad[f"{kind}_v2"] * 2
        bound = bounds[f"{kind}_b8_backward"]
        entry = {"name": "fused_dilated_unit_backward" + ("_bf16" if kind == "bf16" else ""),
                 "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_BWD_REPLACES,
                 "launches": run["launches_backward"],
                 "launches_per_step": run["launches_backward_per_step"],
                 "launches_train_graph": graph_launches(
                     train_graph, ("fp32", "remat") if kind == "fp32" else ("bf16",),
                     2 if kind == "fp32" else 3),
                 "launches_loop": loop["launches"][f"bwd_{kind}"],
                 "launches_native": native["launches"][f"bwd_{kind}"],
                 "max_abs_err": max(r["max_abs_err"] for r in grad[kind]),
                 "grad_shapes": len(grad[kind]),
                 "fwd_bwd_ms": sum(r["fwd_bwd_ms"] for r in units),
                 "plain_fwd_bwd_ms": sum(r["plain_fwd_bwd_ms"] for r in units),
                 "bound_ms_fwd_bwd": bounds[f"{kind}_b8_fwd_bwd"]["bound_ms"],
                 "ms": sum(r["bwd_ms"] for r in units),
                 "plain_ms": sum(r["plain_bwd_ms"] for r in units),
                 "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": None,
                 # one launch of the weight gradients per call, and its time beside cuDNN's
                 "kernels_per_call": BWD_KERNELS,
                 **{k: sum(r[k] for r in units) for k in ("wgrad_ms", "library_wgrad_ms",
                                                         "wgrad_bound_ms")}}
        if kind == "fp32":
            entry.update(launches_remat_step=remat["remat_launches_backward"],
                         launches_remote=remote["launches_backward"],
                         launches_parallel=parallel["launches_backward"],
                         launches_by_step_parallel=parallel["launches_backward_by_step"])
        return entry

    kernels = {"kernels": [{
        "name": "fused_dilated_unit", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": offline["launches"],
        "launches_train": train["launches"], "launches_remat_step": remat["remat_launches"],
        # phase train_graph's traced replays, fp32 and remat: the card's trace counts them
        # (a replay runs no Python; the wrappers count a warm-up's and a capture's launches)
        "launches_train_graph": graph_launches(train_graph, ("fp32", "remat"), 0),
        "launches_loop": loop["launches"]["fp32"],
        "launches_export": export["generate_launches"],
        "launches_discrete": discrete["launches"],
        "launches_v3": v3["launches"],  # Snake units bypass the kernel, as in rave_tpu
        "launches_variants": variants["launches"],
        "launches_v1": v1["launches"],  # v1 has no DilatedUnit, as in rave_tpu
        "launches_host": host["launches"],  # the artifact host streams no unit
        "launches_onnx_verify": v1["launches_onnx_verify"],  # the v2 run's live forward
        # the registered op's launches in one call of each portable program (v2 at B=16 and
        # B=1, discrete, v3), counted by the op library in a process without the port
        "launches_portable": portable["launches"],
        "max_abs_err_portable_op": portable["op_max_abs_err"],
        "ms_portable_op_b16": portable["op_ms_b16"],
        # v2 + spectral_discriminator and the other distances: 22 per step
        "launches_spectral": spectral["launches"] - spectral["launches_bf16"],
        # import_torch 0, export's smoke decode 11, generate's forward 22
        "launches_import": imported["launches"],
        **{f"{k}_import": imported["unit_path"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                            "max_abs_err")},
        **{f"{k}_onnx_verify": v1["onnx"]["v2"]["unit_path"][k]
           for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
        "launches_prior": prior["launches"],  # train_prior, export --prior, generate
        # cli train --device_data off on the C++ sampler, fp32 and bf16: 22 per step and
        # per validation batch (fp32); 3 v2 steps on HTTP batches; the 2 ranks' 3 steps each
        "launches_native": native["launches"]["fp32"],
        "launches_native_bf16": native["launches"]["bf16"],
        "launches_remote": remote["launches"], "launches_parallel": parallel["launches"],
        "launches_by_step_native": native["launches_by_step"],
        "launches_by_step_remote": remote["launches_by_step"],
        "launches_by_step_parallel": parallel["launches_by_step"],  # per rank
        "ms_parallel_b4": sum(r["ms"] for r in parallel_rows),
        "plain_ms_parallel_b4": sum(r["plain_ms"] for r in parallel_rows),
        "bound_ms_parallel_b4": bounds["fp32_b4_dp_forward"]["bound_ms"],
        "max_abs_err_parallel_b4": max(r["max_abs_err"] for r in parallel["unit_rows"]),
        **{f"{k}_prior": prior["unit_path"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                          "max_abs_err")},
        **{f"{k}_variants_b16": v for k, v in per_variant("fp32_b16").items()},
        "ms_discrete_b16": sum(r["ms"] for r in discrete_rows),
        "plain_ms_discrete_b16": sum(r["plain_ms"] for r in discrete_rows),
        "bound_ms_discrete_b16": bounds["fp32_b16_discrete_forward"]["bound_ms"],
        "ms_export_b1": sum(r["ms"] for r in export_rows),
        "plain_ms_export_b1": sum(r["plain_ms"] for r in export_rows),
        "bound_ms_export_b1": bounds["fp32_b1_generate_forward"]["bound_ms"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in main_rows), "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": bound32["bound_ms"], "bound_by": bound32["bound_by"], "library_ms": None,
    }, {
        "name": "fused_dilated_unit_bf16", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": train_bf16["launches"],
        "launches_train_graph": graph_launches(train_graph, ("bf16",), 1),
        "launches_loop": loop["launches"]["bf16"],
        "launches_spectral": spectral["launches_bf16"],  # the bf16 steps of phase spectral
        **{f"{k}_variants_b8": v for k, v in per_variant("bf16_b8").items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows_bf16),
        "ms": sum(r["ms"] for r in main_bf16), "plain_ms": sum(r["plain_ms"] for r in main_bf16),
        "bound_ms": bound16["bound_ms"], "bound_by": bound16["bound_by"], "library_ms": None,
    }, backward_entry("fp32", train), backward_entry("bf16", train_bf16)]}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build": build_info, "op_build_s": op_build_s,
         "kernel_shapes": rows, "kernel_bf16_shapes": rows_bf16,
         "bounds": bounds,
         "offline": offline, "stream": stream, "grad_shapes": grad, "train": train,
         "train_bf16": train_bf16, "remat": remat, "train_graph": train_graph, "loop": loop,
         "export": export,
         "prior": prior, "discrete": discrete, "v3": v3, "variants": variants, "v1": v1,
         "spectral": spectral, "import": imported, "native": native, "remote": remote,
         "parallel": parallel, "portable": portable, "host": host, "phase_seconds": seconds,
         **kernels},
        indent=1))
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; {sum(seconds.values()):.1f} in all", flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
