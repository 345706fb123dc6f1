"""Where the port's bf16 pre-warmup gradient leaves the JAX package's (ROADMAP C6).

    JAX_PLATFORMS=cpu python tests/torch_c6_localise.py [log_epsilon]

At tests/test_torch_bf16.py's tiny config and state (v2's log_epsilon,
1e-7, unless given), from the JAX fp32 step as the referee, it prints:

  1. the global relative L2 distance of the pre-warmup gradients (JAX bf16,
     port bf16, port fp32), then per module from the decoder's output back
     to the encoder: where the port's distance jumps against JAX's;
  2. the boundary at the decoder's output: each run's y_mb (the decoder's
     bands, cast to fp32 as both steps do) against the referee's, and the
     cotangent there that the same fp32 loss (the port's distance, equal to
     the JAX package's in tests/test_torch_losses.py) gives on each run's
     y_mb: a cotangent that differs on equally close outputs was made by
     the loss, not by the backward's roundings;
  3. the smallest |STFT| bins of each run's bands and waveform at the
     distance's scales: log(|S| + eps) weights a bin by 1 / (|S| + eps).

A script, not a test: it imports both packages, as the tests do, and is
run by hand.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import test_torch_bf16 as tb  # noqa: E402
from rave_tpu.config import compose as jax_compose  # noqa: E402
from rave_tpu.factory import build_discriminator as jax_build_discriminator  # noqa: E402
from rave_tpu.factory import build_rave as jax_build_rave  # noqa: E402
from rave_tpu.train import state as jax_state  # noqa: E402
from rave_tpu.train import steps as jax_steps  # noqa: E402
from rave_tpu_torch.config import compose  # noqa: E402
from rave_tpu_torch.factory import build_audio_distance  # noqa: E402
from rave_tpu_torch.models.blocks import LatentDraws  # noqa: E402
from rave_tpu_torch.ops.stft import stft  # noqa: E402
from rave_tpu_torch.train.state import create_train_state  # noqa: E402
from rave_tpu_torch.train.steps import autoencode, crop  # noqa: E402
from rave_tpu_torch.utils.convert import convert_tree, from_jax_variables  # noqa: E402


def distance(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def module_distances(run, extra) -> None:
    phase = ("gen", 1, False, 11, extra)
    ref, ref16 = run["fp32"][("gen", False)], run["bf16"][("gen", False)]
    _, g16, module = tb.port_step(run, tb.BF16 + extra, *phase[:3])
    _, g32, _ = tb.port_step(run, extra, *phase[:3])
    want, jax16 = convert_tree(module, ref["grads"]), convert_tree(module, ref16["grads"])
    print(f"gradients from the JAX fp32 step: JAX bf16 {tb.grad_distance(jax16, want):.4g}, "
          f"port bf16 {tb.grad_distance(g16, want):.4g}, port fp32 "
          f"{tb.grad_distance(g32, want):.4g}")
    groups = {}
    for name in want:
        groups.setdefault(".".join(name.split(".")[:4]), []).append(name)
    for group, names in groups.items():
        def dist(g):
            num = sum(float(np.sum((np.asarray(g[k], np.float64) - want[k]) ** 2)) for k in names)
            return (num / max(sum(float(np.sum(want[k] ** 2.0)) for k in names), 1e-300)) ** 0.5
        dj, dp = dist(jax16), dist(g16)
        print(f"  {group:40s} JAX bf16 {dj:.3e}  port bf16 {dp:.3e}  ({dp / max(dj, 1e-30):.1f}x)")


def decoder_boundary(run, extra) -> None:
    cfg = jax_compose(["v2"], tb.TINY + extra)
    model = jax_build_rave(cfg, n_channels=1, train=True)
    state = jax_state.create_train_state(cfg, model, jax_build_discriminator(cfg, n_channels=1),
                                         jax.random.key(0), n_signal=tb.N_SIGNAL)
    variables = {"params": state.gen_params, **state.model_state}
    ys = {}
    for name, overrides in (("JAX fp32", []), ("JAX bf16", tb.BF16)):
        out, _ = jax_steps._autoencode(jax_compose(["v2"], tb.TINY + extra + overrides), model,
                                       variables, jnp.asarray(run["x"]), jax.random.key(11),
                                       False, False, True)
        ys[name] = torch.from_numpy(np.asarray(out["y_bands"], np.float32).transpose(0, 2, 1)
                                    .copy())
    st = create_train_state(compose(["v2"], tb.TINY + tb.BF16 + extra), seed=0, device="cpu")
    from_jax_variables(st.model, {"params": run["gen_params"], "buffers": run["buffers"]})
    x = tb.to_port(run["x"])
    draws = LatentDraws(eps=tb.to_port(run["fp32"][("gen", False)]["eps"]))
    with torch.no_grad():
        ys["port bf16"] = autoencode(st.model, x, draws, False, bf16=True)["y_bands"].float()
    loss_fn = build_audio_distance(compose(["v2"], tb.TINY + extra))
    x_bands = st.model.multiband(x)

    def cotangent(y_mb):
        y = y_mb.clone().requires_grad_()
        y_raw = st.model.synthesize(y)[..., : x.shape[-1]]
        loss = sum(loss_fn(crop(x_bands, tb.CROP),
                           crop(y[..., : x_bands.shape[-1]], tb.CROP)).values())
        loss = loss + sum(loss_fn(x, y_raw).values())
        return torch.autograd.grad(loss, y)[0], y_raw.detach()

    cots = {k: cotangent(y) for k, y in ys.items()}
    ref_y, (ref_c, _) = ys["JAX fp32"], cots["JAX fp32"]
    print(f"decoder output y_mb from JAX fp32's: " + ", ".join(
        f"{k} {distance(y, ref_y):.4g}" for k, y in ys.items() if k != "JAX fp32"))
    print(f"cotangent at y_mb of the same fp32 loss: |JAX fp32| {float(ref_c.norm()):.4g}; " +
          ", ".join(f"{k} |{float(c.norm()):.4g}|, {distance(c, ref_c):.4g} from JAX fp32's, "
                    f"largest {float(c.abs().max()):.4g} at (batch, band, frame) "
                    f"{tuple(int(i) for i in np.unravel_index(int(c.abs().argmax()), c.shape))}"
                    for k, (c, _) in cots.items() if k != "JAX fp32"))
    for k, y in ys.items():
        for scale in compose(["v2"], tb.TINY).distance.scales:
            for what, sig in (("bands", crop(y, tb.CROP)), ("waveform", cots[k][1])):
                mag = stft(sig.reshape(-1, sig.shape[-1]), scale, scale // 4).abs()
                i = int(mag.argmin())
                print(f"  {k:9s} {what:8s} scale {scale}: min |S| {float(mag.min()):.4g} at "
                      f"(row = batch x band, frame, bin) "
                      f"{tuple(int(j) for j in np.unravel_index(i, mag.shape))}")


if __name__ == "__main__":
    eps = sys.argv[1] if len(sys.argv) > 1 else "1e-7"
    extra = [f"distance.log_epsilon={eps}"]
    run = tb.run_jax([("gen", 1, False, 11, extra)], remat=False)
    print(f"log_epsilon {eps}")
    module_distances(run, extra)
    decoder_boundary(run, extra)
