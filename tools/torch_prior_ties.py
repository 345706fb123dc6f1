#!/usr/bin/env python3
"""How far the card's argmax chain of the latent prior parts from the CPU's.

    python3 tools/torch_prior_ties.py [--seeds 0,1,2] [--model ART.rtpu]
        [--priors RUN,RUN] [--loop_priors 0,1] [--latent 128] [--steps 32]
        [--out ties.json]

from the root of a checkout, on a machine with a CUDA card. For each
seeded, untrained stock prior (prior_v1.gin's widths at `--latent`
dimensions), for the prior bundled in `--model` and for the newest
checkpoint of each prior run in `--priors` (`train_prior`'s output) or
trained by `--loop_priors` (chip_smoke.py's phases `device`, `build` and
`loop`, then `train_prior`'s smoke test on the loop's run as phase
`prior` runs it, once per prior seed given), it runs
`chip_smoke.check_prior_codes`'s chain: `steps + D - 1` argmax steps on
the card from a zero frame, the card's own step logits kept; then the
CPU's prior, in float32 and in float64, teacher-forced on the card's
chain. It reports every pick where the card and the CPU's float32 part:
the two logits on each device and in float64, their float32 rounding
scales (`chip_smoke.prior_logits`, the chain's, which the check's window
takes; the output layer's sums alone are reported beside), the CPU's gap
in tie windows (CODE_TIE of the
two magnitudes' sum: a pick may part only within one) and which device
picked the float64 argmax; over all codes, how many have their CPU top two
within one window (the codes rounding alone could part) and the nearest
gap; and over all logits, the card's and the CPU's float32 distance from
float64, absolute, relative to |logit| and to the magnitude, as maxima and
quantiles.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def chain(prior, n_steps: int):
    """The card's argmax chain from a zero frame: frames and step logits [1, D*R, n]."""
    import torch

    from rave_tpu_torch.nn.streaming import init_stream_state
    from rave_tpu_torch.prior.model import sample_prediction

    D, R = prior.latent_size, prior.resolution
    init_stream_state(prior, 1)
    x, frames, logits = torch.zeros(1, D * R, 1, device="cuda"), [], []
    for _ in range(n_steps):
        l = prior.step(x)
        x = sample_prediction(l, D, R, None, argmax=True)
        frames.append(x)
        logits.append(l)
    return torch.cat(frames, -1).cpu(), torch.cat(logits, -1).cpu()


def quantiles(a) -> dict:
    import torch

    a = a.flatten().double()
    q = torch.quantile(a[torch.randperm(len(a), generator=torch.Generator().manual_seed(0))
                         [:2 ** 24]], torch.tensor([0.5, 0.99, 0.9999], dtype=torch.float64))
    return {"max": float(a.max()), "p50": float(q[0]), "p99": float(q[1]),
            "p9999": float(q[2])}


def output_layer_magnitude(prior, inputs):
    """[B, D*R, T]: what float32 sums in the output layer alone, sum_i |w_i h_i|
    + |b| over its inputs h, in float64: a narrower scale than the chain's,
    reported beside it."""
    import torch.nn.functional as F

    out, seen = prior.post_net.layers[-1], []
    hook = out.register_forward_hook(lambda mod, args, res: seen.append(args[0]))
    try:
        prior(inputs)
    finally:
        hook.remove()
    b = None if out.b is None else out.b.double().abs()
    return F.conv1d(F.pad(seen[0].double().abs(), out.pad), out.weight().double().abs(), b,
                    out.stride, 0, out.dilation, out.groups)


def analyse(card_prior, cpu_prior, n: int, code_tie: float) -> dict:
    import copy

    import torch

    import chip_smoke
    from rave_tpu_torch.prior.model import split_classes

    D = card_prior.latent_size
    with torch.no_grad():
        frames, l_card = chain(card_prior, n + D - 1)
        inputs = torch.cat([torch.zeros(1, frames.shape[1], 1), frames[..., :-1]], -1)
        # [D, R, T] each: the CPU's logits, their rounding scale, the output layer's sums
        c32, mag = (t[0] for t in chip_smoke.prior_logits(cpu_prior, inputs))
        mag_out = split_classes(output_layer_magnitude(cpu_prior, inputs), D)[0]
        l64 = copy.deepcopy(cpu_prior).double()(inputs.double())
    l32 = c32.reshape(l64.shape)
    c_card, c64 = (split_classes(t, D)[0] for t in (l_card, l64))  # [D, R, T]
    pick_card, pick32, pick64 = c_card.argmax(1), c32.argmax(1), c64.argmax(1)
    parts = []
    for d, t in (pick_card != pick32).nonzero().tolist():
        a, b = int(pick32[d, t]), int(pick_card[d, t])  # the CPU's pick, the card's
        la, lb = float(c32[d, a, t]), float(c32[d, b, t])
        window = code_tie * float(mag[d, a, t] + mag[d, b, t])
        parts.append({
            "dim": d, "step": t, "cpu_pick": a, "card_pick": b, "f64_pick": int(pick64[d, t]),
            "cpu_f32": [la, lb], "card_f32": [float(c_card[d, a, t]), float(c_card[d, b, t])],
            "f64": [float(c64[d, a, t]), float(c64[d, b, t])],
            "magnitudes": [float(mag[d, a, t]), float(mag[d, b, t])],
            "cpu_rel_gap": (la - lb) / (abs(la) + abs(lb)), "gap_windows": (la - lb) / window,
            "tie": abs(la - lb) <= window,
            "row_max_abs_f64": float(c64[d, :, t].abs().max())})
    # every code's CPU top two, their gap in tie windows (CODE_TIE of their magnitudes' sum)
    top, at = c32.double().topk(2, dim=1)
    gaps = (top[:, 0] - top[:, 1]) / (code_tie * mag.gather(1, at).sum(1)).clamp_min(1e-300)
    err_card, err32 = (l_card.double() - l64).abs(), (l32.double() - l64).abs()
    scale = l64.abs()
    nonzero = scale > 0  # a zero frame's first logits are the biases' exact zeros
    return {"codes": int(pick_card.numel()), "differ": len(parts),
            "ties": sum(p["tie"] for p in parts),
            "outside_window": sum(not p["tie"] for p in parts),
            "codes_in_window": int((gaps <= 1).sum()), "nearest_gap_windows": float(gaps.min()),
            # each logit's distance from float64 over each scale a tie could be taken in
            **{f"{who}_vs_f64_over_{name}": quantiles(
                (got.double() - l64).abs().reshape(mag.shape) / scale.clamp_min(1e-300))
               for who, got in (("card", l_card), ("cpu", l32))
               for name, scale in (("value", l64.abs().reshape(mag.shape)),
                                   ("output_layer", mag_out), ("chain", mag))},
            "card_is_f64": int((pick_card == pick64).sum()),
            "cpu_is_f64": int((pick32 == pick64).sum()), "parts": parts,
            "card_vs_f64_abs": quantiles(err_card), "cpu_vs_f64_abs": quantiles(err32),
            "card_vs_f64_rel": quantiles(err_card[nonzero] / scale[nonzero]),
            "cpu_vs_f64_rel": quantiles(err32[nonzero] / scale[nonzero]),
            "logit_abs": quantiles(scale)}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="0,1,2", help="untrained stock priors' seeds ('' for none)")
    p.add_argument("--model", default=None, help="also the prior bundled in this artifact")
    p.add_argument("--priors", default="", help="also these prior runs, comma-separated")
    p.add_argument("--loop_priors", default="",
                   help="also priors of these seeds trained on phase loop's run")
    p.add_argument("--latent", type=int, default=128)
    p.add_argument("--steps", type=int, default=32, help="n of check_prior_codes")
    p.add_argument("--out", default=None)
    a = p.parse_args()

    import torch

    import chip_smoke
    from rave_tpu_torch.prior.model import build_prior

    if not torch.cuda.is_available():
        sys.exit("torch_prior_ties.py: no CUDA card")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    priors = [r for r in a.priors.split(",") if r]
    if a.loop_priors:
        chip_smoke.phase_device()
        chip_smoke.phase_build()
        loop = chip_smoke.phase_loop({}, {})
        from rave_tpu_torch.prior.train import train_prior

        for seed in [int(s) for s in a.loop_priors.split(",")]:
            priors.append(train_prior(
                run=str(ROOT / loop["run_dir"]), db_path=str(ROOT / "build" / "loop" / "db"),
                name=f"seed{seed}", out_path=str(ROOT / "build" / "prior_ties"),
                n_signal=chip_smoke.PRIOR_N_SIGNAL, smoke_test=True, seed=seed, device="cuda"))
    results = {}
    for s in [int(s) for s in a.seeds.split(",") if s]:
        card = build_prior(a.latent, seed=s, device="cuda").eval()
        cpu = build_prior(a.latent, seed=s, device="cpu").eval()
        results[f"seed{s}"] = analyse(card, cpu, a.steps, chip_smoke.CODE_TIE)
    if a.model:
        from rave_tpu_torch.export.artifact import ExportedRAVE

        card = ExportedRAVE(a.model, device="cuda").prior_step.prior
        cpu = ExportedRAVE(a.model, device="cpu").prior_step.prior
        results["model"] = analyse(card, cpu, a.steps, chip_smoke.CODE_TIE)
    for run in priors:
        from rave_tpu_torch.prior.model import Prior
        from rave_tpu_torch.utils.checkpoint import read_prior

        pcfg, weights, run_dir = read_prior(run)
        pair = []
        for device in ("cuda", "cpu"):
            prior = Prior(pcfg["latent_size"], pcfg["resolution"], pcfg["res_size"],
                          pcfg["skp_size"], pcfg["kernel_size"], pcfg["cycle_size"],
                          pcfg["n_layers"])
            prior.load_state_dict(weights)
            pair.append(prior.to(device).eval())
        results[str(run_dir)] = analyse(*pair, a.steps, chip_smoke.CODE_TIE)
    for name, r in results.items():
        print(f"{name}: {r['codes']} codes, {r['differ']} differ card vs CPU f32 ({r['ties']} "
              f"ties, {r['outside_window']} outside the window); {r['codes_in_window']} codes' "
              f"CPU top two within the tie window (nearest {r['nearest_gap_windows']:.3g} "
              f"windows); |card - f64| over |f64|, the output layer's magnitude, the "
              f"chain's: max " + " / ".join(f"{r[f'card_vs_f64_over_{k}']['max']:.2e}" for k in (
                  "value", "output_layer", "chain")) + "; "
              f"f64 argmax kept by card {r['card_is_f64']}, CPU {r['cpu_is_f64']}; "
              f"|logit - f64| rel card max {r['card_vs_f64_rel']['max']:.2e} p9999 "
              f"{r['card_vs_f64_rel']['p9999']:.2e}, CPU max {r['cpu_vs_f64_rel']['max']:.2e} "
              f"p9999 {r['cpu_vs_f64_rel']['p9999']:.2e}; abs card max "
              f"{r['card_vs_f64_abs']['max']:.2e}, CPU {r['cpu_vs_f64_abs']['max']:.2e}; "
              f"|logit| p50 {r['logit_abs']['p50']:.3f}", flush=True)
        for part in r["parts"]:
            print("  ", json.dumps(part), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
