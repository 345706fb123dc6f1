#!/usr/bin/env python3
"""Two readings of v3 on one CUDA card that phase `v3` of chip_smoke.py only bounds.

    python3 tools/torch_v3_drift.py [--out v3_drift.json]

from the root of a checkout, on a machine with a CUDA card and nvcc (v2's
runs launch the fused unit). On the smoke's seeded corpus, preprocessed:

  * eval: phase `v3`'s `cli train` (V3_LOOP: 6 steps, 2 of them
    pre-warmup, then adversarial and critic steps) twice from the same
    seeds and data, for v3, for v3 with cuDNN's deterministic algorithms,
    and for v2 on the same schedule; each run then `cli eval`. Reports how
    far two identical runs land apart: the logged losses and validations
    by step, the final weights, and the eval's spectral distance;
  * stream: the first v3 run exported (`--streaming`) and its AdaIN
    attributes driven free-running (chip_smoke.adain_stream: learn a
    target, learn a source, transfer) on the card and on the CPU, each
    held against a float64 run on the CPU of the card's or of the CPU's
    fixed kernels (`freeze_weights` computes them on each device in
    float32; chip_smoke.float64_twin): the card with the smoke's settings
    (TF32 off, cuDNN's choice of algorithms) twice, with cuDNN's
    deterministic algorithms, with cuDNN off (PyTorch's own convolutions),
    with the CPU's fixed kernels, and in float64 with the CPU's kernels;
    the CPU on all its threads and on one. Also: how far the two devices'
    fixed kernels and their float64 runs are apart, the error of each
    transfer block, and the TF32 and cuDNN flags in force inside the step
    calls.

About four minutes of command time. Work in build/v3_drift, deleted at the end.
`--smoke_loop` runs only the stream study, on the weights phase `v3`
itself trains (`chip_smoke._v3_loop`, deterministic, so one tree gives
one set), with the transfer's absolute error and float64 peak by block,
and its error by block when its blocks are fed in reverse order, with
their seeds in stream order and with each block's own seed (about four
minutes).
"""
import argparse
import contextlib
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def cudnn(**flags):
    import torch

    saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)


def train_run(cs, config: str, name: str, db: Path, runs: Path) -> dict:
    """One `cli train` of phase `v3`'s loop, then `cli eval`: the run's
    logged records, its final weights and its eval."""
    import torch

    from rave_tpu_torch.utils import checkpoint

    args = ["train", "--config", config, "--name", name, "--db_path", db, "--out_path", runs,
            "--batch", cs.TRAIN_BATCH, "--n_signal", cs.N_SIGNAL, "--device", "cuda",
            "--val_every", cs.V3_VAL_EVERY, "--save_every", 1000, "--device_data", "on",
            "--max_steps", cs.V3_RESUME_STEPS, "--no_resume"]
    for o in cs.V3_LOOP:
        args += ["--override", o]
    run_dir = Path(cs._cli(args).strip().splitlines()[-1].removeprefix("run dir: "))
    ev = json.loads(cs._cli(["eval", "--run", run_dir, "--db_path", db, "--split", "val",
                             "--device", "cuda"]).strip().splitlines()[-1])
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    final = torch.load(checkpoint.list_checkpoints(str(run_dir))[-1], map_location="cpu",
                       weights_only=True)
    return {"run_dir": run_dir, "records": records, "model": final["model"], "eval": ev}


def apart(cs, a: dict, b: dict) -> dict:
    """How far two runs of one configuration landed apart."""
    by_step = {}
    for ra, rb in zip(a["records"], b["records"]):
        keys = [k for k in ra if k not in ("step", "time", "steps_per_sec") and k in rb]
        by_step.setdefault(ra["step"], {}).update(
            {k: abs(ra[k] - rb[k]) / max(abs(rb[k]), 1e-12) for k in keys})
    weights = {k: cs.rel_err(v, b["model"][k]) for k, v in a["model"].items()  # not the PCA
               if v.is_floating_point() and v.numel() > 1 and "latent_" not in k}
    return {"records_rel_diff": {s: max(d.values()) for s, d in by_step.items() if d},
            "validation": [(r["step"], r["validation"]) for r in a["records"]
                           if "validation" in r],
            "validation_other": [(r["step"], r["validation"]) for r in b["records"]
                                 if "validation" in r],
            "weights_max_rel_diff": max(weights.values()),
            "weights_worst": max(weights, key=weights.get),
            "eval": [a["eval"]["spectral_distance"], b["eval"]["spectral_distance"]]}


def stream_study(cs, run_dir: Path, work: Path) -> dict:
    import torch

    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal

    text = cs._cli(["export", "--run", run_dir, "--streaming", "--output", work / "export",
                    "--device", "cuda"])
    path = str(Path(text.strip().splitlines()[-1].removeprefix("exported: ")))
    wav = work / "v3_in.wav"
    cs.write_signal(wav, cs.EXPORT_SECONDS, seed=23)  # phase `v3`'s file
    art = ExportedRAVE(path, device="cuda")
    B, k = art.block_size, cs.V3_ADAIN_BLOCKS * art.block_size
    x = load_signal(decode_file(str(wav), cs.SAMPLE_RATE, 1), 1, 1, B).cuda()
    segments = {"learn_target": x[..., :k] * 0.3, "learn_source": x[..., k:2 * k],
                "transfer": x[..., 2 * k:4 * k]}
    on_cpu = {n: v.cpu() for n, v in segments.items()}
    in_f64 = {n: v.double() for n, v in on_cpu.items()}
    seen = set()

    def flags(module, args):
        seen.add((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled))

    art.encode_side.register_forward_pre_hook(flags)
    cpu = ExportedRAVE(path, device="cpu")
    with_cpu_kernels = ExportedRAVE(path, device="cuda")
    with_cpu_kernels.model.load_state_dict({k: v.cuda() for k, v in
                                            cpu.model.state_dict().items()})
    twin = cs.float64_twin(cpu)
    refs = {"card": cs.adain_stream(cs.float64_twin(art), in_f64),
            "cpu": cs.adain_stream(twin, in_f64)}
    # the statistics the float64 stream learned: the channels the transfer
    # divides by (std_x + 1e-5), per AdaIN layer, slot 0
    stats = {}
    for (name, _, attr), value in zip(twin.slots, twin.state):
        if attr in ("mean_x", "std_x", "std_y"):
            stats.setdefault(name.rsplit(".", 1)[0], {})[attr] = value[0, :, 0]
    adain = {"min_std_x": min(float(v["std_x"].min()) for v in stats.values()),
             "max_abs_mean_over_std_x": max(float((v["mean_x"].abs() / (v["std_x"] + 1e-5))
                                                  .max()) for v in stats.values()),
             "max_std_y_over_std_x": max(float((v["std_y"] / (v["std_x"] + 1e-5)).max())
                                         for v in stats.values()),
             "channels_std_x_below_1e-4": sum(int((v["std_x"] < 1e-4).sum())
                                              for v in stats.values()),
             "channels": sum(v["std_x"].numel() for v in stats.values())}
    # (reading, its referee: the float64 run of whose fixed kernels)
    runs = {("card", "card"): cs.adain_stream(art, segments)}
    runs[("card", "cpu")] = runs[("card", "card")]
    runs[("card_again", "card")] = cs.adain_stream(art, segments)
    with cudnn(deterministic=True, benchmark=False):
        runs[("card_cudnn_deterministic", "card")] = cs.adain_stream(art, segments)
    with cudnn(enabled=False):
        runs[("card_cudnn_off", "card")] = cs.adain_stream(art, segments)
    runs[("card_with_cpu_kernels", "cpu")] = cs.adain_stream(with_cpu_kernels, segments)
    runs[("card_float64_cpu_kernels", "cpu")] = cs.adain_stream(
        cs.float64_twin(cpu, "cuda"), {n: v.double() for n, v in segments.items()})
    runs[("cpu", "cpu")] = cs.adain_stream(cpu, on_cpu)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs[("cpu_one_thread", "cpu")] = cs.adain_stream(cpu, on_cpu)
    torch.set_num_threads(threads)
    kernels = {k: cs.rel_err(v.cpu(), cpu.model.state_dict()[k], 1e-30)
               for k, v in art.model.state_dict().items() if k.endswith(".w")}
    n_blocks = segments["transfer"].shape[-1] // B

    def per_block(y, want):
        y, want = y.reshape(n_blocks, -1), want.reshape(n_blocks, -1)
        return [cs.rel_err(a, b) for a, b in zip(y, want)]

    def abs_by_block(y, want):
        y, want = y.reshape(n_blocks, -1), want.reshape(n_blocks, -1)
        return [float((a - b).abs().max()) for a, b in zip(y, want)]

    ref_peak = [float(b.abs().max()) for b in refs["card"]["transfer"].reshape(n_blocks, -1)]

    # the transfer's blocks fed in reverse order: an error that follows the
    # content reverses its profile, one that compounds over the stream keeps it
    def reversed_blocks(signal):
        return torch.cat(list(signal.split(B, dim=-1))[::-1], dim=-1)

    rev = {**segments, "transfer": reversed_blocks(segments["transfer"])}
    rev_f64 = {n: v.cpu().double() for n, v in rev.items()}
    reversed_order = {
        "card vs card kernels": per_block(cs.adain_stream(art, rev)["transfer"],
                                          cs.adain_stream(cs.float64_twin(art), rev_f64)
                                          ["transfer"]),
        "cpu vs cpu kernels": per_block(
            cs.adain_stream(cpu, {n: v.cpu() for n, v in rev.items()})["transfer"],
            cs.adain_stream(twin, rev_f64)["transfer"])}

    # and with each transfer block keeping its own seed (the seeds reversed
    # with the blocks): an error that follows the seeds' latent noise then
    # reverses its profile too, one that compounds keeps it
    n_learn = sum(segments[n].shape[-1] // B for n in ("learn_target", "learn_source"))
    seeds = list(range(500, 500 + n_learn)) + [500 + n_learn + j
                                                for j in range(n_blocks)][::-1]

    def seeded(a, segs):
        return cs.adain_stream(a, segs, seeds=seeds)["transfer"]

    reversed_order["card vs card kernels, seeds reversed too"] = per_block(
        seeded(art, rev), seeded(cs.float64_twin(art), rev_f64))
    reversed_order["cpu vs cpu kernels, seeds reversed too"] = per_block(
        seeded(cpu, {n: v.cpu() for n, v in rev.items()}), seeded(twin, rev_f64))

    return {"vs_float64": {f"{r} vs {ref} kernels": {
                seg: cs.rel_err(v, refs[ref][seg]) for seg, v in out.items()}
                for (r, ref), out in runs.items()},
            "transfer_by_block": {f"{r} vs {ref} kernels": per_block(runs[(r, ref)]["transfer"],
                                                                     refs[ref]["transfer"])
                                  for r, ref in (("card", "card"), ("card", "cpu"),
                                                 ("cpu", "cpu"))},
            "transfer_abs_by_block": {f"{r} vs {ref} kernels": abs_by_block(
                runs[(r, ref)]["transfer"], refs[ref]["transfer"])
                for r, ref in (("card", "card"), ("card_cudnn_off", "card"), ("cpu", "cpu"))},
            "transfer_float64_peak_by_block": ref_peak,
            "transfer_by_block_fed_in_reverse": reversed_order,
            "float64_card_kernels_vs_cpu_kernels": {
                seg: cs.rel_err(refs["card"][seg], refs["cpu"][seg]) for seg in refs["cpu"]},
            "fixed_kernels_card_vs_cpu": {"max": max(kernels.values()),
                                          "worst": max(kernels, key=kernels.get),
                                          "unequal": sum(v > 0 for v in kernels.values()),
                                          "of": len(kernels)},
            "adain_statistics_float64": adain,
            "card_repeats_bit_equal": all(
                torch.equal(runs[("card", "card")][s], runs[("card_again", "card")][s])
                for s in refs["cpu"]),
            "flags_in_step_calls": sorted(seen)}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None, help="write the readings here as JSON")
    p.add_argument("--smoke_loop", action="store_true",
                   help="only the stream study, on the weights of phase v3's own loop "
                   "(chip_smoke._v3_loop: deterministic cuDNN, 4 steps resumed to 6)")
    a = p.parse_args()

    import torch

    import chip_smoke as cs

    card = cs.phase_device()
    cs.phase_build()
    work = ROOT / "build" / "v3_drift"
    shutil.rmtree(work, ignore_errors=True)
    cs.write_corpus(work / "corpus")
    db, runs = work / "db", work / "runs"
    cs._cli(["preprocess", "--input_path", work / "corpus", "--output_path", db,
             "--num_signal", cs.N_SIGNAL, "--sampling_rate", cs.SAMPLE_RATE])
    if a.smoke_loop:
        loop = cs._v3_loop(work / "smoke", db)
        out = {"device": card, "stream": stream_study(cs, loop["run_dir"], work)}
        shutil.rmtree(work, ignore_errors=True)
        text = json.dumps(out, indent=1, default=str)
        print(text)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            Path(a.out).write_text(text)
        return
    done = {}
    for label, config, det in (("v3", "v3", False), ("v3_cudnn_deterministic", "v3", True),
                               ("v2", "v2", False)):
        with cudnn(deterministic=det, benchmark=False) if det else contextlib.nullcontext():
            pair = [train_run(cs, config, f"{label}_{i}", db, runs) for i in range(2)]
        done[label] = pair
    out = {"device": card,
           "eval": {label: apart(cs, *pair) for label, pair in done.items()},
           "stream": stream_study(cs, done["v3"][0]["run_dir"], work)}
    shutil.rmtree(work, ignore_errors=True)
    text = json.dumps(out, indent=1, default=str)
    print(text)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
