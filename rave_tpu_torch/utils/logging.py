"""Metrics logging: JSONL always; TensorBoard where its package imports.

The port's counterpart of rave_tpu/utils/logging.py::MetricsLogger, with the
same files and formats in the run dir: `metrics.jsonl` (one
{"step", "time", metric...} object per line), `status.json` (a poll-able
progress side channel, the reference's ProgressLogger) and `<tag>.txt`.
TensorBoard events go to `tb/` only where the `tensorboard` package is
installed and tensorflow is not: with tensorflow present, importing
tensorboard loads it, and with it the whole stack tensorflow imports (jax
among them). Elsewhere the logger writes the JSON files alone.
"""
from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path
from typing import Dict


class MetricsLogger:
    def __init__(self, run_dir: str):
        self.dir = Path(run_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a")
        self.tb = _summary_writer(self.dir / "tb")

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), int(step))

    def log_text(self, tag: str, text: str, step: int = 0):
        if self.tb is not None:
            self.tb.add_text(tag, f"```\n{text}\n```", step)
        (self.dir / f"{tag}.txt").write_text(text)

    def log_audio(self, tag: str, audio, sr: int, step: int):
        if self.tb is not None:
            self.tb.add_audio(tag, audio.reshape(1, -1), step, sample_rate=sr)

    def update_status(self, **kw):
        status_path = self.dir / "status.json"
        cur = {}
        if status_path.exists():
            try:
                cur = json.loads(status_path.read_text())
            except json.JSONDecodeError:
                cur = {}
        cur.update(kw)
        status_path.write_text(json.dumps(cur))

    def close(self):
        self._jsonl.close()
        if self.tb is not None:
            self.tb.close()


def _summary_writer(log_dir: Path):
    """A TensorBoard writer, or None where tensorboard is missing or would
    load tensorflow."""
    if importlib.util.find_spec("tensorflow") is not None:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=str(log_dir))
