"""JSONL run / metrics logger (rsvldm_tpu/utils/run_logger.py): a
dependency-free sink that training loops and the pipeline append scalars
to, one JSON line an event, with the run's name and the seconds since the
logger was made."""

from __future__ import annotations

import json
import time
from pathlib import Path


class RunLogger:
    def __init__(self, path: str | Path, run_name: str = "run"):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.run_name = run_name
        self._t0 = time.time()

    def log(self, step: int | None = None, **scalars) -> dict:
        rec = {"run": self.run_name, "t": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def read(self) -> list[dict]:
        if not self.path.exists():
            return []
        return [json.loads(l) for l in self.path.read_text().splitlines() if l]
