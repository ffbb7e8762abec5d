"""Chunked evaluation runner (rsvldm_tpu/eval/runner.py): each process takes
its chunk of the items (LLaVA model_vqa.py's --num-chunks / --chunk-idx)
and appends one JSON line a result."""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Callable, Iterable


def split_list(lst: list, n: int) -> list[list]:
    """Split into n roughly-equal chunks (model_vqa.py:24-28)."""
    chunk_size = math.ceil(len(lst) / n)
    return [lst[i:i + chunk_size] for i in range(0, len(lst), chunk_size)]


def get_chunk(lst: list, n: int, k: int) -> list:
    chunks = split_list(lst, n)
    return chunks[k] if k < len(chunks) else []


class ChunkedEvalRunner:
    """Run `fn(item) -> dict` over this process's chunk, appending jsonl."""

    def __init__(self, items: list, num_chunks: int = 1, chunk_idx: int = 0):
        self.items = get_chunk(items, num_chunks, chunk_idx)

    def run(self, fn: Callable, out_path: str | Path,
            on_error: str = "record") -> list[dict]:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        results = []
        with open(out_path, "a") as f:
            for item in self.items:
                try:
                    rec = fn(item)
                except Exception as e:
                    if on_error == "raise":
                        raise
                    rec = {"item": str(item), "error": str(e)}
                results.append(rec)
                f.write(json.dumps(rec) + "\n")
                f.flush()
        return results
