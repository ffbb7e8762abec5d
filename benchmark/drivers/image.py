"""Driver `image`: one client in a closed loop calling the port's
`SuperResolutionPipeline.process()` on the mix's LR tiles (harness/
traffic.py draws request i's tile from (seed, i) and writes it as a PNG),
the next request when the last one returns. The window runs to the end of
the image in flight. One image of the window, drawn from the seed, is
judged against the plain reference (harness/check.py).

A driver module gives, for harness/cell.py:
- `build(spec, mix, seed, work, device)`: the system under test, through
  the configuration's builder (builders/<builder>.py);
- `warm_up(system)`: requests at the cell's shapes until nothing is left
  to build or capture; returns how many;
- `request(system)`: one request, its record (what the metric readers
  read);
- `window(system, seconds)`: (records, seconds) of the measured window;
- `release(system)`: frees the system's device state;
- `judge(system, records, control)`: (numbers, readings), the compared
  numbers by name (the configuration's `limits` hold them) and the
  others."""

from __future__ import annotations

import dataclasses
import hashlib
import time
from pathlib import Path

import numpy as np
import torch

from harness import check, manifest, traffic

MAX_WARMUPS = 3


@dataclasses.dataclass
class System:
    spec: dict
    mix: dict
    seed: int
    pipe_seed: int
    device: torch.device
    tiles: Path
    pipe: object
    tok: object
    builder: object
    calls: int = 0
    warm_index: int = -1
    index: int = 0


def pipe_seed(seed: int) -> int:
    """The pipeline's key-chain seed (PRNGKey) of --seed."""
    h = hashlib.sha256(f"pipeline/{int(seed)}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def build(spec: dict, mix: dict, seed: int, work: Path, device) -> System:
    if int(mix.get("clients", 1)) != 1:
        raise ValueError("the image driver runs one client")
    builder = manifest.builder(spec["builder"])
    pseed = pipe_seed(seed)
    pipe, tok = builder.build(spec, mix, seed, pseed, work, device)
    return System(spec, mix, seed, pseed, device, work / "tiles", pipe, tok,
                  builder)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counters():
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    return flash_attention, int4_matmul


def _process(s: System, index: int) -> dict:
    pipe, tok = s.pipe, s.tok
    path = traffic.write_tile(s.mix, s.seed, index, s.tiles)
    before = len(tok.decoded)
    k1, k2 = _counters()
    n1, n2 = k1.launches, k2.launches
    t0 = time.perf_counter()
    pipe.process(str(path))
    _sync(s.device)
    wall = time.perf_counter() - t0
    out = Path(pipe.cfg.output_dir)
    captioned = pipe.llava is not None and len(tok.decoded) > before
    rec = {"index": index, "call": s.calls, "tile": str(path), "wall_s": wall,
           "timings": dict(pipe.timings),
           "caption_stats": dict(pipe.caption_stats) if captioned else None,
           "caption": pipe.last_caption if captioned else "",
           "served": tok.decoded[-1] if captioned else None,
           "dfb": {"hits": int(pipe.last_dfb["hits"]),
                   "steps": int(pipe.last_dfb["steps"]),
                   "trace": [bool(h) for h in pipe.last_dfb["trace"]]},
           "k1_launches": k1.launches - n1, "k2_launches": k2.launches - n2,
           "sr3_png": str(out / f"sr3_{path.stem}.png"),
           "final_png": str(out / f"{path.stem}_final_0.png")}
    s.calls += 1
    return rec


def warm_up(s: System) -> int:
    """Images at the cell's shapes (tiles of their own, indices below 0)
    until every loop's graph is captured."""
    n = 0
    for _ in range(MAX_WARMUPS):
        _process(s, s.warm_index)
        s.warm_index -= 1
        n += 1
        if s.device.type != "cuda" or s.builder.uncaptured(s.pipe) == 0:
            break
    return n


def request(s: System) -> dict:
    """One image outside the window's tiles (the profiled one)."""
    return _process(s, 10_000)


def window(s: System, seconds: float):
    """A closed loop of one client: the next tile when the last image has
    returned, until `seconds` have passed and the image in flight is done."""
    records = []
    t0 = time.perf_counter()
    while not records or time.perf_counter() - t0 < seconds:
        records.append(_process(s, s.index))
        s.index += 1
    return records, time.perf_counter() - t0


def release(s: System):
    s.pipe = None


def judge(s: System, records: list, control: bool):
    """One image of the window, drawn from the seed, against the reference
    (harness/check.py)."""
    rng = np.random.default_rng(traffic.request_seed(s.seed, -999))
    rec = records[int(rng.integers(len(records)))]
    numbers, extra = check.judge(s.spec, rec, s.seed, s.pipe_seed, s.tok,
                                 s.device, control)
    extra["judged_image"] = rec["index"]
    return numbers, extra


def describe(rec: dict) -> str:
    t = rec["timings"]
    cs = rec["caption_stats"]
    return (f"image {rec['index']}: {rec['wall_s']:.3f} s; "
            + " ".join(f"{k} {v:.3f}" for k, v in t.items())
            + (f"; prefill {cs['prefill_s']:.3f} decode {cs['decode_s']:.3f}"
               if cs else ""))
