"""The device trace of one whole image: torch.profiler with CUDA activity
alone, reduced without building the profiler's per-event Python objects
(an image runs about 1.4 M kernels): device seconds by kernel name, the
busy union of every device event (kernels, copies, sets), and the longest
idle gaps, named by the kernels around them."""

from __future__ import annotations

import contextlib
import re

import torch


@contextlib.contextmanager
def profiled():
    """Yields a dict that, once the block has ended, holds the reduced
    trace: `by_name` {kernel: seconds}, `busy_s`, `gaps` [(label, s)],
    `events` (device events seen)."""
    from torch.profiler import ProfilerActivity, profile
    out: dict = {}
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    try:
        yield out
    finally:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    out.update(reduce(_device_events(prof)))


def _ns(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, what + "_us")() * 1000)


def _device_events(prof) -> list:
    """[(name, start_ns, end_ns)] of the device's events."""
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        start = _ns(ev, "start")
        rows.append((ev.name(), start, start + _ns(ev, "duration")))
    return rows


_ANON = re.compile(r"\(anonymous namespace\)::")
_HEAD = re.compile(r"^(?:void )?([A-Za-z_][A-Za-z0-9_:]*)")


def short(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    m = _HEAD.match(_ANON.sub("", name))
    return m.group(1) if m else name[:80]


def reduce(rows: list, gaps: int = 10) -> dict:
    by_name: dict = {}
    for name, s, e in rows:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    rows = sorted(rows, key=lambda r: r[1])
    busy, idle = 0, []
    cur_s = cur_e = None
    last_name = None
    for name, s, e in rows:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                idle.append((s - cur_e, f"after {short(last_name)} "
                                        f"before {short(name)}"))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        if e >= cur_e:
            last_name = name
    if cur_e is not None:
        busy += cur_e - cur_s
    idle.sort(reverse=True)
    return {"by_name": by_name, "busy_s": busy * 1e-9, "events": len(rows),
            "gaps": [(label, ns * 1e-9) for ns, label in idle[:gaps]]}


def top(by_name: dict, n: int = 10) -> list:
    """[(short name, seconds)] of the n kernels that took most time, the
    names that share a short name summed."""
    agg: dict = {}
    for name, s in by_name.items():
        agg[short(name)] = agg.get(short(name), 0.0) + s
    return sorted(agg.items(), key=lambda kv: -kv[1])[:n]


def seconds_of(by_name: dict, pattern: str) -> float:
    """Device seconds of the kernels whose name contains `pattern`."""
    return sum(s for name, s in by_name.items() if pattern in name)
