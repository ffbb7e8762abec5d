"""Kernels, K1 (ops/flash_attention.py, csrc/flash_fwd.cu): K1's bound
over the profiled image (its launches' operations or bytes at the card's
peak, counted from the configuration's shapes) over K1's device time in
the trace. Nothing is read where the port's launch counter does not equal
the benchmark's reckoning of the launches."""

import sys

from harness import counting, trace

KERNELS = ("flash_fwd_kernel", "flash_fwd_d256_kernel")


def read(run):
    if run.trace is None:
        return None
    r = run.traced
    cs = r["caption_stats"]
    k1 = counting.k1_image(run.spec, r["dfb"]["hits"], r["dfb"]["steps"],
                           cs["padded_len"] if cs else None)
    if k1["launches"] != r["k1_launches"]:
        print(f"k1_roofline_pct: {r['k1_launches']} launches counted, "
              f"{k1['launches']} reckoned; not read", file=sys.stderr)
        return None
    dev = sum(trace.seconds_of(run.trace["by_name"], k) for k in KERNELS)
    return 100.0 * k1["bound_s"] / dev if dev > 0 else None
