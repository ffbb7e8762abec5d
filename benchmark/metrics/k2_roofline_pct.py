"""Kernels, K2 (ops/quant.py, csrc/int4_decode.cu): K2's bound over the
profiled image's caption (every decode step's int4 projections and the
prefill's last-position lm_head, bytes or operations at the card's peak)
over K2's device time in the trace. Nothing is read without a caption, or
where the port's launch counter does not equal the reckoning."""

import sys

from harness import counting, trace

KERNEL = "int4_decode_kernel"


def read(run):
    if run.trace is None or not run.traced["caption_stats"]:
        return None
    r = run.traced
    k2 = counting.k2_image(run.spec, r["caption_stats"]["decode_steps"])
    if k2["launches"] != r["k2_launches"]:
        print(f"k2_roofline_pct: {r['k2_launches']} launches counted, "
              f"{k2['launches']} reckoned; not read", file=sys.stderr)
        return None
    dev = trace.seconds_of(run.trace["by_name"], KERNEL)
    return 100.0 * k2["bound_s"] / dev if dev > 0 else None
