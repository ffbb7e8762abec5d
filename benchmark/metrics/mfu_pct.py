"""Device, whole image: the profiled image's model FLOPs (counted from
the configuration's shapes and the image's own cache hits, prompt length
and tokens) over its wall time at the card's bf16 peak."""

from harness import counting, peaks


def read(run):
    if run.trace is None:
        return None
    r = run.traced
    cs = r["caption_stats"]
    flops = counting.image_flops(
        run.spec, r["dfb"]["hits"], r["dfb"]["steps"],
        cs["prompt_len"] if cs else None,
        cs["decode_steps"] + 1 if cs else None)
    return 100.0 * flops / (r["wall_s"] * peaks.BF16_FLOPS)
