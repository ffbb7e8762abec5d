"""Caption: the mean prefill seconds of the window's captions (the
captioner's `last_stats["prefill_s"]`: the tower and projector are before
it, the prefill through the decoder and the first token's sample in it)."""


def read(run):
    stats = [r["caption_stats"] for r in run.images if r["caption_stats"]]
    if not stats:
        return None
    return sum(s["prefill_s"] for s in stats) / len(stats)
