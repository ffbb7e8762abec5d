"""VAE and colour fix: the mean seconds of the VAE preparation (twin
encoder, decode, re-encode), the final decode and the wavelet colour
fix."""


def read(run):
    t = [r["timings"] for r in run.images]
    return sum(x["vae_prep"] + x["decode"] + x["colorfix"] for x in t) / len(t)
