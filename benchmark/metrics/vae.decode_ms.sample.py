"""vae.decode_ms.sample: the VAE decode of a request
(`stage_seconds["decode"]`), averaged over the window's requests, in ms."""


def read(w):
    st = w.get("stage_seconds")
    if not st:
        return None
    return sum(s["decode"] for s in st) / len(st) * 1e3
