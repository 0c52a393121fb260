"""sample.global_ms_per_step: the global prior's chain seconds of every
request (`stage_seconds["global"]`) over its DDIM steps, in ms."""


def read(w):
    st = w.get("stage_seconds")
    if not st:
        return None
    return sum(s["global"] for s in st) / (len(st) * w["mix"]["ddim_step"]) \
        * 1e3
