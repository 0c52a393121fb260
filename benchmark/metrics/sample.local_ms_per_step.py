"""sample.local_ms_per_step: the local prior's chain seconds of every
request (`stage_seconds["local"]`, the program's own span, host clock after
a device sync) over its DDIM steps, in ms."""


def read(w):
    st = w.get("stage_seconds")
    if not st:
        return None
    return sum(s["local"] for s in st) / (len(st) * w["mix"]["ddim_step"]) \
        * 1e3
