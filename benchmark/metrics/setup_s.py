"""setup_s: process start to the first timed unit (import, kernel build or
cache load, weights from the seed, warm-up, the first training steps that
the check replays), host clock."""


def read(w):
    return w["setup_s"]
