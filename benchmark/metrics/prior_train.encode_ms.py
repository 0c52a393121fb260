"""prior_train.encode_ms: the frozen VAE encode alone (eval mode, no
gradient), synced, over a window of its own, in ms."""


def read(w):
    return w.get("layer", {}).get("encode_ms")
