"""prior_train.forward_ms: `prior_loss` alone (the frozen encode and both
priors' forward in train mode, its graph dropped), synced, over a window of
its own, in ms."""


def read(w):
    return w.get("layer", {}).get("forward_ms")
