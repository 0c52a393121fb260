"""vae_train.forward_ms: `VAE.get_loss` in train mode alone (the step's
forward, its graph dropped), synced, over a window of its own, in ms."""


def read(w):
    return w.get("layer", {}).get("forward_ms")
