"""dit_train.forward_ms: the DiT-3D step's loss alone (the DiT's forward
in train mode, its graph dropped), synced, over a window of its own, in
ms."""


def read(w):
    return w.get("layer", {}).get("forward_ms")
