"""toy_shapes_per_s: shapes completed over the window's whole time."""


def read(w):
    return w["rate"]
