"""sample_shapes_per_s: shapes completed over the window's whole time
(from its start to the end of its last request), host clock."""


def read(w):
    return w["rate"]
