"""toy_mlp_roofline: the MLP's matrix products (the family's counter
`mlp_least_s`) over the device time of its kernel group."""
from benchmark.readers import roofline


def read(w):
    return roofline(w, "mlp_least_s", ("toy mlp",))
