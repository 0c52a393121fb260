"""sample_request_p95_s: the 95th percentile (linear between order
statistics) of the latency of every request in the window, host clock."""


def read(w):
    return w["p95_s"]
