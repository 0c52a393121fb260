"""device.idle_share.prior_train: `benchmark.readers.idle_share`."""
from benchmark.readers import idle_share as read  # noqa: F401
