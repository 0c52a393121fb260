"""device.idle_share.sample: `benchmark.readers.idle_share`."""
from benchmark.readers import idle_share as read  # noqa: F401
