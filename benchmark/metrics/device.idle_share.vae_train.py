"""device.idle_share.vae_train: `benchmark.readers.idle_share`."""
from benchmark.readers import idle_share as read  # noqa: F401
