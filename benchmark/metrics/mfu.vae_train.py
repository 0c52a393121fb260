"""mfu.vae_train: `benchmark.readers.mfu`."""
from benchmark.readers import mfu as read  # noqa: F401
