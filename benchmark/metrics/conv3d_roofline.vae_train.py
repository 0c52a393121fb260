"""conv3d_roofline.vae_train: `benchmark.readers.conv_roofline`."""
from benchmark.readers import conv_roofline as read  # noqa: F401
