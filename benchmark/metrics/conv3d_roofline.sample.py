"""conv3d_roofline.sample: `benchmark.readers.conv_roofline`."""
from benchmark.readers import conv_roofline as read  # noqa: F401
