"""attention_roofline.dit_train: the softmax attention's least time a step
(the family's counter `attention_least_s`: forward and backward, per call
and pass the larger of FLOPs / 67 TFLOP/s and bytes / 3.35 TB/s) over the
device time of the attention kernels (`GROUPS` of families/dit3d.py)."""
from benchmark.readers import roofline


def read(w):
    return roofline(w, "attention_least_s", ("attention",))
