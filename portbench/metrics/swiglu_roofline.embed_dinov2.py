"""swiglu_roofline.embed_dinov2: `swiglu_bf16`'s launches in the DINOv2
sweep's traced slice times one call's bytes bound (its (rows, 2I) input
and (rows, I) output over 3.35 TB/s), over the device time of its kernel
group, in %."""

from portbench.yardstick.dinov2 import roofline


def read(run):
    return roofline(run, "swiglu")
