"""scale_add_ln_roofline.embed_dinov2: `scale_add_layer_norm_bf16`'s
launches in the DINOv2 sweep's traced slice times one call's bytes bound
(x, a, the sum and LN(sum), and the f32 parameters, over 3.35 TB/s),
over the device time of its kernel group, in %."""

from portbench.yardstick.dinov2 import roofline


def read(run):
    return roofline(run, "scale_add_ln")
