"""k1_roofline.embed_b32: K1's launches in the traced slice times one call's
bound from shapes, over the device time of K1's kernel group, in %."""

from portbench.yardstick.readers import roofline


def read(run):
    return roofline(run, "K1")
