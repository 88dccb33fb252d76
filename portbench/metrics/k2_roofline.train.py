"""k2_roofline.train: K2's launches in the traced slice times one call's
bound from shapes, over the device time of K2's kernel group, in %."""

from portbench.yardstick.readers import roofline


def read(run):
    return roofline(run, "K2")
