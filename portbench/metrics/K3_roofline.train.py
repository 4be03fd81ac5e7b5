"""K3's share of its roofline: the least time its live work needs (the
frozen formula over the live FFN blocks, TF32's peak for fp32) over the
device time of its launches in the traced steps."""
from _common import k3_least_s, kernel_seconds

NAME, UNIT, LAYER, SOURCE, MOVES = ("K3_roofline.train", "%", "kernels",
                                    "device_trace", "train_mfu")


def read(ctx):
    if ctx["trace"] is None or ctx["masks"] is None:
        return None
    t = kernel_seconds(ctx, ("K3",))
    if t <= 0:
        return None
    return 100.0 * k3_least_s(ctx) / t
