"""K1, K2a and K2b together: the least time of causal attention's
forward and backward over the exact causal pairs, over the device time
of their launches in the traced steps."""
from _common import attn_least_s, kernel_seconds

NAME, UNIT, LAYER, SOURCE, MOVES = ("attn_roofline.train", "%", "kernels",
                                    "device_trace", "train_mfu")


def read(ctx):
    if ctx["trace"] is None:
        return None
    t = kernel_seconds(ctx, ("K1", "K2a", "K2b"))
    if t <= 0:
        return None
    return 100.0 * attn_least_s(ctx) / t
