"""The whole step's share of the card's peak over the traced steps: the
FLOPs the steps need (as ``train_mfu`` counts them) over the traced
window's length.  It bounds every kernel's share that moves
``train_mfu``."""
from _common import traced_steps

NAME, UNIT, LAYER, SOURCE, MOVES = ("step_mfu.train", "%", "device",
                                    "device_trace", "train_mfu")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    from reference.formulas import PEAK_FLOPS
    fl = sum(ctx["step_flops"](k) for k in traced_steps(ctx))
    return 100.0 * fl / tr["window_s"] / PEAK_FLOPS[ctx["dtype"]]
