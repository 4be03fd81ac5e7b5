"""The share of the traced window in which no kernel, copy or fill ran
on the card."""
NAME, UNIT, LAYER, SOURCE, MOVES = ("device_idle_share.train", "%",
                                    "device", "device_trace",
                                    "train_tokens_per_s")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
