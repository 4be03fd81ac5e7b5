"""CUDA kernels launched a step, counted in the traced steps."""
NAME, UNIT, LAYER, SOURCE, MOVES = ("launches_per_step.train", "kernels",
                                    "engine and pipeline ticks",
                                    "device_trace", "train_tokens_per_s")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    n = sum(v[0] for v in tr["kernels"].values() if v[2] == "kernel")
    return n / tr["steps"] if n else None
