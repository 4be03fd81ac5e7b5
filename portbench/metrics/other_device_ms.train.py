"""Device ms a step in kernels other than the port's K1-K6 (by the
harness's frozen list of their names): the eager PyTorch of the models,
autograd and AdamW."""
from devtrace import kernel_id

NAME, UNIT, LAYER, SOURCE, MOVES = ("other_device_ms.train", "ms",
                                    "models, autograd and optimizer",
                                    "device_trace", "train_tokens_per_s")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    s = sum(v[1] for n, v in tr["kernels"].items()
            if v[2] == "kernel" and kernel_id(n) is None)
    return 1e3 * s / tr["steps"]
