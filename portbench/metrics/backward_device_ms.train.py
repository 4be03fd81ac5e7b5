"""Device ms a traced step in the backward: the program's ``step.backward``
span (autograd and the stacking of the per-slot gradients), timed by
CUDA events at its boundaries."""
import program_spans

NAME, UNIT, LAYER, SOURCE, MOVES = ("backward_device_ms.train", "ms",
                                    "engine and pipeline ticks",
                                    "program_span", "train_tokens_per_s")


def read(ctx):
    return program_spans.device_ms(program_spans.read(), "step.backward")
