"""Device ms a traced step in the forward: the program's ``step.forward``
span (the loss over the pipeline's ticks), timed by CUDA events at its
boundaries."""
import program_spans

NAME, UNIT, LAYER, SOURCE, MOVES = ("forward_device_ms.train", "ms",
                                    "engine and pipeline ticks",
                                    "program_span", "train_tokens_per_s")


def read(ctx):
    return program_spans.device_ms(program_spans.read(), "step.forward")
