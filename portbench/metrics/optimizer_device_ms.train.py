"""Device ms a traced step in the optimizer: the program's
``step.optimizer`` span (the clip and AdamW), timed by CUDA events at
its boundaries."""
import program_spans

NAME, UNIT, LAYER, SOURCE, MOVES = ("optimizer_device_ms.train", "ms",
                                    "models, autograd and optimizer",
                                    "program_span", "train_tokens_per_s")


def read(ctx):
    return program_spans.device_ms(program_spans.read(), "step.optimizer")
