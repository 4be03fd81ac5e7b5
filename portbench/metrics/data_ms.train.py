"""Host ms a traced step waits for data: the program's ``train.data`` (the
loader's next batch) and ``step.batch`` (the batch to the device) spans."""
import program_spans

NAME, UNIT, LAYER, SOURCE, MOVES = ("data_ms.train", "ms", "session loop",
                                    "program_span", "train_tokens_per_s")


def read(ctx):
    return program_spans.host_ms(program_spans.read(),
                                 ("train.data", "step.batch"))
