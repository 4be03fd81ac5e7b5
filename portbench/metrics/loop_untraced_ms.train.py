"""Host ms a traced step that none of the program's spans covers but the
root ``train``: how much of the loop the spans leave unexplained."""
import program_spans

NAME, UNIT, LAYER, SOURCE, MOVES = ("loop_untraced_ms.train", "ms",
                                    "session loop", "program_span",
                                    "train_tokens_per_s")


def read(ctx):
    return program_spans.untraced_ms(program_spans.read())
