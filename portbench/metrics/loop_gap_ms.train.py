"""Host time a step of the window spends outside the program's step call
(forward, backward and AdamW, ended by a device sync in the traced run):
the loop's controller, events, prune, data and hooks."""
NAME, UNIT, LAYER, SOURCE, MOVES = ("loop_gap_ms.train", "ms",
                                    "session loop", "program_span",
                                    "train_tokens_per_s")


def read(ctx):
    steps = ctx["steps"]
    if not steps:
        return None
    inside = sum(ctx["spans"][k][1] - ctx["spans"][k][0] for k in steps)
    return 1e3 * (sum(ctx["times"]) - inside) / len(steps)
