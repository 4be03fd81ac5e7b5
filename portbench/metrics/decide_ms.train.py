"""Host ms of one controller decision in the window (the control plane's
publish: the stats snapshot decided inline on the training thread)."""
NAME, UNIT, LAYER, SOURCE, MOVES = ("decide_ms.train", "ms", "controller",
                                    "program_span", "train_step_ms_p90")


def read(ctx):
    ds = [dt for t0, dt in ctx["decides"] if t0 >= ctx["win_t0"]]
    if not ds:
        return None
    return 1e3 * sum(ds) / len(ds)
