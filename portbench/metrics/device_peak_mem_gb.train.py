"""The most memory the program held on the card during the window
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""
NAME, UNIT, LAYER, SOURCE, MOVES = ("device_peak_mem_gb.train", "GB",
                                    "device", "program_counter",
                                    "train_tokens_per_s")


def read(ctx):
    if not ctx["window_peak"]:
        return None
    return ctx["window_peak"] / 1e9
