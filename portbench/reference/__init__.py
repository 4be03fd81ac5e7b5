"""The benchmark's yardstick: a plain PyTorch reference of each
configuration, frozen copies of the data generator, the schedules and the
FLOP and byte formulas, and the comparison that decides ``correct``.

Nothing here imports the program under test (``repro_torch``) or JAX; the
reference takes from the program only the outputs it judges."""
