"""One process on one card: the run measures in this process."""


def launch(measure, cell, seed, seconds, trace, start):
    return measure(cell, seed, seconds, trace, start, device="cuda")
