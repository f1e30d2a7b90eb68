"""The rollout phase's host ms an iteration, the card drained at each end,
over the traced run's unprofiled iterations."""


def read(ctx):
    return ctx["phase_ms"].get("rollout")
