"""Tokens trained in the window over the window's seconds; the window ends
when the last step's loss has been read on the host."""


def read(run):
    return len(run.step_s) * run.cell.tokens_per_step / run.window_s
