"""The host's time in the ``step(state, batch)`` call, before the loss read:
the cost of issuing one step, mean over the traced steps, in milliseconds."""


def read(run):
    issue = run.trace.issue_s if run.trace else []
    return 1e3 * sum(issue) / len(issue) if issue else None
