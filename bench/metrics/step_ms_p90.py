"""The 90th percentile of the window's step times (host clock from the
step's issue to its loss read), in milliseconds: the highest percentile
with some ten steps beyond it in a window of about a hundred."""
import statistics


def read(run):
    if len(run.step_s) < 10:
        return None
    return 1e3 * statistics.quantiles(run.step_s, n=10, method="inclusive")[-1]
