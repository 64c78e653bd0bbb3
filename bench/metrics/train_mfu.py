"""Model FLOPs of the window's steps (three times the forward's, from
``flops/<config>.py``) over the window's seconds times the card's bf16
dense peak (``peaks.json``), in percent."""
from bench.counts import peak_flops


def read(run):
    return 100.0 * len(run.step_s) * run.model_flops_per_step / (run.window_s * peak_flops())
