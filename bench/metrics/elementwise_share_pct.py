"""Share of the traced device time in kernels that are neither GEMMs nor
the port's hand-written kernels (``kernel_classes.json``), in percent."""


def read(run):
    t = run.trace
    total = sum(t.by_class.values()) if t else 0.0
    return 100.0 * t.by_class.get("elementwise", 0.0) / total if total > 0 else None
