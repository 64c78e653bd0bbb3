"""Process start to the window's start: imports, the kernels' load from the
build cache (their build on a checkout's first run), weights made on the
device, and the checked steps that warm every shape the window uses."""


def read(run):
    return run.setup_s
