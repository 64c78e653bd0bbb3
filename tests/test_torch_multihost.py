"""The port's two-process failover harness (``tests/_torch_two_proc.py``):
a coordinator process killed mid-run, the survivor winning the lease over
a shared ``TCPStore``, bootstrapping from the topic log without
re-firing a mitigation, re-planning onto the exact survivor pool and
re-carving.  Two interpreters on the wall clock (about 15 s), bounded by
the subprocess's own timeout."""
import os
import subprocess
import sys

HARNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_two_proc.py")


def test_two_process_failover_harness():
    r = subprocess.run([sys.executable, HARNESS], capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-2000:]}"
    assert "HARNESS OK" in r.stdout
    assert "two-process harness: OK" in r.stdout
