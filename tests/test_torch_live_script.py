"""The port's live loop against the reference's, on the CPU, continued
from ``tests/test_torch_live_loop.py`` (its helpers, fixtures and
tolerances): the fail-stop path with a coordinator, phase 12a's two
scripts (``chip_smoke.live_script``) and the train CLI with the control
plane wired.

Phase 12a's scripts run without a checkpoint, as on the card: their events
must equal the reference's and its counts, ``chip_smoke.LIVE_EVENTS``,
which the card is held to.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

from test_torch_live_loop import (  # noqa: F401  (fixtures)
    PORT_CFG,
    REF,
    REF_CFG,
    STEPS,
    ckpt0,
    three_ways,
    world_of_one,
)
from test_torch_transport import FakeKVClient, tcp_store

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (phase 12a's script and constants)


@pytest.mark.parametrize("run", list(chip_smoke.LIVE_RUNS))  # the lease first
def test_chip_live_script_events_equal_reference(world_of_one, run):
    """Phase 12a's script: the reference's ``KVStoreTransport`` ends over
    the dict client, the port's over a ``TCPStore``; no checkpoint, as on
    the card (so the weights differ and only the events are held)."""
    def scenario(m):
        client = FakeKVClient() if m is REF else tcp_store()
        tc, injector, coord_end = chip_smoke.live_script(m, REF_CFG if m is REF else PORT_CFG,
                                                         client, run)
        tc = dataclasses.replace(tc, straggler_factor=1e6)

        def after():
            lw = coord_end.low_water("hb")
            return lw, len(coord_end.poll("hb", lw)), sorted(tc.coordinator.healthy)

        return tc, injector, after

    rep, (lw, backlog, healthy) = three_ways(scenario, world_of_one, n_losses=0)
    assert chip_smoke.live_counts(rep) == chip_smoke.LIVE_EVENTS[run]
    assert rep.remeshes == 0 and lw > 0 and backlog <= 4
    assert healthy == ([0] if run == "lease" else [1, 2, 3])


def test_fail_stop_reports_the_worker_to_its_coordinator(ckpt0, world_of_one):
    """A step failure with a wired coordinator and no control loop: one
    ``failure``, one ``replan`` onto the 7 others, the restart from the
    step-0 checkpoint.  The losses are held up to the fault: after it the
    reference's pipeline, moved back to step 0, still serves the batches
    its producer had queued (steps 3, 4, ...), where the port's restarts
    its producer at the restored step (ROADMAP Queue 3)."""
    def scenario(m):
        coord = m.coordinator.ClusterCoordinator(8, m.A100, virtual_devices=True,
                                                 clock=lambda: 0.0)
        coord.submit_foreground(m.coordinator.Job("fg", "foreground", m.graph, amp_limit=1.5))
        fired = []

        def injector(step):
            if step == 3 and not fired:
                fired.append(step)
                raise RuntimeError("injected fault")

        tc = m.loop.TrainConfig(steps=STEPS, coordinator=coord, ckpt_dir=ckpt0,
                                straggler_factor=1e6)
        return tc, injector, lambda: (sorted(coord.healthy), coord.foreground().plan.num_gpus)

    rep, (healthy, gpus) = three_ways(scenario, world_of_one, n_losses=3)
    assert rep.mitigations.count("failure") == rep.mitigations.count("replan") == 1
    assert rep.restarts == 2 and rep.steps_done == 3 + STEPS
    assert healthy == [1, 2, 3, 4, 5, 6, 7] and gpus == 7


def test_train_cli_wires_the_control_plane(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-1.5b",
         "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
         "--hb-timeout", "30", "--admit-every", "2"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "done on cpu: steps=3" in out.stdout
    assert "control plane: worker 0 last beat at step 3, 256 of 256 devices healthy" in out.stdout
