"""Applied reconfiguration over four gloo ranks against the reference's on
four forced host devices (``tests/_torch_live_ranks.py``).

Phantoms 2 and 3 fall silent, the co-hosted loop on rank 0 re-plans the
pool to [0, 1], and at the next epoch boundary every rank re-carves the
(4, 1) mesh: ranks 0 and 1 go on on the (2, 1) mesh with the gathered
state, ranks 2 and 3 take part in the gather and leave.  Rank 0's losses
agree with the reference's to 1e-5 relative and its mitigation events
are equal (``dt``/``err`` masked), with one re-carve on both sides.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_live_ranks as helper

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("live4"))
    helper.write_ckpt(out)
    script = os.path.join(HERE, "_torch_live_ranks.py")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, script, "reference", out], env={
                 **env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                 "JAX_PLATFORMS": "cpu"}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                 text=True),
             subprocess.Popen([sys.executable, script, "ranks", out], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    errors = {f: open(os.path.join(out, f)).read() for f in sorted(os.listdir(out))
              if f.startswith("error-")}
    assert all(p.returncode == 0 for p in procs) and not errors, (logs, errors)

    def load(name):
        with open(os.path.join(out, name)) as f:
            return json.load(f)

    return load("reference.json"), [load(f"rank-{r}.json") for r in range(4)]


def test_rank0_equals_the_reference(runs):
    ref, ranks = runs
    got = ranks[0]
    assert ref["remeshes"] == got["remeshes"] == 1
    assert got["events"] == ref["events"]
    assert got["healthy"] == ref["healthy"] == [0, 1]
    assert got["steps_done"] == ref["steps_done"] == helper.STEPS
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    applied = [e for e in got["events"] if e["kind"] == "reconfig_applied"]
    assert [(e["mesh_devices"], e["gpus"]) for e in applied] == [(2, 2)]


def test_ranks_agree_on_the_boundary_and_two_leave(runs):
    _, ranks = runs
    # every rank breaks at the same step: the losses up to the re-carve are
    # the same global losses on all four
    cut = next(e["step"] for e in ranks[0]["events"] if e["kind"] == "reconfig_applied")
    for r in ranks:
        assert r["remeshes"] == 1 and r["losses"][:cut] == ranks[0]["losses"][:cut]
    assert [r["left_mesh"] for r in ranks] == [False, False, True, True]
    assert ranks[1]["losses"] == ranks[0]["losses"]
    assert [r["steps_done"] for r in ranks] == [helper.STEPS, helper.STEPS, cut, cut]
    # the control plane is rank 0's: the others log only the re-carve
    for r in ranks[1:]:
        assert [e["kind"] for e in r["events"]] == ["reconfig_applied"]
