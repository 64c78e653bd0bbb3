"""``repro_torch.analysis.shardcheck`` against ``repro.analysis.shardcheck``:
the same reachable mesh shapes, the same codes for seeded bad specs, the same
``(check, where)`` pairs and statistics over a sweep, and the port's own
``shard-placement`` check."""
import pytest
from jax.sharding import PartitionSpec as P

import repro.analysis.shardcheck as ref
import repro_torch.analysis.shardcheck as port
from repro_torch.launch.mesh import AbstractMesh


def test_reachable_shapes_equal_the_reference():
    assert port.reachable_mesh_shapes(range(1, 65)) == ref.reachable_mesh_shapes(range(1, 65))


def test_abstract_mesh_prints_as_the_reference():
    assert repr(AbstractMesh((16, 4), ("data", "model"))) == repr(ref.AbstractMesh((16, 4)))
    assert repr(AbstractMesh((2, 16, 16), ("pod", "data", "model"))) == \
        repr(ref.AbstractMesh((2, 16, 16), ("pod", "data", "model")))


@pytest.mark.parametrize("spec,shape,codes", [
    (("replica",), (8,), {"shard-axis"}),
    (("data", "data"), (8, 8), {"shard-reuse"}),
    ((("data", "model"),), (12,), {"shard-divisibility"}),
    (("data", None, None), (8, 8), {"shard-rank"}),
    (("data", "model"), (8, 8), set()),
])
def test_seeded_bad_specs_raise_the_reference_codes(spec, shape, codes):
    sizes = {"data": 4, "model": 2}
    got = port.check_spec(spec, shape, sizes, "t")
    want = ref.check_spec(P(*spec), shape, sizes, "t")
    assert {v.check for v in got} == {v.check for v in want} == codes
    assert [(v.check, v.where) for v in got] == [(v.check, v.where) for v in want]


def test_shard_placement_flags_an_out_of_order_spec():
    """A dim split over ('data', 'pod') on a (pod, data, model) mesh: a valid
    ``PartitionSpec``, but DTensor splits outermost first, so
    ``dist.sharding.placements`` refuses it."""
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    sizes = {"pod": 2, "data": 2, "model": 2}
    bad = port.check_spec((("data", "pod"),), (8,), sizes, "t", mesh)
    assert [v.check for v in bad] == ["shard-placement"]
    assert ref.check_spec(P(("data", "pod")), (8,), sizes, "t") == []
    assert port.check_spec((("pod", "data"),), (8,), sizes, "t", mesh) == []


def test_check_cell_flags_unknown_logical_axis(monkeypatch):
    """A schema naming a logical axis the rules don't know silently
    replicates: ``shard-logical``, seeded through the model facade."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api as port_api
    from repro_torch.models.layers import ParamSpec

    cfg = get_config("llama3-8b").reduced()
    real = port_api.get_model(cfg)
    fake = dataclasses.replace(real, schema={**real.schema,
                                              "extra": ParamSpec((8,), ("typo_axis",))})
    monkeypatch.setattr(port_api, "get_model", lambda c: fake)
    vs, _ = port.check_cell(cfg, None, AbstractMesh((2, 2), ("data", "model")))
    assert [(v.check, v.where) for v in vs] == [
        ("shard-logical", "llama3-8b-smoke/train@data=2xmodel=2 params['extra']")]


@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_sweep_equals_the_reference(name):
    """Pools 1-16: the same (check, where) pairs (none) and the same cells,
    drops, mesh shapes and configs."""
    got, got_stats = port.sweep([name], pool_sizes=range(1, 17))
    want, want_stats = ref.sweep([name], pool_sizes=range(1, 17))
    assert [(v.check, v.where) for v in got] == [(v.check, v.where) for v in want] == []
    assert got_stats == want_stats
    assert got_stats["dropped"] > 0  # odd pools degrade, never violate


def test_cli_is_clean_over_every_config_and_pools_1_to_64(capsys):
    assert port.main([]) == 0
    err = capsys.readouterr().err
    assert "0 violation(s)" in err and "64 mesh shapes" in err
