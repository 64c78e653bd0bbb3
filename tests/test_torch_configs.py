"""The port's configs are field-equal to the reference's, reduced forms too."""
import dataclasses

import pytest

import repro.configs as ref_configs
import repro_torch.configs as port_configs
from repro.configs import vgg16 as ref_vgg16
from repro_torch.configs import vgg16 as port_vgg16

NAMES = ref_configs.list_configs()


def test_same_registry():
    assert port_configs.list_configs() == NAMES
    assert port_configs.ASSIGNED_ARCHS == ref_configs.ASSIGNED_ARCHS


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_config_field_equal(name, reduced):
    ref = ref_configs.get_config(name)
    port = port_configs.get_config(name)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.padded_vocab == ref.padded_vocab
    assert port.n_params() == ref.n_params()
    assert [s.name for s in port_configs.shapes_for(port)] == [
        s.name for s in ref_configs.shapes_for(ref)]


def test_shapes_and_vgg_equal():
    assert {k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert dataclasses.asdict(port_vgg16.CONFIG) == dataclasses.asdict(ref_vgg16.CONFIG)


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get_config("no-such-arch")
