"""The port's sharding rules and mesh arithmetic against the reference's.

``dist/sharding.py`` is pure arithmetic over a mesh's axis names and
shape, so both packages run on abstract meshes (the reference's
``FakeMesh`` of ``tests/test_sharding.py``; the port's ``AbstractMesh``)
and must agree exactly: the rules, every parameter's and input's spec
(the reference's ``PartitionSpec`` as a tuple) and the divisibility
guard's drops, for every config, every shape kind and the meshes (1, 1),
(4, 2), (8, 1), (2, 2, 1), (16, 16) and (2, 16, 16).  The cases of
``tests/test_sharding.py`` are mirrored, its property test included; so
is the mesh arithmetic of ``launch/mesh.py``.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # tier-1 must collect without hypothesis
    from _prop import given, settings, strategies as st

from repro.configs import DECODE_32K as REF_DECODE_32K
from repro.configs import LONG_500K as REF_LONG_500K
from repro.configs import PREFILL_32K as REF_PREFILL_32K
from repro.configs import TRAIN_4K as REF_TRAIN_4K
from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref_sh
from repro.launch import mesh as ref_mesh
from repro.models import get_model as ref_get_model
from repro.models.api import input_specs as ref_input_specs
from repro_torch.configs import DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K, get_config
from repro_torch.dist import sharding
from repro_torch.launch import mesh
from repro_torch.models.api import get_model, input_specs
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.train.state import state_pspecs


class FakeMesh:
    """The reference's mesh stand-in (axis names + sizes)."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.zeros(tuple(shape))


MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "8x1": ((8, 1), ("data", "model")),
    "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
ARCHS = ["llama3-8b", "qwen2-1.5b", "qwen2-72b", "minicpm-2b", "pixtral-12b",
         "qwen3-moe-30b-a3b", "grok-1-314b", "rwkv6-1.6b", "zamba2-2.7b",
         "seamless-m4t-large-v2"]
SHAPES = {"train": (REF_TRAIN_4K, TRAIN_4K), "prefill": (REF_PREFILL_32K, PREFILL_32K),
          "decode": (REF_DECODE_32K, DECODE_32K), "long": (REF_LONG_500K, LONG_500K),
          "none": (None, None)}


def _meshes(name):
    shape, names = MESHES[name]
    return FakeMesh(shape, names), mesh.AbstractMesh(shape, names)


def _spec(p):
    """A reference PartitionSpec as the port's plain tuple."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _ref_specs(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    from repro.checkpoint.ckpt import _key_str

    return {"/".join(_key_str(k) for k in kp): _spec(v) for kp, v in leaves}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_specs_equal_reference(arch, shape_name, mesh_name):
    """Rules, the train state's specs (params and both optimizers'
    moments), the step inputs' specs and every drop of the divisibility
    guard, in order."""
    fake, abstract = _meshes(mesh_name)
    ref_shape, shape = SHAPES[shape_name]
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    rules = sharding.sharding_rules(cfg, abstract, shape)
    want = ref_sh.sharding_rules(rcfg, fake, ref_shape)
    assert rules == want

    from repro.optim.optimizer import make_optimizer as ref_make_optimizer
    from repro.train.state import state_pspecs as ref_state_pspecs

    rrep, prep = ref_sh.RuleReport(), sharding.RuleReport()
    want_specs = _ref_specs(ref_state_pspecs(ref_get_model(rcfg), ref_make_optimizer(rcfg),
                                             want, fake, rrep))
    got_specs = _flat(state_pspecs(get_model(cfg), make_optimizer(cfg), rules, abstract, prep))
    assert got_specs == want_specs
    if ref_shape is not None:
        want_b = _ref_specs(ref_sh.batch_pspecs(rcfg, ref_shape, want, fake,
                                                ref_input_specs(rcfg, ref_shape), rrep))
        got_b = _flat(sharding.batch_pspecs(cfg, shape, rules, abstract,
                                            input_specs(cfg, shape), prep))
        assert got_b == want_b
    assert prep.dropped == rrep.dropped


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_placements_follow_the_specs(mesh_name):
    """Each spec's DTensor placements: Shard(d) on every mesh axis of size
    > 1 that splits dim d, outermost first for ("pod", "data"), else
    Replicate (an axis of size 1 splits nothing)."""
    from torch.distributed.tensor import Replicate, Shard

    _, abstract = _meshes(mesh_name)
    names = abstract.axis_names
    sizes = dict(zip(names, abstract.shape))
    for spec in [(), ("data",), (None, "model"), (("pod", "data"),), (None, ("data",), "model")]:
        axes = [a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)]
        if any(a not in names for a in axes):
            continue
        got = sharding.placements(spec, abstract)
        want = [Replicate()] * len(names)
        for d, e in enumerate(spec):
            for a in (() if e is None else (e,) if isinstance(e, str) else e):
                if sizes[a] > 1:
                    want[names.index(a)] = Shard(d)
        assert list(got) == want
    if "pod" in names:
        with pytest.raises(ValueError, match="axis order"):
            sharding.placements((("data", "pod"),), abstract)


# -- the cases of tests/test_sharding.py ---------------------------------------

M_REF, M = FakeMesh((16, 16), ("data", "model")), mesh.AbstractMesh((16, 16),
                                                                     ("data", "model"))
MP_REF, MP = (FakeMesh((2, 16, 16), ("pod", "data", "model")),
              mesh.AbstractMesh((2, 16, 16), ("pod", "data", "model")))

PSPEC_CASES = {
    "divisibility_guard_drops": (("embed", "heads", "head_dim"), (2304, 36, 64),
                                 {"embed": ("data",), "heads": ("model",), "head_dim": ()}),
    "divisible_keeps": (("embed", "heads", "head_dim"), (8192, 64, 128),
                        {"embed": ("data",), "heads": ("model",), "head_dim": ()}),
    "no_axis_reuse": (("mlp", "mlp"), (256, 256), {"mlp": ("model",)}),
}


@pytest.mark.parametrize("case", sorted(PSPEC_CASES))
def test_pspec_cases(case):
    dims, shape, rules = PSPEC_CASES[case]
    rrep, prep = ref_sh.RuleReport(), sharding.RuleReport()
    want = _spec(ref_sh.pspec(dims, shape, rules, M_REF, rrep))
    assert sharding.pspec(dims, shape, rules, M, prep) == want
    assert prep.dropped == rrep.dropped
    assert {"divisibility_guard_drops": ("data",), "divisible_keeps": ("data", "model"),
            "no_axis_reuse": ("model",)}[case] == want


def test_rules_minicpm_attention_replicated():
    rules = sharding.sharding_rules(get_config("minicpm-2b"), M, TRAIN_4K)
    assert rules["heads"] == () and rules["kv_heads"] == ()
    assert rules["mlp"] == ("model",)


def test_rules_moe_modes():
    r = sharding.sharding_rules(get_config("qwen3-moe-30b-a3b"), M, TRAIN_4K)
    assert r["expert"] == ("model",) and r["moe_mlp"] == ()
    r = sharding.sharding_rules(get_config("grok-1-314b"), M, TRAIN_4K)
    assert r["expert"] == () and r["moe_mlp"] == ("model",)


def test_rules_decode_kv_fallbacks():
    r = sharding.sharding_rules(get_config("qwen2-72b"), M, DECODE_32K)
    assert r["act_kv_seq"] == ("model",)
    r = sharding.sharding_rules(get_config("zamba2-2.7b"), MP, LONG_500K)
    assert r["act_kv_seq"] == ("pod", "data") and r["act_batch"] == ()


def test_rules_serving_drops_fsdp_for_small_models():
    """The budget reads ``cfg.dtype``'s itemsize (bf16: 2 bytes)."""
    assert sharding.sharding_rules(get_config("qwen2-1.5b"), M, DECODE_32K)["embed"] == ()
    assert sharding.sharding_rules(get_config("grok-1-314b"), M, DECODE_32K)["embed"] == (
        "data",)
    # 20 B params on a 16-way model axis: 2.5 GB a device in bf16 keeps
    # FSDP; the same weights in fp32 (the master's itemsize) would count 5 GB
    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=80)
    rcfg = dataclasses.replace(ref_get_config("llama3-8b"), num_layers=80)
    assert sharding.sharding_rules(cfg, M, DECODE_32K) == ref_sh.sharding_rules(
        rcfg, M_REF, REF_DECODE_32K)
    for layers in (8, 16, 40, 64):
        c = dataclasses.replace(cfg, num_layers=layers)
        bf16 = c.n_params() * 2 / 16 > sharding.SERVE_FSDP_BYTES
        assert sharding.sharding_rules(c, M, DECODE_32K)["embed"] == (
            ("data",) if bf16 else ()), layers


@settings(max_examples=60, deadline=None)
@given(
    st.lists(st.integers(1, 4096), min_size=1, max_size=4),
    st.sampled_from(["embed", "heads", "mlp", "vocab", "norm"]),
)
def test_property_pspec_always_valid(dims, axis):
    """The guard guarantees every sharded dim divisible by its axes, and
    the port's spec is the reference's."""
    rules = {"embed": ("data",), "heads": ("model",), "mlp": ("model",),
             "vocab": ("model",), "norm": ()}
    axes = tuple(axis for _ in dims)
    spec = sharding.pspec(axes, tuple(dims), rules, M)
    assert spec == _spec(ref_sh.pspec(axes, tuple(dims), rules, M_REF))
    sizes = {"data": 16, "model": 16}
    for dim, s in zip(dims, spec + (None,) * (len(dims) - len(spec))):
        if s is None:
            continue
        parts = s if isinstance(s, tuple) else (s,)
        assert dim % int(np.prod([sizes[a] for a in parts])) == 0


# -- launch/mesh.py arithmetic -------------------------------------------------


@pytest.mark.parametrize("lo", range(1, 601, 100))
def test_pow2_mesh_shape_equals_reference(lo):
    for n in range(lo, lo + 100):
        assert mesh.pow2_mesh_shape(n) == ref_mesh.pow2_mesh_shape(n), n
    with pytest.raises(ValueError, match="at least one device"):
        mesh.pow2_mesh_shape(0)


def test_production_meshes_are_abstract_without_their_ranks():
    m = mesh.make_production_mesh()
    assert (m.shape, m.axis_names, m.devices.shape) == ((16, 16), ("data", "model"), (16, 16))
    mp = mesh.make_production_mesh(multi_pod=True)
    assert mesh.mesh_axis_sizes(mp) == {"pod": 2, "data": 16, "model": 16}


SERVING = [(n, p, pm, dm) for n in range(2, 11) for p in range(1, n)
           for pm in (1, 2) for dm in (1, 2, 4)]


@pytest.mark.parametrize("n", range(2, 11))
def test_split_mesh_for_serving_equals_reference(n):
    """Ranges, slice shapes and refusals over n positions, every prefill
    width and model widths (the reference on its one CPU device listed n
    times, the port on n CPU positions)."""
    devs = jax.devices()[:1] * n
    cpus = [torch.device("cpu")] * n
    for _, p, pm, dm in [c for c in SERVING if c[0] == n]:
        try:
            want = ref_mesh.split_mesh_for_serving(p, devices=devs, prefill_model=pm,
                                                   decode_model=dm)
            want = (want.prefill_range, want.decode_range, want.prefill_mesh.devices.shape,
                    want.decode_mesh.devices.shape, want.disjoint())
        except ValueError as e:
            want = str(e)
        try:
            got = mesh.split_mesh_for_serving(p, devices=cpus, prefill_model=pm,
                                              decode_model=dm)
            assert not got.device_sets_disjoint()  # one CPU
            got = (got.prefill_range, got.decode_range, got.prefill_mesh.shape,
                   got.decode_mesh.shape, got.disjoint())
        except ValueError as e:
            got = str(e)
        assert got == want, (n, p, pm, dm)


def test_serving_slices_on_two_cards_are_disjoint():
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    sm = mesh.split_mesh_for_serving(1, devices=cards)
    assert sm.prefill_range == (0, 1) and sm.decode_range == (1, 2)
    assert sm.disjoint() and sm.device_sets_disjoint()


def test_meshes_over_a_process_group(tmp_path):
    """With a one-rank gloo group: ``make_mesh``, ``largest_pow2_mesh``
    and ``remesh_for_pool`` build DeviceMeshes whose rules equal the
    abstract mesh's; without a group they refuse."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_mesh(1, 1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp_path, 'pg')}",
                            rank=0, world_size=1)
    try:
        m = mesh.make_mesh(1, 1)
        assert m.mesh_dim_names == ("data", "model") and m.size() == 1
        assert mesh.largest_pow2_mesh(1).size() == 1
        assert tuple(mesh.remesh_for_pool([0, 5]).shape) == (1, 1)
        with pytest.raises(ValueError, match="no local devices"):
            mesh.remesh_for_pool([3])
        with pytest.raises(ValueError, match="needs 2 ranks"):
            mesh.make_mesh(2, 1)
        cfg = get_config("llama3-8b")
        assert sharding.sharding_rules(cfg, m, TRAIN_4K) == sharding.sharding_rules(
            cfg, mesh.AbstractMesh((1, 1), ("data", "model")), TRAIN_4K)
        sl = mesh.rank_slice(0, 1)
        assert sl.device == torch.device("cpu") and sl.mesh.size() == 1
        assert mesh.make_production_mesh().devices.shape == (16, 16)  # abstract
    finally:
        dist.destroy_process_group()


def test_placing_never_moves_a_tensor_across_device_types(tmp_path):
    """``device_put`` onto a gloo (CPU) mesh places CPU tensors, and
    refuses a tensor on the card (a fake one: this box has none) rather
    than copy it to the CPU; ``train(mesh=)`` refuses a device that is not
    the mesh's before it builds anything."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.train.loop import TrainConfig, train

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp_path, 'pg')}",
                            rank=0, world_size=1)
    try:
        m = mesh.make_mesh(1, 1)
        sh = sharding.NamedSharding(m, ("data",))
        x = torch.arange(6.0).reshape(2, 3)
        placed = sharding.device_put({"w": x}, {"w": sh})["w"]
        assert placed.device.type == "cpu" and torch.equal(placed.full_tensor(), x)
        with FakeTensorMode():
            on_card = torch.empty(2, 3, device="cuda")
        with pytest.raises(ValueError, match="cannot be placed on a cpu mesh"):
            sharding.device_put({"w": on_card}, {"w": sh})
        cfg = get_config("qwen2-1.5b").reduced()
        shape = dataclasses.replace(TRAIN_4K, seq_len=8, global_batch=2, name="t")
        with pytest.raises(ValueError, match="not the mesh's device type"):
            train(cfg, shape, TrainConfig(steps=1), device="meta", mesh=m)
    finally:
        dist.destroy_process_group()


LAYOUT_CASES = {  # case -> (arch, shape, rules override, mesh,
    #                  {logical axis: a mesh axis that must split it})
    "pixtral-frontend": ("pixtral-12b", TRAIN_4K, {}, (2, 2),
                         {"embed_out": "model", "heads": "model"}),
    "kv-split-heads-whole": ("minicpm-2b", TRAIN_4K, {"heads": (), "kv_heads": ("model",)},
                             (2, 2), {"kv_heads": "model"}),
    "dense-tp-runs": ("llama3-8b", TRAIN_4K, {}, (2, 2), {"heads": "model", "mlp": "model"}),
    "moe-family": ("qwen3-moe-30b-a3b", TRAIN_4K, {}, (2, 2), {"expert": "model"}),
    "moe-tensor-experts": ("grok-1-314b", TRAIN_4K, {}, (2, 2), {"moe_mlp": "model"}),
    "rwkv-family": ("rwkv6-1.6b", TRAIN_4K, {}, (2, 2), {"heads": "model", "embed_out": "model"}),
    "mamba2-family": ("zamba2-2.7b", TRAIN_4K, {}, (2, 2),
                      {"ssm_inner": "model", "heads": "model"}),
    "mamba2-partial-heads": ("zamba2-2.7b", TRAIN_4K, {"heads": (), "kv_heads": ()}, (2, 2),
                             {"ssm_inner": "model"}),
    "encdec-family": ("seamless-m4t-large-v2", TRAIN_4K, {}, (2, 2),
                      {"heads": "model", "mlp": "model", "embed_out": "model"}),
    "unported-axis": ("llama3-8b", TRAIN_4K, {"norm": ("model",)}, (2, 2), {"norm": "model"}),
    "rwkv-state-batch-1": ("rwkv6-1.6b", LONG_500K, {}, (2, 1), {"act_kv_seq": "data"}),
    "zamba-kv-cache-batch-1": ("zamba2-2.7b", LONG_500K, {}, (2, 1), {"act_kv_seq": "data"}),
    "dense-kv-cache-on-model": ("llama3-8b", DECODE_32K, {}, (2, 2),
                                {"act_kv_seq": "model", "heads": "model"}),
    "kv-seq-kept-whole": ("llama3-8b", dataclasses.replace(DECODE_32K, seq_len=33), {},
                          (2, 2), {"act_kv_seq": "model"}),
}


# the cases item 11b once refused: each runs a step; the others build theirs
ONCE_REFUSED = {"kv-split-heads-whole", "mamba2-partial-heads", "unported-axis",
                "kv-seq-kept-whole"}


def _live_splits(schema, rules, m) -> dict:
    """{logical axis: the mesh axes of size > 1 that split it in some leaf
    of ``schema``} under ``pspec``."""
    sizes = sharding.mesh_axis_sizes(m)
    out: dict = {}
    for s in jax.tree_util.tree_leaves(schema, is_leaf=lambda x: hasattr(x, "axes")):
        for name, e in zip(s.axes, sharding.pspec(s.axes, s.shape, rules, m)):
            live = {a for a in ((e,) if isinstance(e, str) else e or ()) if sizes[a] > 1}
            if live:
                out.setdefault(name, set()).update(live)
    return out


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_unported_layouts_are_refused_once_per_step(case):
    """No layout is refused any more (ROADMAP item 11b is done): each case
    of reduced configs on a (2, 2) or (2, 1) mesh builds its step as rank
    0 of a fake world of the mesh's size, and those item 11b once refused
    (``ONCE_REFUSED``) run it once on meta tensors (the dry-run's
    ``run_step``).  The rules do split what the case names
    over 'model' or 'data': pixtral's ``frontend_proj`` on ``embed_out``,
    qwen3-moe's experts, grok-1's ``moe_d_ff``, rwkv6's heads and ``cw_r``'s
    ``embed_out``, Mamba-2's ``ssm_inner``, llama3-8b's and seamless's
    heads and MLP; the layouts once refused run too: KV heads split while
    the query heads stay whole (minicpm-2b reduced has 4 KV heads), Mamba-2's
    ``d_inner`` split while its heads stay whole, a parameter split along
    ``norm``, and a decode cache whose length (33) the divisibility guard
    keeps whole where the rules put ``act_kv_seq`` on 'model'.  A decode
    cell with a batch of 1 on a data axis of 2 puts ``act_kv_seq`` on
    'data' (rwkv6's O(1) state has no such axis; zamba2's shared-attention
    ``k``/``v`` decode split-KV).  What each computes is held against the
    reference in ``tests/test_torch_distributed.py``."""
    import math

    from repro_torch.launch.dryrun import run_step
    from repro_torch.train.step import jit_decode_step, jit_train_step

    arch, shape, override, mesh_shape, live = LAYOUT_CASES[case]
    m = mesh.AbstractMesh(mesh_shape, ("data", "model"))
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    rules = dict(sharding.sharding_rules(cfg, m, shape), **override)
    split, sizes = _live_splits(api.schema, rules, m), sharding.mesh_axis_sizes(m)
    for axis, mesh_axis in live.items():
        if axis.startswith("act_"):  # an activation's axis: the rules place it
            assert mesh_axis in rules[axis] and sizes[mesh_axis] > 1, (axis, rules[axis])
        else:
            assert mesh_axis in split.get(axis, ()), (axis, split)
    with mesh.fake_world(math.prod(mesh_shape), "meta"):
        m = mesh.make_mesh(*mesh_shape)
        if case in ONCE_REFUSED:
            assert run_step(cfg, shape, m, "meta", rules=rules)["flops"] > 0
        elif shape.kind == "train":
            jit_train_step(api, make_optimizer(cfg), m, shape, rules=rules)
        else:
            jit_decode_step(api, m, shape, rules=rules)


def test_no_layout_is_refused_as_unported():
    """The port refuses no layout as unported: no source file of
    ``src/repro_torch`` names ROADMAP item 11b, the refusal's message."""
    root = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")
    hits = [os.path.join(d, f) for d, _, files in os.walk(root) for f in files
            if f.endswith(".py") and "item 11b" in open(os.path.join(d, f)).read()]
    assert hits == []


def test_vgg_inputs_take_no_sequence_axis():
    """VGG-16 has no sequence: its batch (``images`` (B, H, W, 3),
    ``labels`` (B,)) takes no 'model' axis under rules that put
    ``act_seq`` on it (the images have no logical axes, the labels only the
    batch's), and ``models/vgg.py`` reads no sharding hook."""
    cfg = dataclasses.replace(get_config("llama3-8b"), sequence_parallel=True)
    m = mesh.AbstractMesh((4, 2), ("data", "model"))
    rules = sharding.sharding_rules(cfg, m, TRAIN_4K)
    assert rules["act_seq"] == ("model",)
    specs = {"images": torch.empty((32, 224, 224, 3), device="meta"),
             "labels": torch.empty((32,), dtype=torch.long, device="meta")}
    got = sharding.batch_pspecs(cfg, TRAIN_4K, rules, m, specs)
    assert got == {"images": (), "labels": ("data",)}
    src = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch", "models", "vgg.py")
    assert "fsdp" not in open(src).read()
