"""``repro_torch.launch.dryrun``: a cell run once on fake tensors as rank 0
of a fake process group.  The state part of a train cell's argument bytes
per device equals what the reference's specs give the same leaves on the
reference's ``AbstractMesh``; a prefill cell's FLOPs equal the analytic
count; the layouts item 11b once refused record the FLOPs of their
twins; a layout no model computes on fails naming it; the CLI writes one
record with the reference's keys.  The fake tensors are
``meta`` here (this torch has no CUDA build), which the port sends down
the card's path."""
import dataclasses
import json
import math

import jax
import pytest
import torch

import repro.configs as ref_configs
import repro.dist.sharding as ref_sharding
import repro.models.api as ref_api
import repro.optim.optimizer as ref_optim
import repro.train.state as ref_state
from repro.analysis.shardcheck import AbstractMesh as RefAbstractMesh
from repro_torch.configs import PREFILL_32K, TRAIN_4K, get_config
from repro_torch.dist.sharding import batch_pspecs, mesh_axis_sizes, sharding_rules
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh, make_production_mesh
from repro_torch.models.api import input_specs

DTYPE_BYTES = {"float32": 4, "int32": 4, "bfloat16": 2}


def _local(shape, spec, sizes):
    """The elements a rank holds of ``shape`` split by ``spec``."""
    n = 1
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        n *= size // math.prod(sizes[a] for a in axes)
    return n


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-1.5b"])
def test_train_cell_argument_bytes_match_reference_specs(arch):
    """(16, 16), the reduced config, a global batch of 32 x 64: the state
    part, byte for byte, against ``repro.dist.sharding.param_pspecs`` of
    the reference's state schema on its ``AbstractMesh``; the batch part
    against the port's own batch specs."""
    cfg = get_config(arch).reduced()
    shape = dataclasses.replace(TRAIN_4K, seq_len=64, global_batch=32, name="t")
    with fake_world(256, "meta"):
        mesh = make_production_mesh()
        rec = dryrun.run_step(cfg, shape, mesh, "meta")
        sizes = mesh_axis_sizes(mesh)
        rules = sharding_rules(cfg, mesh, shape)
        bspecs = batch_pspecs(cfg, shape, rules, mesh, input_specs(cfg, shape))

    rcfg = ref_configs.get_config(arch).reduced()
    rshape = dataclasses.replace(ref_configs.TRAIN_4K, seq_len=64, global_batch=32, name="t")
    rmesh = RefAbstractMesh((16, 16))
    rapi = ref_api.get_model(rcfg)
    schema = ref_state.state_schema(rapi, ref_optim.make_optimizer(rcfg))
    rrules = ref_sharding.sharding_rules(rcfg, rmesh, rshape)
    specs = ref_sharding.param_pspecs(schema, rrules, rmesh)
    leaves = jax.tree_util.tree_leaves(schema, is_leaf=lambda x: hasattr(x, "axes"))
    want_state = sum(_local(s.shape, tuple(p), sizes) * DTYPE_BYTES[s.dtype]
                     for s, p in zip(leaves, jax.tree_util.tree_leaves(specs)))
    assert rec["argument_bytes_state"] == want_state
    batch = input_specs(cfg, shape)
    want_batch = sum(_local(tuple(batch[k].shape), bspecs[k], sizes) * batch[k].element_size()
                     for k in batch)
    assert rec["argument_bytes_batch"] == want_batch
    assert rec["argument_bytes"] == want_state + want_batch
    assert rec["peak_bytes"] >= rec["argument_bytes"] and rec["flops"] > 0
    assert set(rec["collective_bytes"]) >= {"all-gather", "reduce-scatter"}


def test_prefill_flops_equal_the_analytic_count():
    """Reduced llama3-8b's full-sequence forward on one device: the linears
    (``2 T in out``: q, k, v, o, gate, up, down), the unembedding and the
    flash kernel's formula, per layer; nothing else is a product."""
    cfg = get_config("llama3-8b").reduced()
    B, S = 2, 64
    shape = dataclasses.replace(PREFILL_32K, seq_len=S, global_batch=B, name="p")
    with fake_world(1, "meta"):
        rec = dryrun.run_step(cfg, shape, make_mesh(1, 1), "meta")
    T, D, F = B * S, cfg.d_model, cfg.d_ff
    q, kv = cfg.num_heads * cfg.d_head, cfg.num_kv_heads * cfg.d_head
    per_layer = 2 * T * (D * q + 2 * D * kv + q * D + 3 * D * F)
    attn = fa.flops_fwd(B, S, S, cfg.num_heads, cfg.d_head, True, cfg.sliding_window)
    want = cfg.num_layers * (per_layer + attn) + 2 * T * D * cfg.padded_vocab
    assert rec["flops"] == want
    assert rec["flops_by_op"]["repro_torch.flash_attention_fwd"] == cfg.num_layers * attn
    assert rec["collective_bytes"] == {} and rec["collective_bytes_total"] == 0
    assert rec["output_bytes"] == B * S * cfg.padded_vocab * 2  # the logits, in cfg.dtype (bf16)


ONE_LAYER = {"num_layers": 1, "num_encoder_layers": 1}
REFUSED = {  # (arch, shape) -> (CLI overrides of a layout item 11b once refused)
    ("seamless-m4t-large-v2", "train_4k"): ("--cfg-override", {"sequence_parallel": True}),
    ("llama3-8b", "decode_32k"): ("--rules-override", {"norm": ["model"]}),
}


@pytest.mark.parametrize("arch,shape", sorted(REFUSED))
def test_refused_cell_fails_naming_item_11b(arch, shape, tmp_path, capsys):
    """The layouts item 11b once refused on the (16, 16) mesh, asked for
    through the CLI's overrides (sequence parallelism on seamless; a
    parameter split over 'model' along ``norm``, an axis no block splits,
    on llama3-8b's decode cell), cut to one layer: each writes its record
    (exit 0) with the FLOPs of the same cell without the override, since
    it is the same work; the sequence-parallel one splits its activations,
    so its peak lies below its twin's."""
    flag, over = REFUSED[(arch, shape)]
    recs = []
    for extra in ([flag, json.dumps(over)], []):
        out = tmp_path / f"d{len(recs)}.jsonl"
        cfg = dict(ONE_LAYER, **over) if flag == "--cfg-override" and extra else ONE_LAYER
        args = ["--cfg-override", json.dumps(cfg)] + (extra if flag == "--rules-override" else [])
        assert dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single",
                            "--out", str(out)] + args) == 0
        recs.append(json.loads(out.read_text().splitlines()[-1]))
    got, twin = recs
    assert got["flops"] == twin["flops"] > 0
    assert (got["cfg_override"], got["rules_override"]) == (
        (dict(ONE_LAYER, **over), {}) if flag == "--cfg-override" else (ONE_LAYER, over))
    if flag == "--cfg-override":
        assert got["peak_bytes"] < twin["peak_bytes"]
    assert "FAILED" not in capsys.readouterr().err


def test_unrunnable_layout_fails_naming_it(tmp_path, capsys):
    """A layout no model computes on, the batch whole and its sequence
    split over 'data', fails the cell (exit 1) with a message that names
    it; nothing falls through silently."""
    out = tmp_path / "d.jsonl"
    rc = dryrun.main(["--arch", "llama3-8b", "--shape", "train_4k", "--mesh", "single",
                      "--out", str(out), "--cfg-override", json.dumps(ONE_LAYER),
                      "--rules-override", '{"act_batch": [], "act_seq": ["data"]}'])
    err = capsys.readouterr().err
    assert rc == 1 and "split along its sequence over ['data']" in err and not out.exists()


FLASH = ("flash_attention_fwd", "flash_attention_bwd")
ADMITTED = {  # arch -> (shapes, the kernel operators the train step must run)
    "rwkv6-1.6b": (("train_4k", "long_500k"), ("wkv6_chunk_fwd", "wkv6_chunk_bwd")),
    "zamba2-2.7b": (("train_4k", "long_500k"), ("ssd_chunk_fwd", "ssd_chunk_bwd") + FLASH),
    "qwen3-moe-30b-a3b": (("train_4k",), FLASH),
    "grok-1-314b": (("train_4k",), FLASH),
    "pixtral-12b": (("train_4k",), FLASH),
    "seamless-m4t-large-v2": (("train_4k",), FLASH),
    "llama3-8b": (("decode_32k",), ()),
}
# the cells whose decode cache the rules split along its sequence -> whether
# 'model' carries it (and the query heads are gathered over 'model')
SPLIT_KV = {("llama3-8b", "decode_32k"): True, ("zamba2-2.7b", "long_500k"): False}


@pytest.mark.parametrize("arch,shape", [(a, sh) for a in sorted(ADMITTED)
                                        for sh in ADMITTED[a][0]])
def test_tensor_parallel_cell_runs(arch, shape):
    """A cell of each family that tensor parallelism over 'model' admits,
    on the (16, 16) mesh at full width and one layer (seamless: one encoder
    and one decoder layer): it runs on meta tensors, names no refusal, and
    counts its kernels' operators and the all-reduces of its row-parallel
    products; the all-gathers of the split outputs (rwkv6's ``cw_r``, the
    MoE router and experts, pixtral's and seamless's frontend projection)
    are counted with them.  rwkv6's ``long_500k`` (a batch of 1:
    ``act_kv_seq`` on 'data', an axis its O(1) state lacks) decodes; so do
    zamba2's, whose shared block's cache is split along its sequence over
    'data', and llama3-8b's ``decode_32k``, whose 8 KV heads cannot split
    16 ways, with the sequence on 'model': each counts its merge's
    all-reduces, and llama3-8b the gather of ``q`` over 'model'."""
    from repro_torch.configs import SHAPES

    cfg = dataclasses.replace(get_config(arch), num_layers=1)
    if cfg.num_encoder_layers:
        cfg = dataclasses.replace(cfg, num_encoder_layers=1)
    with fake_world(256, "meta"):
        rec = dryrun.run_step(cfg, SHAPES[shape], make_production_mesh(), "meta")
    assert rec["flops"] > 0 and rec["collective_bytes"]["all-reduce"] > 0
    if shape == "train_4k":
        for k in ADMITTED[arch][1]:
            assert rec["flops_by_op"][f"repro_torch.{k}"] > 0, (k, rec["flops_by_op"])
    if arch in ("rwkv6-1.6b", "qwen3-moe-30b-a3b", "pixtral-12b", "seamless-m4t-large-v2"):
        assert rec["collective_bytes"]["all-gather"] > 0
    if (arch, shape) in SPLIT_KV:  # against the same cell with the cache kept whole
        with fake_world(256, "meta"):
            mesh = make_production_mesh()
            rules = dict(sharding_rules(cfg, mesh, SHAPES[shape]), act_kv_seq=())
            whole = dryrun.run_step(cfg, SHAPES[shape], mesh, "meta", rules=rules)
        B = SHAPES[shape].global_batch // (16 if SHAPES[shape].global_batch % 16 == 0 else 1)
        H, H_loc, hd = cfg.num_heads, cfg.num_heads // 16, cfg.d_head
        heads = H if SPLIT_KV[(arch, shape)] else H_loc
        # the merge: a max of the (B, 1, heads) fp32 log-sum-exp, one sum of the
        # (B, 1, heads, hd + 1) fp32 weighted rows and weights
        merge = 4 * B * heads * (1 + hd + 1)
        got = {k: rec["collective_bytes"].get(k, 0) - whole["collective_bytes"].get(k, 0)
               for k in ("all-reduce", "all-gather")}
        gather = 2 * B * H_loc * hd if SPLIT_KV[(arch, shape)] else 0  # this rank's bf16 q
        assert got == {"all-reduce": merge, "all-gather": gather}, got


def test_cli_writes_one_record_with_the_reference_keys(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    rc = dryrun.main(["--arch", "llama3-8b", "--shape", "train_4k", "--mesh", "single",
                      "--cfg-override", '{"num_layers": 1}', "--out", str(out)])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    reference_keys = {"arch", "shape", "mesh", "n_devices", "kind", "argument_bytes",
                      "output_bytes", "temp_bytes", "peak_bytes", "collective_bytes",
                      "collective_bytes_total", "collective_diag", "n_params",
                      "dropped_rules", "rules_override", "cfg_override"}
    assert reference_keys <= set(rec)
    assert {"flops", "bytes_written", "run_s", "device", "argument_bytes_state",
            "argument_bytes_batch"} <= set(rec)
    assert (rec["n_devices"], rec["kind"], rec["device"]) == (256, "train", "meta")
    assert rec["cfg_override"] == {"num_layers": 1}
    assert rec["peak_bytes"] == (rec["argument_bytes"] + rec["output_bytes"]
                                 + rec["temp_bytes"])
    assert rec["collective_bytes_total"] == sum(rec["collective_bytes"].values()) > 0
    assert "=== llama3-8b × train_4k × single (256 devices, fake meta) ===" in \
        capsys.readouterr().out


def test_cuda_without_a_cuda_build_is_refused(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: False)
    with pytest.raises(SystemExit, match="--device meta"):
        dryrun.main(["--arch", "llama3-8b", "--shape", "train_4k", "--device", "cuda",
                     "--out", ""])


def test_only_the_card_or_meta_is_modelled(capsys):
    """CPU tensors would take the plain versions, not the card's kernels, so
    a dry-run on them is refused, by the CLI and by the cell alike."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3-8b", "--shape", "train_4k", "--device", "cpu",
                     "--out", ""])
    assert e.value.code == 2 and "invalid choice: 'cpu'" in capsys.readouterr().err
    with pytest.raises(ValueError, match="cuda or meta, not cpu"):
        dryrun._record("llama3-8b", "train_4k", "single", device="cpu")
