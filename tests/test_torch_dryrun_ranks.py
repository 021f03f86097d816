"""The dry-run's per-rank collectives (`repro_torch.launch.dryrun.
rank_trace`): the ring rule against the reference's HLO parser, the
record's fields under the reference's names, the archs whose heads a
16-way model axis does not divide at published width, and the trace's
process hygiene.  The trace against real gloo ranks is held in
`test_torch_tp.py` (`test_rank_trace_equals_the_gloo_run`).

The reference's parser runs in a subprocess (`_dryrun_reference.py`):
importing `repro.launch.dryrun` forces 512 host devices on the process.
"""
import pytest
import torch
import torch.distributed as dist

from _dryrun_cells import ask_reference
from repro_torch.configs import get_smoke_config
from repro_torch.core import mesh as core_mesh
from repro_torch.launch import dryrun

HLO_DTYPES = {"f32": 4, "bf16": 2, "s32": 4, "s8": 1, "f64": 8, "u8": 1}
# (kind, dtype, result dims, group size n, replica_groups form)
HLO_CASES = [
    ("all-reduce", "f32", (1024, 512), 16, "iota"),
    ("all-reduce", "bf16", (7, 5120), 2, "iota"),
    ("all-reduce", "s32", (3,), 4, "list"),
    ("all-reduce", "f64", (2, 3, 5), 32, "iota"),
    ("all-reduce", "f32", (1,), 256, "iota"),
    ("all-gather", "bf16", (16, 1024), 16, "iota"),
    ("all-gather", "f32", (4, 96), 2, "list"),
    ("all-gather", "s8", (512, 33), 256, "iota"),
    ("all-gather", "u8", (6, 6), 3, "list"),
    ("all-gather", "f64", (64,), 32, "iota"),
    ("reduce-scatter", "f32", (8, 512), 16, "iota"),
    ("reduce-scatter", "f32", (4, 7, 96), 2, "list"),
    ("reduce-scatter", "bf16", (2, 1024), 4, "iota"),
    ("reduce-scatter", "f32", (3,), 256, "iota"),
]
DEVICES = 512
# the port's broadcast rule, which the reference has no kind for:
# (payload bytes S, group size n) -> S * (n - 1) / n, each of the n - 1
# receivers taking S once, averaged over the n devices
BROADCAST = [(1000, 2, 500.0), (1024, 16, 960.0), (7, 4, 5.25),
             (3, 256, 3 * 255 / 256)]


def hlo_line(kind, dtype, dims, n, form):
    """One collective as XLA's optimized HLO prints it (a reduce-scatter's
    operand n times its result along the first dim)."""
    shape = f"{dtype}[{','.join(map(str, dims))}]"
    operand = shape if kind != "reduce-scatter" else \
        f"{dtype}[{','.join(map(str, (dims[0] * n,) + tuple(dims[1:])))}]"
    if form == "iota":
        groups = f"replica_groups=[{DEVICES // n},{n}]<=[{DEVICES}]"
    else:
        groups = "replica_groups={{" + ",".join(map(str, range(n))) + "}}"
    return (f"  %{kind}.7 = {shape}{{0}} {kind}({operand}{{0}} %p.1), "
            f"{groups}, to_apply=%add")


@pytest.fixture(scope="module")
def ref():
    return ask_reference({"hlo": [[hlo_line(*c), DEVICES]
                                  for c in HLO_CASES]})


def result_bytes(dtype, dims):
    n = HLO_DTYPES[dtype]
    for d in dims:
        n *= d
    return n


@pytest.mark.parametrize("case", HLO_CASES, ids=lambda c: "-".join(
    [c[0], c[1], "x".join(map(str, c[2])), str(c[3]), c[4]]))
def test_ring_rule_equals_the_reference(ref, case):
    """The port's wire bytes of a recorded call (an all-reduce's payload
    is its result; an all-gather's its input, 1/n of the result; a
    reduce-scatter's its input, n times the result) equal the reference's
    parse of the same collective's HLO line."""
    kind, dtype, dims, n, _ = case
    total, by_kind, counts = ref["hlo"][HLO_CASES.index(case)]
    size = result_bytes(dtype, dims)
    payload = {"all-reduce": size, "all-gather": size // n,
               "reduce-scatter": size * n}[kind]
    port = dryrun.collective_fields([{"kind": kind, "n": n,
                                      "payload_b": payload, "axes": "x"}])
    assert counts[kind] == 1 and sum(counts.values()) == 1
    assert dryrun.ring_wire_bytes(kind, payload, n) == total \
        == by_kind[kind]
    assert port["collective_bytes_per_device"] == total
    assert {k: port["collective_by_kind"][k] for k in by_kind} == by_kind
    assert {k: port["collective_counts"][k] for k in counts} == counts


@pytest.mark.parametrize("payload,n,want", BROADCAST)
def test_broadcast_rule(payload, n, want):
    assert dryrun.ring_wire_bytes("broadcast", payload, n) == want


def test_fields_carry_the_reference_kinds(ref):
    """An ok record carries the reference's three collective fields, its
    five kinds in each (and "broadcast"), the by-axis fields and
    flops_per_device."""
    rec = dryrun.run_cell("qwen3-14b", "decode_32k", "multi",
                          cfg_overrides={"n_layers": 1})
    assert rec["status"] == "ok", rec.get("error")
    kinds = ref["collectives"] + ["broadcast"]
    assert list(rec["collective_counts"]) == kinds
    assert list(rec["collective_by_kind"]) == kinds
    assert rec["collective_bytes_per_device"] == sum(
        rec["collective_by_kind"].values()) > 0
    assert sum(rec["collective_calls_by_axis"].values()) == sum(
        rec["collective_counts"].values())
    # the multi-pod mesh's data axes run as one label
    assert set(rec["collective_calls_by_axis"]) == {"model", "pod+data"}
    assert set(rec["collective_payload_b_by_axis"]) == {"model", "pod+data"}
    assert rec["flops_per_device"] > 0


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ["qwen3-14b", "minitron-4b",
                                  "llava-next-34b"])
def test_heads_a_16_way_axis_does_not_divide(arch, mesh_kind):
    """40, 24 and 56 heads over a model axis of 16, at published width
    and one layer: every shape's rank trace runs, with the model axis's
    collectives in it."""
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.run_cell(arch, shape, mesh_kind,
                              cfg_overrides={"n_layers": 1})
        assert rec["status"] == "ok", (shape, rec.get("error"))
        assert rec["collective_calls_by_axis"]["model"] > 0


def small_trace(**kw):
    cfg = get_smoke_config("qwen3-14b")
    batch = {"tokens": torch.empty((4, 1), dtype=torch.long,
                                   device="meta")}
    return dryrun.rank_trace(cfg, "decode", (2, 2), ("data", "model"),
                             batch, ctx_len=40, **kw)


def test_no_group_is_left_and_none_is_replaced(tmp_path):
    """After a trace no process group is initialised and no sub-group is
    kept; under a group the caller made the trace raises and the cell is
    an error, and the caller's group stays."""
    assert sum(small_trace()["collective_counts"].values()) > 0
    assert not dist.is_initialized() and not core_mesh._GROUPS
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="already initialised"):
            small_trace()
        rec = dryrun.run_cell("qwen3-14b", "decode_32k", "single",
                              cfg_overrides={"n_layers": 1})
        assert rec["status"] == "error" and "already" in rec["error"]
        assert "collective_counts" not in rec
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_a_trace_that_cannot_run_is_an_error(monkeypatch):
    """Without the fake backend the cell is an error with the reason, and
    carries no collective field."""
    def no_backend(world, rank=0):
        raise ImportError("no fake process group")
    monkeypatch.setattr(dryrun, "fake_ranks", no_backend)
    rec = dryrun.run_cell("qwen3-14b", "decode_32k", "single",
                          cfg_overrides={"n_layers": 1})
    assert rec["status"] == "error" and "fake" in rec["error"]
    assert not [k for k in rec if k.startswith("collective")]


def test_a_cell_without_zero1_has_no_rank_trace():
    """`--no-zero1` keeps the global trace's fields and says why it has
    no rank trace: the rank path always cuts the moments over "data"."""
    rec = dryrun.run_cell("qwen3-14b", "train_4k", "single", zero1=False,
                          cfg_overrides={"n_layers": 1})
    assert rec["status"] == "ok" and rec["mem_argument_b"] > 0
    assert "ZeRO-1" in rec["rank_trace"]
    assert not [k for k in rec if k.startswith("collective")]


def test_adafactor_traces_no_whole_leaf():
    """Rank 0's trace of a MoE train step under Adafactor over (2, 2)
    (deepseek-v3's smoke config with moe_d_ff 128, so that its expert
    banks [2, 8, 128, 128] are factored): its temp at most the same
    step's under AdamW plus 10 %, and its payload over the model axis
    AdamW's plus less than one rank's block of a bank.  The whole-leaf
    update, which gathered the gradients, params and state whole, read
    19.0 MB of temp against AdamW's 9.7 MB and 8.8 MB over the model
    axis against 0.49 MB."""
    cfg = get_smoke_config("deepseek-v3-671b").replace(moe_d_ff=128)
    batch = {k: torch.empty((4, 32), dtype=torch.long, device="meta")
             for k in ("tokens", "labels")}
    got = {opt: dryrun.rank_trace(cfg, "train", (2, 2), ("data", "model"),
                                  batch, optimizer=opt, flops=False)
           for opt in ("adafactor", "adamw")}
    assert got["adafactor"]["mem_temp_b"] <= 1.1 * got["adamw"]["mem_temp_b"]
    block = 2 * (cfg.n_experts // 2) * 128 * cfg.d_model * 4
    model = {opt: g["collective_payload_b_by_axis"]["model"]
             for opt, g in got.items()}
    assert 0 <= model["adafactor"] - model["adamw"] < block, model
