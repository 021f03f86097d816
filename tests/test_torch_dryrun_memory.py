"""The dry-run's per-device memory (`repro_torch.launch.dryrun`:
`LiveBytes`, `step_memory`, `rank_trace`'s "mem_temp_b", `run_cell`'s
"mem_peak_b"): a linear layer's forward and backward against the bytes
counted by hand; the meta trace against the same tracker on real CPU
tensors, byte for byte, for a smoke train, prefill and decode step of
every family as rank 0 of a (1, 2) mesh of ranks; the flash path's meta
operators (no [S, S] term; the dense scores' FLOPs); the reference's
identity mem_peak_b = mem_argument_b + mem_temp_b on real cells at one
layer, with rank 0's own argument bytes beside the spec-derived ones;
the field names against the reference's `run_cell`.

The values are the port's eager program's, not XLA's (which fuses,
schedules and reuses buffers), so nothing here holds them to XLA's
temp_size_in_bytes.
"""
import contextlib
import io

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _dryrun_cells import FAMILY_ARCHS, ask_reference
from repro_torch.configs import SHAPES, ShapeConfig, get_smoke_config
from repro_torch.core import mesh as core_mesh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as lmesh
from test_torch_dryrun import real_like

KINDS = ("train", "prefill", "decode")


# --- by hand -----------------------------------------------------------------

def linear_grad(w, x):
    """The gradient of sum(x @ w.T) in w."""
    loss = (x @ w.t()).sum()
    return torch.autograd.grad(loss, w)


def tanh_grad(w, x):
    """The gradient of sum(tanh(x @ w.T)) in w: tanh saves its output."""
    loss = torch.tanh(x @ w.t()).sum()
    return torch.autograd.grad(loss, w)


def remat_tanh_grad(w, x):
    """`tanh_grad` with the layer recomputed in the backward."""
    loss = torch.utils.checkpoint.checkpoint(
        lambda w, x: torch.tanh(x @ w.t()), w, x, use_reentrant=False).sum()
    return torch.autograd.grad(loss, w)


# w [256, 128] and x [64, 128] float32: x @ w.T is 65,536 bytes, the
# gradient [256, 128] 131,072, the loss and the backward's seed of ones
# a 512-byte block each (the allocator's rounding).
#   linear: the product dies when the sum has read it (the sum saves
#     nothing); the backward holds the loss, the seed and the gradient:
#     512 + 512 + 131,072.
#   tanh: its output (65,536) is saved until the backward's tanh step,
#     which makes the product's gradient (65,536) and frees it; the
#     gradient in w is then made beside the loss, the seed and the
#     product's gradient: 512 + 512 + 65,536 + 131,072.
#   remat: the same peak; the recomputed product and tanh are made and
#     freed inside the backward before the gradient in w.
BY_HAND = {linear_grad: 132_096, tanh_grad: 197_632,
           remat_tanh_grad: 197_632}


@pytest.mark.parametrize("fn", list(BY_HAND), ids=lambda f: f.__name__)
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_linear_layer_by_hand(fn, device):
    w = torch.zeros(256, 128, device=device, requires_grad=True)
    x = torch.zeros(64, 128, device=device)
    got = dryrun.step_memory(fn, (w, x), train=True, device=device)
    assert got == {"mem_temp_b": BY_HAND[fn],
                   "rank_argument_b": (256 + 64) * 128 * 4}


def test_views_and_in_place_results_allocate_nothing():
    def fn(x):
        y = x * 2                         # 4096 bytes
        y.add_(1)                         # in place: nothing new
        return y.view(32, 32).t()[:4]     # views of y: nothing new
    x = torch.zeros(1024, device="meta")
    assert dryrun.step_memory(fn, (x,), train=False)["mem_temp_b"] == 4096


# --- meta against real CPU tensors ------------------------------------------

def traced(arch, kind, device, attention_impl="flash", rows=4, seq=64,
           shape=(1, 2)):
    """`step_memory` of rank 0's smoke step of `kind` on `device` over a
    fake process group (collectives move nothing; the bytes do not
    depend on the values)."""
    cfg = get_smoke_config(arch).replace(attention_impl=attention_impl)
    if kind != "train":
        cfg = cfg.replace(param_dtype="bfloat16", remat=False)
    names = ("tokens", "labels") if kind == "train" else ("tokens",)
    width = 1 if kind == "decode" else seq
    batch = {k: torch.zeros((rows, width), dtype=torch.int32, device=device)
             for k in names}
    if kind != "decode" and cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (rows, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    if kind != "decode" and cfg.family == "audio":
        batch["frames"] = torch.zeros((rows, cfg.n_frames, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)
    world = shape[0] * shape[1]
    with dryrun.fake_ranks(world):
        mesh = core_mesh.make_rank_mesh(shape, ("data", "model"),
                                        [torch.device(device)] * world)
        fn, args, train = dryrun.rank_steps(cfg, kind, mesh, batch,
                                            ctx_len=seq, device=device)
        return dryrun.step_memory(fn, args, train=train, device=device)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS + ("drim-bnn",))
def test_meta_trace_equals_real_cpu_tensors(arch, kind):
    """At 64 positions no site takes the flash path, so the CPU and the
    meta device run the same operators: the same bytes."""
    meta = traced(arch, kind, "meta")
    assert meta["mem_temp_b"] > 0
    assert meta == traced(arch, kind, "cpu")


@pytest.mark.parametrize("kind", ("train", "prefill"))
def test_flash_sites_hold_no_square_term(kind):
    """qwen3-14b's smoke step as rank 0 of (1, 2) at 512 positions of 8
    rows and at 1024 of 4 (flash-eligible both, the same tokens): on the
    card's path every tensor scales with the tokens, so the temp barely
    moves (the rope tables grow with the positions); with the dense
    scores it grows by their [S, S] term."""
    def temp(impl, rows, seq):
        return traced("qwen3-14b", kind, "meta", impl, rows, seq)[
            "mem_temp_b"]
    flash = temp("flash", 8, 512), temp("flash", 4, 1024)
    dense = temp("xla", 8, 512), temp("xla", 4, 1024)
    assert abs(flash[1] - flash[0]) <= 0.02 * flash[0], flash
    assert dense[1] - dense[0] > 0.5 * dense[0], dense
    assert flash[0] < dense[0]


def test_meta_flash_counts_the_dense_flops(monkeypatch):
    """At 128 positions the meta step takes the flash operators and the
    CPU's the dense `_sdpa`; the FLOPs are equal (forward 4*B*H*Sq*Sk*D,
    backward 8*), the train step with remat's recomputed forward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime.steps import make_train_state
    monkeypatch.setitem(SHAPES, "flash_train",
                        ShapeConfig("flash_train", 128, 2, "train"))
    cfg = get_smoke_config("qwen3-14b")
    cell, args = dryrun.build_cell(cfg, "flash_train",
                                   dryrun.production_mesh("single"),
                                   optimizer="adamw")
    devices, inner = [], fa.flash_fwd

    def spy(q, *a, **kw):
        devices.append(q.device.type)
        return inner(q, *a, **kw)
    monkeypatch.setattr(fa, "flash_fwd", spy)
    _, meta_flops, _ = dryrun.run_meta(cell, args)
    # two sites, each run forward and again in the backward (remat)
    assert devices == ["meta"] * 4
    real = [real_like(a, np.random.default_rng(0)) for a in args]
    real[0] = make_train_state(0, cfg, get_optimizer("adamw"), device="cpu")
    counter = FlopCounterMode(display=False)
    with counter, torch.enable_grad():
        cell.fn(*real)
    assert devices == ["meta"] * 4          # the CPU took `_sdpa`
    assert meta_flops == counter.get_total_flops()


def test_meta_flash_gives_the_kernels_outputs():
    """The meta operators' outputs are the kernels' shapes and dtypes:
    out in q's dtype, lse and delta float32 [B, H, Sq], dq, dk, dv in
    q's, k's and v's; nothing is launched."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.empty(2, 8, 256, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 2, 256, 64, dtype=torch.bfloat16, device="meta")
    launches = fa.flash_fwd.launches, fa.flash_bwd_dq.launches
    out, lse = fa.flash_fwd(q, k, k, n_rep=4)
    assert (out.shape, out.dtype) == (q.shape, q.dtype)
    assert (lse.shape, lse.dtype) == ((2, 8, 256), torch.float32)
    dq, dk, dv = fa.flash_bwd(q, k, k, out, lse, out, n_rep=4)
    assert [(t.shape, t.dtype) for t in (dq, dk, dv)] == \
        [(q.shape, q.dtype), (k.shape, k.dtype), (k.shape, k.dtype)]
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches) == launches
    with pytest.raises(ValueError, match="head widths"):
        fa.flash_fwd(q[..., :48].contiguous(), k[..., :48].contiguous(),
                     k[..., :48].contiguous(), n_rep=4)


# --- production cells ---------------------------------------------------------

# rank 0's own argument bytes less `mem_argument_b`, each cell at 1 layer
# on the 16 x 16 mesh.  Every rank holds the global batch (it cuts its
# rows inside the step, as the CLIs feed it) where the specs cut it over
# the 16 data ranks: 15/16 of tokens [256, 4096] and labels in train_4k,
# of tokens [32, 32768] and whisper's frames [32, 1500, 1024] bf16 in
# prefill_32k, of tokens [128, 1] and pos [128] in decode_32k; an SSM
# decode holds the pos it never reads (jit prunes it from the
# reference's arguments: 512 bytes); deepseek-v3's MLA decode caches
# are laid out by `rank_cache_pspecs` ("ckv" cut over "model" like
# "k_rope"), 1/16 of the bytes the reference's `cache_pspecs` leaves a
# device: 251,658,240 fewer.
ARGUMENT_GAPS = {
    ("qwen3-14b", "train_4k"): 7_864_320,
    ("llava-next-34b", "train_4k"): 7_864_320 + 9_909_043_200,
    ("whisper-medium", "prefill_32k"): 3_932_160 + 92_160_000,
    ("mamba2-130m", "decode_32k"): 480 + 512,
    ("deepseek-v3-671b", "decode_32k"): 480 + 480 - 251_658_240,
}


@pytest.mark.parametrize("cell", sorted(ARGUMENT_GAPS),
                         ids=lambda c: "-".join(c))
def test_peak_is_arguments_plus_temp(cell):
    with contextlib.redirect_stdout(io.StringIO()):
        rec = dryrun.run_cell(*cell, "single",
                              cfg_overrides={"n_layers": 1})
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mem_temp_b"] > 0
    assert rec["mem_peak_b"] == rec["mem_argument_b"] + rec["mem_temp_b"]
    assert rec["rank_argument_b"] - rec["mem_argument_b"] == \
        ARGUMENT_GAPS[cell]


def test_a_cell_without_zero1_carries_no_memory_fields():
    with contextlib.redirect_stdout(io.StringIO()):
        rec = dryrun.run_cell("qwen3-14b", "train_4k", "single",
                              zero1=False, cfg_overrides={"n_layers": 1})
    assert rec["status"] == "ok"
    assert not {"mem_temp_b", "mem_peak_b"} & set(rec)
    assert "not traced" in rec["mem_note"]


def test_memory_field_names_are_the_reference_run_cells():
    """The port's record carries every memory key the reference's
    `run_cell` writes (it reads them from XLA's memory_analysis())."""
    cell = ["mamba2-130m", "decode_32k", "single", {"n_layers": 1}]
    keys = set(ask_reference({"run_cell": [cell]})["run_cell"][0])
    want = {k for k in keys if k.startswith("mem_")}
    assert want == {"mem_argument_b", "mem_output_b", "mem_temp_b",
                    "mem_peak_b"}
    with contextlib.redirect_stdout(io.StringIO()):
        rec = dryrun.run_cell(*cell[:3], cfg_overrides=cell[3])
    assert want <= set(rec)


def test_production_mesh_under_ranks_without_a_card_raises():
    """Under a process group of 256 ranks (a fake one) and no card, the
    production mesh of the ranks raises, naming the missing card, and so
    does the host mesh; asked for the CPU, both are built there."""
    with dryrun.fake_ranks(256):
        for make in (lmesh.make_production_mesh, lmesh.make_host_mesh):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
            assert make(kind="cpu").devices.flat[0] == torch.device("cpu")
