"""Multi-pod dry-run on meta tensors: build every (arch x shape x mesh)
cell and report what one device of the production mesh would hold (port
of `repro.launch.dryrun`).

The reference AOT-compiles each cell's jitted step on 512 forced host
devices and reads XLA's analyses.  The port compiles nothing.  It builds
each cell's step and arguments on the meta device (shapes and dtypes, no
storage) with the specs of the 16 x 16 single-pod or 2 x 16 x 16
multi-pod mesh (`core.mesh.abstract_mesh`: `launch.mesh.
make_production_mesh` raises below 256 devices), runs the step once at
the cell's full global shape, and records:

  * lower_s             the time to build the cell and run its step on
                        meta tensors: the counterpart of `.lower()`, the
                        proof that shapes and specs cohere;
  * mem_argument_b      per-device bytes of the step's arguments: each
                        leaf's dims ceil-divided by the sizes of its
                        spec's mesh axes, summed over the leaves the step
                        reads (how XLA's argument_size_in_bytes is made:
                        jit prunes an argument nothing reads);
  * mem_output_b        the same over the outputs under their
                        out-shardings (XLA's output_size_in_bytes less its
                        8-byte tuple index per output leaf);
  * flops_global        `torch.utils.flop_counter.FlopCounterMode`'s
                        count of the whole global step as one process
                        runs it: not per device, and not an `hlo_*` key;
  * model_flops_global, param_count, active_param_count (as the
                        reference).

The step is traced with no ambient mesh: under the production mesh the
MoE would take its expert-parallel path, which runs a block per (data,
model) position in turn.  The mesh enters only through the specs.  The
meta device models the card: attention takes the flash wrappers wherever
the card would (`attention._use_flash`: unwindowed, the sequence a
multiple of 128), whose meta operators give the kernels' outputs (out,
lse; in the backward delta, dq, dk, dv) and nothing [Sq, Sk]-shaped, and
count for `FlopCounterMode` the FLOPs of the dense products the CPU's
`_sdpa` runs (`kernels.flash_attention`), so `flops_global` is a CPU
run's count of the same step.  The port's trunk is a Python loop, so the
meta run counts every layer.

Then each cell runs a second time, as rank 0 of the production mesh of
ranks (`rank_trace`): a `"fake"` process group of 256 or 512 ranks
(`torch.testing`'s `FakeStore`: every collective returns at once, and
moves nothing), the mesh `launch.mesh.make_production_mesh` builds under
ranks with meta devices, and the rank path of the cell's kind on its
inputs: a train step (`make_train_step(cfg, mesh)`) on the state's
`steps.cut` blocks of `state_pspecs` and the global batch; a prefill or
decode step inside the mesh on `serve.place_params`' blocks, the decode
caches cut by `rank_cache_pspecs`, as `launch.serve` feeds them.  Every
collective of the port's own code (`core.mesh`'s all-reduces,
all-gathers, reduce-scatters and broadcasts, `record_collectives`) is
recorded with its kind, group size n, payload and axes, which gives:

  * collective_counts, collective_by_kind, collective_bytes_per_device
                        under the reference's names and its five kinds
                        (zero where the port has none) plus "broadcast"
                        (`mesh_gather`'s), the wire bytes a device by the
                        reference's ring rule (`ring_wire_bytes`): an
                        all-reduce of S bytes 2*S*(n-1)/n, an all-gather
                        S*(n-1)/n of its gathered result S (n times its
                        input), a reduce-scatter S*(n-1) of its result
                        S (1/n of its input), a broadcast S*(n-1)/n
                        (each of its n-1 receivers takes S once,
                        averaged over the n devices).  These are the
                        port's collectives, not XLA's: the same model's
                        step over the same mesh, but another program;
  * collective_calls_by_axis, collective_payload_b_by_axis
                        the calls and payload bytes by axis label
                        ("model", "data", "pod+data", ...), in the units
                        of `core.mesh.COLLECTIVE_STATS`' "calls:<axes>"
                        and "bytes:<axes>", so that a run over real ranks
                        compares exactly;
  * flops_per_device    `FlopCounterMode` over the rank's step: the
                        counterpart of the reference's
                        hlo_flops_per_device (no HLO here, so no hlo_);
  * mem_temp_b          the most bytes the rank's step holds on its
                        device on top of its arguments, from the same
                        run (`LiveBytes`): at each operator the bytes of
                        every storage still referenced (a view's once,
                        an in-place result none, autograd's saved
                        tensors until the backward frees them, remat's
                        recomputation where it runs), each rounded up as
                        the card's allocator rounds a block.  On the
                        card it is `torch.cuda.max_memory_allocated()`
                        less `memory_allocated()` just before the step.
                        Eager execution keeps the outputs live, so they
                        fall inside it, where XLA's temp_size_in_bytes
                        counts them apart and reuses buffers as its
                        schedule allows: the values are the port's, not
                        XLA's;
  * mem_peak_b          mem_argument_b + mem_temp_b, the reference's
                        identity: does the step fit a device;
  * rank_argument_b     the bytes of the arguments rank 0 itself holds
                        (its blocks; every leaf, read or not), beside
                        the spec-derived mem_argument_b.

Where the fake backend cannot be imported or the rank's step raises, the
cell's status is "error" with the reason: no count reads as zero.  A
`--no-zero1` cell has no rank trace ("rank_trace" says why) and so no
mem_temp_b or mem_peak_b ("mem_note", the reference's key, says why):
the rank path always cuts the moments over the data axes.

`host_trace` traces one process's training step (`train --mesh host`) on
meta tensors the same way, for the legs a card runs in one process.

Left out, as reference-only (they read XLA's compiler output, which a
process that compiles nothing does not have): hlo_bytes_per_device and
the HLO text parser, and the probe extrapolation (`probe_points` to
`probe_all`, which exist because XLA counts a scanned layer once: the
port's trunk is a Python loop, so the rank trace counts every layer and
needs no probe).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape train_4k --mesh single           # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # every cell

Each cell appends one JSON record to --out (resumable: cells already
there are skipped unless --force); the exit code is 1 when a cell fails.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config, shapes_for
from repro_torch.configs.registry import ARCHS
from repro_torch.core import mesh as core_mesh
from repro_torch.core.mesh import (Mesh, NamedSharding, PartitionSpec as P,
                                   abstract_mesh, axis_size)
from repro_torch.launch.mesh import PRODUCTION_MESHES, make_host_mesh
from repro_torch.launch.serve import place_params
from repro_torch.models import abstract_caches, abstract_params, init_params
from repro_torch.models.transformer import padded_vocab
from repro_torch.optim import init_errors
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.steps import (abstract_train_state, cut,
                                       make_decode_step, make_prefill_step,
                                       make_train_state, make_train_step,
                                       state_pspecs, state_shardings)
from repro_torch.tree import tree_leaves, tree_map

# The reference's collective kinds (its dry-run's COLLECTIVES), and the
# port's one more: `core.mesh.mesh_gather`'s broadcasts.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
KINDS = COLLECTIVES + ("broadcast",)

# Per-arch optimizer defaults (the giant MoEs use adafactor).
ARCH_OPTIMIZER = {"kimi-k2-1t-a32b": "adafactor",
                  "deepseek-v3-671b": "adafactor"}

META = torch.device("meta")


def production_mesh(mesh_kind: str) -> Mesh:
    """The 16 x 16 (single) or 2 x 16 x 16 (multi) mesh over meta
    devices."""
    if mesh_kind not in PRODUCTION_MESHES:
        raise ValueError(f"unknown mesh {mesh_kind!r}: single or multi")
    return abstract_mesh(*PRODUCTION_MESHES[mesh_kind])


def input_specs(cfg, shape_name: str, *, batch_override=None):
    """Meta-tensor stand-ins for every model input (no storage)."""
    sh = SHAPES[shape_name]
    b = batch_override or sh.global_batch
    s = sh.seq_len
    i32 = torch.int32

    def sd(shp, dt):
        return torch.empty(shp, dtype=dt, device=META)

    if sh.kind == "train":
        batch = {"tokens": sd((b, s), i32), "labels": sd((b, s), i32)}
    elif sh.kind == "prefill":
        batch = {"tokens": sd((b, s), i32)}
    else:  # decode: one new token against an s-length cache
        batch = {"tokens": sd((b, 1), i32)}
    if cfg.family == "vlm" and sh.kind != "decode":
        batch["patch_embeds"] = sd((b, cfg.n_patches, cfg.d_model),
                                   torch.bfloat16)
    if cfg.family == "audio" and sh.kind != "decode":
        batch["frames"] = sd((b, cfg.n_frames, cfg.d_model), torch.bfloat16)
    return batch


def model_flops(cfg, shape_name: str) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train / 2*N*D forward (+ attention)."""
    sh = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
    mult = 6.0 if sh.kind == "train" else 2.0
    flops = mult * n_active * tokens
    # attention quadratic term (full-attn archs; per-token*ctx for decode)
    if cfg.family in ("dense", "vlm", "moe", "audio"):
        h_dim = cfg.n_heads * (cfg.v_head_dim if cfg.mla else cfg.d_head)
        ctx = sh.seq_len
        q_positions = tokens
        att = 2 * 2 * cfg.n_layers * q_positions * ctx * h_dim  # qk + av
        if sh.kind == "train":
            att = att / 2 * 3  # causal halves it, bwd doubles fwd
        flops += att
    return flops


@dataclasses.dataclass(frozen=True)
class Cell:
    """A cell's step and where its arguments and outputs live: the
    shardings are trees matching `fn`'s arguments and its outputs; None
    stands for a replicated output (the reference's unspecified one).
    A train step runs with autograd on, a serving step without."""

    fn: Callable
    in_shardings: Tuple[Any, ...]
    out_shardings: Tuple[Any, ...]
    train: bool = False


def _named(mesh: Mesh, specs):
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def build_cell(cfg, shape_name: str, mesh: Mesh, *, optimizer: str,
               compress: bool = False, zero1: bool = True):
    """Returns (cell, example_args): the step, its shardings, and its
    arguments as meta tensors."""
    sh = SHAPES[shape_name]
    batch = input_specs(cfg, shape_name)
    dp = shd.dp_axes(mesh)

    if sh.kind == "train":
        # traced with no ambient mesh (see the module docstring)
        step_fn, _, opt = make_train_step(
            cfg, None, optimizer_name=optimizer, compress=compress)
        state_shape = abstract_train_state(cfg, opt)
        if compress:
            state_shape = dict(state_shape)
            with META:
                state_shape["errors"] = init_errors(state_shape["params"])
        st_sh = state_shardings(state_shape, mesh, zero1=zero1,
                                family=cfg.family)
        if compress:
            st_sh["errors"] = _named(mesh, shd.opt_state_pspecs(
                state_shape["params"], mesh, family=cfg.family))
        b_sh = _named(mesh, shd.batch_specs(mesh, batch))
        return Cell(step_fn, (st_sh, b_sh), (st_sh, None), train=True), \
            (state_shape, batch)

    # serving: params only (bf16 serving dtype)
    serve_cfg = cfg.replace(param_dtype="bfloat16", remat=False)
    params_shape = abstract_params(serve_cfg)
    p_sh = _named(mesh, shd.param_pspecs(params_shape, mesh, cfg.family))
    caches_shape = abstract_caches(serve_cfg, sh.global_batch, sh.seq_len)
    c_sh = _named(mesh, shd.cache_pspecs(mesh, caches_shape))
    logits_sh = NamedSharding(mesh, shd.sanitize_spec(
        P(dp, None, "model"), (sh.global_batch, 1, padded_vocab(cfg)),
        mesh))

    if sh.kind == "prefill":
        b_sh = _named(mesh, shd.batch_specs(mesh, batch))
        return Cell(make_prefill_step(serve_cfg), (p_sh, b_sh),
                    (logits_sh, c_sh)), (params_shape, batch)

    # decode
    tok_sh = NamedSharding(mesh, shd.sanitize_spec(
        P(dp, None), (sh.global_batch, 1), mesh))
    pos_sh = NamedSharding(mesh, shd.sanitize_spec(
        P(dp), (sh.global_batch,), mesh))
    pos = torch.empty((sh.global_batch,), dtype=torch.int32, device=META)
    return Cell(make_decode_step(serve_cfg, sh.seq_len),
                (p_sh, tok_sh, c_sh, pos_sh), (logits_sh, c_sh)), \
        (params_shape, batch["tokens"], caches_shape, pos)


def shard_bytes(leaf, sharding) -> int:
    """Bytes of one device's block of `leaf` under `sharding` (None:
    replicated): each dim ceil-divided by its spec entry's devices."""
    n = leaf.element_size()
    spec = tuple(sharding.spec) if sharding is not None else ()
    for i, dim in enumerate(leaf.shape):
        entry = spec[i] if i < len(spec) else None
        parts = axis_size(sharding.mesh, entry) if entry is not None else 1
        n *= -(-dim // parts)
    return n


def device_bytes(trees, shardings, read=None) -> int:
    """Per-device bytes of a tuple of trees under their shardings (a None
    sharding replicates its whole tree); with `read` (leaf ids), only
    those leaves."""
    def one(leaf, sh=None):
        return shard_bytes(leaf, sh) if read is None or id(leaf) in read \
            else 0
    total = 0
    for tree, sh in zip(trees, shardings):
        total += sum(tree_leaves(tree_map(one, tree) if sh is None
                                 else tree_map(one, tree, sh)))
    return total


def _tensors(items):
    """The tensors among `items`, in lists and tuples at any depth."""
    for x in items:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


class _Dataflow(TorchDispatchMode):
    """Records each operator's input tensors and outputs, so that the
    argument leaves the step's outputs depend on can be found afterwards.
    The outputs are held, so that no id is reused during the run."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append(([id(t) for t in _tensors(args)]
                         + [id(t) for t in _tensors(kwargs.values())],
                         list(_tensors((out,)))))
        return out

    def live(self, outputs) -> set:
        """Ids of every tensor some output depends on (in-place updates
        included: an operator whose output is live makes its inputs
        live)."""
        live = {id(t) for t in outputs}
        for ins, outs in reversed(self.ops):
            if any(id(t) in live for t in outs):
                live.update(ins)
        return live


# The card's caching allocator rounds every block up to 512 bytes.
ALLOC_ROUND_B = 512


class LiveBytes(TorchDispatchMode):
    """The live bytes of a step's own storages on `device`, over its
    operators: each storage an operator returns (a view's is its base's,
    counted once; an in-place operator returns one already counted), held
    through a `StorageWeakRef` (meta storages all have data_ptr 0, so the
    key is the storage's `_cdata`, which a weak reference keeps unique)
    until it expires: when the last tensor, view or autograd saved tensor
    that holds it goes.  Each storage counts as the card's allocator
    counts its block (ALLOC_ROUND_B).  The storages of `args` (the step's
    arguments, which the caller holds throughout) are left out, so that
    `peak_b` is the most the step held on top of them: the counterpart of
    `torch.cuda.max_memory_allocated()` less `memory_allocated()` just
    before the step.  The live total is swept for expired storages only
    where it would pass the peak, which keeps the peak exact (a sweep
    only lowers the total)."""

    def __init__(self, args, device):
        super().__init__()
        self.device = torch.device(device)
        stores = {st._cdata: st for st in (
            t.untyped_storage() for a in args for t in tree_leaves(a)
            if t.device == self.device)}
        self.args = {k: StorageWeakRef(st) for k, st in stores.items()}
        # the arguments' bytes (unrounded, as `mem_argument_b` counts)
        self.argument_b = sum(st.nbytes() for st in stores.values())
        self.held: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.live_b = 0
        self.peak_b = 0

    def _sweep(self) -> None:
        for key in [k for k, (ref, _) in self.held.items() if ref.expired()]:
            self.live_b -= self.held.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors((out,)):
            if t.device != self.device:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.args:
                continue
            n = -(-st.nbytes() // ALLOC_ROUND_B) * ALLOC_ROUND_B
            # a storage seen before counts again only where it was resized
            ref, had = self.held.get(key, (None, 0))
            self.held[key] = (ref or StorageWeakRef(st), n)
            self.live_b += n - had
        if self.live_b > self.peak_b:
            self._sweep()
            self.peak_b = max(self.peak_b, self.live_b)
        return out

    def fields(self) -> Dict[str, Any]:
        """"mem_temp_b", the most the step held on top of its arguments
        (`peak_b`), and "rank_argument_b", the bytes of the arguments
        the traced process held (unrounded)."""
        return {"mem_temp_b": self.peak_b,
                "rank_argument_b": self.argument_b}


def own_storages(args):
    """`args` with each tensor leaf in a contiguous storage of its own, as
    the card holds a rank's blocks (`steps.cut` gives views of the whole
    leaves)."""
    def own(t):
        c = t.detach().clone(memory_format=torch.contiguous_format)
        return c.requires_grad_(t.requires_grad)
    return tuple(tree_map(own, a) for a in args)


def run_meta(cell: Cell, args):
    """The cell's step run once on its meta arguments: (outputs, FLOPs
    counted by FlopCounterMode, the ids of the argument leaves the
    outputs depend on).  XLA removes what no output depends on, and jit
    then prunes an argument nothing reads (`keep_unused=False`): the SSM
    decode never reads `pos`, and whisper's decode reads its cross
    attention's query and output kernels but not its key and value
    kernels (the caches hold those)."""
    counter = FlopCounterMode(display=False)
    flow = _Dataflow()
    with counter, flow, \
            (torch.enable_grad() if cell.train else torch.no_grad()):
        out = cell.fn(*args)
    live = flow.live([t for o in out for t in tree_leaves(o)])
    read = {id(leaf) for a in args for leaf in tree_leaves(a)} & live
    return out, counter.get_total_flops(), read


def ring_wire_bytes(kind: str, payload_b: int, n: int) -> float:
    """The ring model's wire bytes a device of one collective over n
    ranks (the reference's `collective_bytes_per_device` rule, on its
    result bytes S): an all-reduce's payload is S, 2*S*(n-1)/n; an
    all-gather's payload is its input, S = n times it, S*(n-1)/n; a
    reduce-scatter's payload is its input, n times its result S,
    S*(n-1); a broadcast's payload is S, S*(n-1)/n (each of the n-1
    receivers takes S once, averaged over the n devices)."""
    if kind == "all-reduce":
        return 2.0 * payload_b * (n - 1) / n
    if kind == "all-gather":
        size = payload_b * n
        return size * (n - 1) / n
    if kind == "reduce-scatter":
        size = payload_b // n
        return float(size) * (n - 1)
    if kind == "broadcast":
        return payload_b * (n - 1) / n
    raise ValueError(f"no ring rule for {kind!r}")


def collective_fields(calls) -> Dict[str, Any]:
    """The record's collective fields from `core.mesh.
    record_collectives`' calls."""
    counts = {k: 0 for k in KINDS}
    by_kind = {k: 0.0 for k in KINDS}
    calls_by_axis: Dict[str, int] = {}
    payload_by_axis: Dict[str, int] = {}
    for c in calls:
        counts[c["kind"]] += 1
        by_kind[c["kind"]] += ring_wire_bytes(c["kind"], c["payload_b"],
                                              c["n"])
        calls_by_axis[c["axes"]] = calls_by_axis.get(c["axes"], 0) + 1
        payload_by_axis[c["axes"]] = payload_by_axis.get(c["axes"], 0) \
            + c["payload_b"]
    return {"collective_bytes_per_device": sum(by_kind.values()),
            "collective_by_kind": by_kind, "collective_counts": counts,
            "collective_calls_by_axis": calls_by_axis,
            "collective_payload_b_by_axis": payload_by_axis}


@contextlib.contextmanager
def fake_ranks(world: int, rank: int = 0):
    """A `"fake"` default process group of `world` ranks, this process
    `rank`, destroyed on exit with the sub-groups made for it
    (`core.mesh.forget_groups`).  ValueError where a process group is
    already initialised: it is never replaced."""
    if dist.is_available() and dist.is_initialized():
        raise ValueError("a process group is already initialised; the rank "
                         "trace makes a fake one of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
        core_mesh.forget_groups()


def rank_steps(cfg, kind: str, mesh: Mesh, batch, *, ctx_len: int = 0,
               optimizer: str = "adamw", compress: bool = False,
               device=META):
    """(the step, its arguments, whether it trains) of `kind` ("train",
    "prefill", "decode") as this rank of `mesh` runs it: `batch` the
    global batch (decode: {"tokens": [B, 1]}, against caches of `ctx_len`
    positions), `cfg` as it is (the serving dtype is the caller's).  The
    state, params and caches are this rank's blocks (`steps.cut` of the
    state's specs, `serve.place_params`, `rank_cache_pspecs`) of whole
    trees on `device`: meta tensors, or on a real device seed 0's draws
    and zero caches."""
    real = torch.device(device).type != "meta"
    if kind == "train":
        step_fn, _, opt = make_train_step(cfg, mesh, optimizer_name=optimizer,
                                          compress=compress)
        specs, shapes = state_pspecs(cfg, opt, mesh, compress)
        if real:
            shapes = make_train_state(0, cfg, opt, device=device)
            if compress:
                shapes["errors"] = init_errors(shapes["params"])
        return step_fn, (cut(shapes, specs, mesh), batch), True
    params = (init_params(0, cfg, device=device) if real
              else abstract_params(cfg))
    params = place_params(params, mesh, cfg.family)
    if kind == "prefill":
        return _in_mesh(make_prefill_step(cfg), mesh), (params, batch), \
            False
    tokens = batch["tokens"]
    whole = abstract_caches(cfg, tokens.shape[0], ctx_len)
    if real:
        whole = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                               device=device), whole)
    caches = cut(whole, shd.rank_cache_pspecs(mesh, whole), mesh)
    pos = torch.zeros((tokens.shape[0],), dtype=torch.int32, device=device)
    return _in_mesh(make_decode_step(cfg, ctx_len), mesh), \
        (params, tokens, caches, pos), False


def _in_mesh(fn, mesh):
    def run(*args):
        with mesh:
            return fn(*args)
    return run


def step_memory(fn, args, *, train: bool, device=META) -> Dict[str, Any]:
    """`LiveBytes.fields` of one run of `fn(*args)` on `device` (meta, or a
    real device's tensors for a check of the meta trace), each argument
    in a storage of its own (`own_storages`), with autograd on where
    `train`."""
    args = own_storages(args)
    live = LiveBytes(args, device)
    with live, (torch.enable_grad() if train else torch.no_grad()):
        fn(*args)
    return live.fields()


def host_trace(cfg, batch, *, optimizer: str = "adamw",
               donate: bool = False) -> Dict[str, Any]:
    """`step_memory` of one training step as one process runs it (`train
    --mesh host`: `make_train_step` over the 1 x 1 host mesh, inside it),
    on meta tensors: the whole state of `cfg` and `batch` (meta tensors
    of the trainer's batch)."""
    mesh = make_host_mesh(devices=[META])
    step_fn, _, opt = make_train_step(cfg, mesh, optimizer_name=optimizer,
                                      donate=donate)
    return step_memory(_in_mesh(step_fn, mesh),
                       (abstract_train_state(cfg, opt), batch), train=True)


def rank_trace(cfg, kind: str, shape, axis_names, batch, *,
               ctx_len: int = 0, optimizer: str = "adamw",
               compress: bool = False, rank: int = 0,
               flops: bool = True) -> Dict[str, Any]:
    """One step of `kind` as rank `rank` of a mesh of `shape` x
    `axis_names` runs it, on meta tensors under a fake process group of
    that many ranks (`fake_ranks`): `rank_steps`' step and arguments,
    each argument in a storage of its own (`own_storages`).  Returns
    `collective_fields` of every collective the step ran,
    `LiveBytes.fields`, "flops_per_device" (with
    `flops`: the counter costs about as much as the step) and
    "rank_trace_s".  Any mesh: the production cells' and the legs a card
    runs over 2 or 4 ranks alike."""
    t0 = time.time()
    world = math.prod(shape)
    with fake_ranks(world, rank):
        # the mesh `launch.mesh.make_production_mesh` makes under ranks
        # (for a production cell: its PRODUCTION_MESHES shape), its
        # devices meta
        mesh = core_mesh.make_rank_mesh(tuple(shape), tuple(axis_names),
                                        [META] * world)
        fn, args, train = rank_steps(cfg, kind, mesh, batch,
                                     ctx_len=ctx_len, optimizer=optimizer,
                                     compress=compress)
        args = own_storages(args)
        counter = FlopCounterMode(display=False) if flops else None
        live = LiveBytes(args, META)
        with core_mesh.record_collectives() as calls, \
                (counter or contextlib.nullcontext()), live, \
                (torch.enable_grad() if train else torch.no_grad()):
            fn(*args)
    out = {**collective_fields(calls), **live.fields(),
           "rank_trace_s": round(time.time() - t0, 2)}
    if flops:
        out["flops_per_device"] = float(counter.get_total_flops())
    return out


def cell_rank_trace(cfg, shape_name: str, mesh_kind: str, *,
                    optimizer: str, compress: bool = False
                    ) -> Dict[str, Any]:
    """`rank_trace` of a cell as rank 0 of its production mesh: the cell's
    config (serving: `build_cell`'s bfloat16 serving config), its global
    batch, its decode caches of the shape's length."""
    sh = SHAPES[shape_name]
    if sh.kind != "train":
        cfg = cfg.replace(param_dtype="bfloat16", remat=False)
    return rank_trace(cfg, sh.kind, *PRODUCTION_MESHES[mesh_kind],
                      input_specs(cfg, shape_name), ctx_len=sh.seq_len,
                      optimizer=optimizer, compress=compress)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             optimizer=None, compress=False, zero1=True, variant="base",
             cfg_overrides=None) -> dict:
    optimizer = optimizer or ARCH_OPTIMIZER.get(arch, "adamw")
    mesh = production_mesh(mesh_kind)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "variant": variant, "optimizer": optimizer,
           "devices": mesh.devices.size, "status": "ok",
           "compress": compress, "zero1": zero1}
    if cfg_overrides:
        rec["cfg_overrides"] = cfg_overrides
    t0 = time.time()
    try:
        cfg = get_config(arch)
        if cfg_overrides:
            cfg = cfg.replace(**cfg_overrides)
        cell, args = build_cell(cfg, shape_name, mesh, optimizer=optimizer,
                                compress=compress, zero1=zero1)
        out, flops, read = run_meta(cell, args)
        rec["lower_s"] = round(time.time() - t0, 2)
        rec["mem_argument_b"] = device_bytes(args, cell.in_shardings, read)
        rec["mem_output_b"] = device_bytes(out, cell.out_shardings)
        rec["flops_global"] = float(flops)
        rec["model_flops_global"] = model_flops(cfg, shape_name)
        rec["param_count"] = cfg.param_count()
        rec["active_param_count"] = cfg.active_param_count()
        print(f"memory per device: arguments {rec['mem_argument_b']:,} B, "
              f"outputs {rec['mem_output_b']:,} B; flops (global) "
              f"{flops:.3e}")
        if not zero1:
            # the rank path cuts the moments over the data axes always
            rec["rank_trace"] = "not run: the ranks' moments are ZeRO-1's"
            # the reference's key for memory it could not read
            rec["mem_note"] = ("mem_temp_b and mem_peak_b not traced: "
                               "they come from the rank trace")
        else:
            rec.update(cell_rank_trace(cfg, shape_name, mesh_kind,
                                       optimizer=optimizer,
                                       compress=compress))
            # the reference's identity (XLA's peak is its arguments and
            # its temporaries)
            rec["mem_peak_b"] = rec["mem_argument_b"] + rec["mem_temp_b"]
            print(f"rank 0: {rec['collective_calls_by_axis']} calls, "
                  f"{rec['collective_bytes_per_device']:.3e} wire B, "
                  f"flops {rec['flops_per_device']:.3e}, temp "
                  f"{rec['mem_temp_b']:,} B, peak {rec['mem_peak_b']:,} B")
    except Exception as e:  # noqa: BLE001 -- record the failure, don't die
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def all_cells():
    for arch in ARCHS:
        if arch == "drim-bnn":
            continue  # paper-app config, not an assigned cell
        cfg = get_config(arch)
        for shape_name in shapes_for(cfg):
            for mesh_kind in ("single", "multi"):
                yield arch, shape_name, mesh_kind


def parse_overrides(items) -> dict:
    """`field=value` pairs, each value JSON where it parses (the
    reference's `--override`)."""
    overrides = {}
    for ov in items:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--optimizer")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field=value overrides (e.g. bitlinear=ffn)")
    args = ap.parse_args(argv)

    done = set()
    if os.path.exists(args.out) and not args.force:
        for line in open(args.out):
            try:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh"], r["variant"]))
            except json.JSONDecodeError:
                pass

    overrides = parse_overrides(args.override)
    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape, args.mesh)])
    failures = 0
    for arch, shape_name, mesh_kind in cells:
        key = (arch, shape_name, mesh_kind, args.variant)
        if key in done:
            print(f"skip {key} (cached)")
            continue
        print(f"=== {arch} x {shape_name} x {mesh_kind} "
              f"[{args.variant}] ===", flush=True)
        rec = run_cell(arch, shape_name, mesh_kind,
                       optimizer=args.optimizer, compress=args.compress,
                       zero1=not args.no_zero1, variant=args.variant,
                       cfg_overrides=overrides or None)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps({k: rec[k] for k in ("status", "lower_s")
                          if k in rec}), flush=True)
        if rec["status"] != "ok":
            failures += 1
            print(rec.get("error", ""), file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
