"""Continuous-batching request scheduler: concurrent decode requests
packed into shared waves over a fixed KV-cache slot pool (port of
`repro.launch.batching`).

  * an arriving request is PREFILLED at batch 1, its cache spliced into a
    free slot (`insert_request` ZEROES the slot first -- decode cache
    writes are additive one-hot updates, so a reused slot must never keep
    a previous tenant's K/V), and its first token comes from the prefill
    logits;
  * every wave runs ONE shared decode step over all slots -- a late
    arrival joins the NEXT wave instead of launching its own decode
    stream;
  * positions advance per request; a finished request frees its slot at
    the wave boundary and the slot is re-admitted from the pending queue
    on the very next wave.

The decode function comes from `make_decode_fn`, which `launch.serve`
uses for its static loop too: the native route for the "gpu" engine, the
DRIM fleet under `layers.serving_engine` for a registry engine.

Over a mesh of ranks (built inside `with mesh:`) every rank runs the same
waves in lockstep: the same arrivals, slots and sampling keys.  An
arriving request's batch-1 prefill runs on every rank with its blocks of
the params (replicated over the data axes, which do not divide one row);
only the ranks whose rows hold the slot splice it in
(`insert_rank_request`: under a model axis at their sequence block of the
K/V cache, the SSM states on their heads); decode runs each rank's rows
and gives every rank the whole logits, so every rank books the same
tokens.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.mesh import (PartitionSpec, ambient_ranks, dp_axes,
                                   local_block, mesh_all_gather, model_coord,
                                   model_ranks, sanitize_spec)
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, empty_caches, prefill
from repro_torch.models.layers import serving_engine
from repro_torch.runtime import telemetry
from repro_torch.runtime.sharding import _path_str, is_cross_cache
from repro_torch.tree import tree_map_with_path

NATIVE_ENGINE = "gpu"


def fold_in(seed: int, i: int) -> int:
    """A sampling seed derived from (seed, i), as `jax.random.fold_in`
    derives a key."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


def sample_tokens(logits: torch.Tensor, temperature: float,
                  key: int) -> torch.Tensor:
    """logits [B, 1, V] -> next tokens [B, 1] (int64): greedy at
    temperature 0, else drawn from softmax(logits / temperature) with a
    CPU generator seeded by `key`."""
    lg = logits[:, -1, :]
    if temperature > 0:
        probs = torch.softmax(lg.to(torch.float32) / temperature, -1).cpu()
        gen = torch.Generator().manual_seed(key)
        nxt = torch.multinomial(probs, 1, generator=gen)[:, 0].to(lg.device)
    else:
        nxt = lg.argmax(-1)
    return nxt[:, None]


def make_decode_fn(cfg, ctx_len: int, temperature: float = 0.0,
                   engine: Optional[str] = None,
                   n_queues: Optional[int] = None) -> Callable:
    """(params, tok [B,1], caches, pos [B], key) -> (next_tok [B,1], caches).

    `ctx_len` is the caches' length (it sets the hybrid's attention
    window).  engine None or "gpu": the native route (the packed-kernel
    or dense BitLinear GEMMs on the params' device).  A registry engine
    ("resident", "cuda"): the same decode step inside `serving_engine`,
    so BitLinear GEMMs run on the simulated DRIM fleet (`n_queues`: the
    "queued" engine's queue count)."""
    drim = engine if engine not in (None, NATIVE_ENGINE) else None
    if drim is not None:
        from repro_torch.pim.compiler import get_engine
        get_engine(drim)                   # fail fast on unknown names

    def dec(p, tok, caches, pos, key):
        with serving_engine(drim, n_queues=n_queues):
            lg, caches = decode_step(p, cfg, tok, caches, pos, ctx_len)
        return sample_tokens(lg, temperature, key), caches
    return dec


def insert_request(caches, pre_caches, slot: int):
    """Splice one request's batch-1 prefill caches into `slot` of the
    batched decode caches, ZEROING the slot's previous contents first.

    Caches are stacked [L, batch, ...] trees (layer axis 0, batch axis 1;
    a None subtree stays None); any leaf that cannot insert raises a
    shape-mismatch error naming the cache path (the hybrid's [G, per,
    batch, ...] groups among them, as in the reference)."""
    return _insert(caches, pre_caches, slot, lambda path, one: one)


def insert_rank_request(caches, pre_caches, slot: int, s_pre: int,
                        s_ctx: int):
    """`insert_request` into the local `slot` of this rank's block of the
    caches: under a model axis over ranks the K/V and MLA latent leaves
    are the rank's sequence blocks of an `s_pre`-long prefill cache and
    an `s_ctx`-long decode cache (`sequence_block`), every other leaf its
    block as it is; `insert_request` itself without one.  Every rank of
    the slot's model group calls it."""
    mesh = model_ranks()

    def own(path, one):
        name = _path_str(path)
        if mesh is None or is_cross_cache(name) \
                or name.split("/")[-1] not in ("k", "v", "ckv", "k_rope"):
            return one
        return sequence_block(one, s_pre, s_ctx, mesh, 2)
    return _insert(caches, pre_caches, slot, own)


def _insert(caches, pre_caches, slot: int, own):
    def ins(path, full, one):
        one = own(path, one)
        if (full.dim() != one.dim() or full.dim() < 2 or one.shape[1] != 1
                or any(o > f for o, f in zip(one.shape, full.shape))):
            raise ValueError(
                f"cache insert mismatch at {path}: prefill leaf "
                f"{tuple(one.shape)} cannot insert into {tuple(full.shape)} "
                "(expected stacked [L, batch, ...] caches, batch axis 1, "
                "and a batch-1 prefill)")
        out = full.clone()
        out[:, slot] = 0
        out[(slice(None), slot) + tuple(slice(0, n) for n in one.shape[2:])] \
            = one[:, 0].to(full.dtype)
        return out

    return tree_map_with_path(ins, caches, pre_caches)


def sequence_block(pre: torch.Tensor, s_pre: int, s_ctx: int, mesh,
                   dim: int) -> torch.Tensor:
    """The prompt positions that this rank's block of an `s_ctx`-long
    decode cache holds (dim `dim`, a block of s_ctx / |model|, or all of
    it where the model axis does not divide s_ctx), from its block `pre`
    of an `s_pre`-long prefill cache (likewise cut, or whole): the
    prefill's blocks gathered over the model group where they are cut,
    then the rank's positions, fewer or none past the prompt."""
    index, m = model_coord(mesh)
    if s_pre % m == 0:
        pre = mesh_all_gather(pre, mesh, ("model",), dim)
    length = s_ctx // m if s_ctx % m == 0 else s_ctx
    lo = min(index * length if s_ctx % m == 0 else 0, s_pre)
    return pre.narrow(dim, lo, min(lo + length, s_pre) - lo)


def slot_block(n_slots: int, mesh) -> range:
    """The slots whose rows this rank holds (cut over the data axes as a
    batch of `n_slots` rows is, or all of them where the axes do not
    divide it)."""
    sl = local_block((n_slots,), sanitize_spec(
        PartitionSpec(dp_axes(mesh)), (n_slots,), mesh), mesh)[0]
    return range(sl.start, sl.stop)


@dataclasses.dataclass
class Request:
    """One decode request: prompt tokens plus generation budget."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_wave: int


class WaveBatcher:
    """Fixed slot pool + shared decode waves + per-request accounting.

    `submit()` enqueues a request (arrival_wave defaults to "now");
    `run_wave()` admits eligible pending requests into free slots
    (prefill + zeroed-slot insert), then runs ONE decode step over all
    slots; `run()` loops until every request finished.  The `wave_log`
    records admissions, decoded request ids, per-request positions and
    occupancy per wave.  The pool lives on `device` (None: the card);
    inside a mesh of ranks it is the rank's block of it (see the module
    docstring).  The hybrid family's caches nest differently ([G, per,
    batch, ...]) and the audio family's prefill needs frames, so both are
    refused, as the reference refuses them.
    """

    def __init__(self, cfg, params, *, n_slots: int, ctx_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 engine: Optional[str] = None,
                 n_queues: Optional[int] = None, device=None) -> None:
        if cfg.family not in ("dense", "vlm", "moe", "ssm"):
            raise NotImplementedError(
                "continuous batching needs stacked [L, batch, ...] "
                f"caches; family {cfg.family!r} nests differently")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.ctx_len = ctx_len
        self.temperature = temperature
        self._keys = np.random.default_rng(seed)
        self._decode = make_decode_fn(cfg, ctx_len, temperature, engine,
                                      n_queues)
        self.caches = empty_caches(cfg, n_slots, ctx_len, device=self.device)
        ranks = ambient_ranks()
        self._slots = (range(n_slots) if ranks is None
                       else slot_block(n_slots, ranks))
        self.wave = 0
        self.wave_log: List[Dict[str, Any]] = []
        self.results: Dict[int, List[int]] = {}
        self._pending: Deque[Request] = collections.deque()
        self._next_rid = 0
        # per-slot state; rid -1 marks a free slot
        self._slot_rid = [-1] * n_slots
        self._slot_pos = np.zeros(n_slots, np.int64)
        self._slot_last = np.zeros(n_slots, np.int64)
        self._slot_remaining = [0] * n_slots

    def _key(self) -> int:
        return int(self._keys.integers(0, 2**62))

    # -- request intake ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               arrival_wave: Optional[int] = None) -> int:
        """Enqueue a request; returns its rid.  It joins the first wave
        >= arrival_wave (default: the next wave to run) with a free slot
        -- never a private decode stream."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) + max_new_tokens - 1 > self.ctx_len:
            raise ValueError(
                f"request needs {len(prompt) + max_new_tokens - 1} cache "
                f"positions, ctx_len is {self.ctx_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
            arrival_wave=self.wave if arrival_wave is None
            else int(arrival_wave)))
        self.results[rid] = []
        return rid

    @property
    def done(self) -> bool:
        return not self._pending and all(r < 0 for r in self._slot_rid)

    # -- wave loop ---------------------------------------------------------
    def _admit(self, req: Request, slot: int) -> None:
        toks = torch.as_tensor(req.prompt, device=self.device)[None, :]
        logits, pre = prefill(self.params, self.cfg, {"tokens": toks})
        if slot in self._slots:
            self.caches = insert_rank_request(
                self.caches, pre, slot - self._slots.start, len(req.prompt),
                self.ctx_len)
        first = int(sample_tokens(logits, self.temperature, self._key())[0])
        self.results[req.rid].append(first)
        if req.max_new_tokens == 1:
            return                       # done at admission, slot stays free
        self._slot_rid[slot] = req.rid
        self._slot_pos[slot] = len(req.prompt)
        self._slot_last[slot] = first
        self._slot_remaining[slot] = req.max_new_tokens - 1

    def _admit_pending(self) -> List[int]:
        admitted: List[int] = []
        still: Deque[Request] = collections.deque()
        while self._pending:
            req = self._pending.popleft()
            free = next((s for s in range(self.n_slots)
                         if self._slot_rid[s] < 0), None)
            if req.arrival_wave > self.wave or free is None:
                still.append(req)
                continue
            self._admit(req, free)
            admitted.append(req.rid)
        self._pending = still
        return admitted

    def run_wave(self) -> Dict[str, Any]:
        """Admit eligible arrivals, then one shared decode step over all
        slots; returns (and logs) the wave record."""
        admitted = self._admit_pending()
        active = [s for s in range(self.n_slots) if self._slot_rid[s] >= 0]
        record = {
            "wave": self.wave,
            "admitted": admitted,
            "decoded": [self._slot_rid[s] for s in active],
            "positions": {self._slot_rid[s]: int(self._slot_pos[s])
                          for s in active},
            "n_active": len(active),
        }
        if active:
            tok = torch.as_tensor(self._slot_last, device=self.device)[:, None]
            pos = torch.as_tensor(self._slot_pos, device=self.device)
            with telemetry.span("batch:wave", cat="serve", tid="serve",
                                wave=self.wave, n_active=len(active),
                                admitted=len(admitted)):
                nxt, self.caches = self._decode(self.params, tok,
                                                self.caches, pos, self._key())
                nxt = nxt.reshape(-1).cpu().numpy()
            for s in active:
                rid = self._slot_rid[s]
                self.results[rid].append(int(nxt[s]))
                self._slot_last[s] = nxt[s]
                self._slot_pos[s] += 1
                self._slot_remaining[s] -= 1
                if self._slot_remaining[s] == 0:
                    self._slot_rid[s] = -1          # freed for next wave
        self.wave += 1
        self.wave_log.append(record)
        return record

    def run(self, max_waves: int = 100_000) -> Dict[int, np.ndarray]:
        """Drive waves until every submitted request completed; returns
        {rid: generated token ids} (first token from prefill logits)."""
        while not self.done:
            if self.wave >= max_waves:
                raise RuntimeError(
                    f"batcher did not drain in {max_waves} waves")
            self.run_wave()
        return {rid: np.asarray(toks, np.int64)
                for rid, toks in self.results.items()}
