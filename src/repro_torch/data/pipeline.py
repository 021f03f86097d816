"""Data pipeline: deterministic synthetic corpus + memmap token shards.

The port's own copy of `repro.data.pipeline` (numpy only): the same
(seed, step) gives the same arrays in both packages.  The trainer turns
them into tensors on its device.

Production layout: each host reads only its slice of the global batch
(`host_batch_slice`), double-buffered with a background prefetch thread.
Two sources:

  * SyntheticLM  — seeded zipfian token stream (self-contained; CI and the
    end-to-end examples use this).  Deterministic in (seed, step) so an
    elastic restart resumes the exact stream.
  * MemmapLM     — flat uint32 token file (np.memmap), sharded striding.

Both emit {"tokens": [B, S], "labels": [B, S]} with labels = next-token
shift; family extras (vlm patch embeds / audio frames) are attached by
`attach_modality_stub`, which stands in for those families' frontends
(for the dense family it adds nothing).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLM:
    """Seeded zipfian LM stream; deterministic per (seed, step, host)."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0, zipf_a: float = 1.2):
        self.v, self.s, self.b = vocab_size, seq_len, batch
        self.seed, self.a = seed, zipf_a
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** -zipf_a
        self._p = (p / p.sum()).astype(np.float64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(self.v, size=(self.b, self.s + 1), p=self._p)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapLM:
    """Flat uint32 token file; host h of H reads rows h::H."""

    def __init__(self, path: str, seq_len: int, batch: int,
                 host_id: int = 0, n_hosts: int = 1, seed: int = 0):
        self.data = np.memmap(path, dtype=np.uint32, mode="r")
        self.s, self.b = seq_len, batch
        self.host_id, self.n_hosts = host_id, n_hosts
        self.n_seqs = len(self.data) // (seq_len + 1)
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step, self.host_id))
        idx = rng.integers(0, self.n_seqs, self.b)
        rows = np.stack([self.data[i * (self.s + 1):(i + 1) * (self.s + 1)]
                         for i in idx]).astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def attach_modality_stub(batch: Dict[str, np.ndarray], cfg,
                         seed: int = 0) -> Dict[str, np.ndarray]:
    """[audio]/[vlm] frontends are stubs: attach precomputed frame/patch
    embeddings (nothing for the other families)."""
    rng = np.random.default_rng(seed)
    b = batch["tokens"].shape[0]
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    elif cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


class Prefetcher:
    """Background-thread double buffering (overlap host data with step)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self._it:
            if self._stop.is_set():
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass


def host_batch_slice(global_batch: int, host_id: int, n_hosts: int) -> int:
    assert global_batch % n_hosts == 0
    return global_batch // n_hosts
