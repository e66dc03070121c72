"""Deterministic, resumable, host-sharded data pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy only): batches are
bitwise the reference's for the same config and step.

Counter-based generation (numpy Philox keyed on (seed, step)) makes every
batch a pure function of the step index: resume = set the step counter; no
iterator state to snapshot beyond one integer, and every host materializes
only its shard.  Two sources:

  * ``synthetic``: random tokens (throughput benchmarking) or learnable
    arithmetic-progression sequences (loss goes down -> e2e demos).
  * ``memmap``: packed token file (np.memmap), contiguous chunks indexed by
    a step-keyed permutation -- the production path for real corpora.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"  # synthetic | arith | memmap
    path: Optional[str] = None  # for memmap
    n_hosts: int = 1
    host_id: int = 0


class Dataset:
    """step -> host-local {tokens, labels} (int32 [B_local, S])."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self._mm = None
        if cfg.kind == "memmap":
            assert cfg.path, "memmap dataset needs a token file"
            self._mm = np.memmap(cfg.path, dtype=np.uint16, mode="r")
            self._n_chunks = (len(self._mm) - 1) // cfg.seq_len

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        lo = cfg.host_id * self.local_batch
        hi = lo + self.local_batch
        if cfg.kind == "memmap":
            rng = np.random.Generator(np.random.Philox(key=[cfg.seed, step]))
            idx = rng.integers(0, self._n_chunks, size=cfg.global_batch)[lo:hi]
            rows = np.stack(
                [self._mm[i * cfg.seq_len : i * cfg.seq_len + cfg.seq_len + 1] for i in idx]
            ).astype(np.int64)
        elif cfg.kind == "arith":
            rng = np.random.Generator(np.random.Philox(key=[cfg.seed, step]))
            a = rng.integers(0, cfg.vocab, size=(cfg.global_batch, 1))[lo:hi]
            b = rng.integers(1, 17, size=(cfg.global_batch, 1))[lo:hi]
            i = np.arange(cfg.seq_len + 1)[None, :]
            rows = (a + b * i) % cfg.vocab
        else:
            rng = np.random.Generator(np.random.Philox(key=[cfg.seed, step]))
            rows = rng.integers(
                0, cfg.vocab, size=(cfg.global_batch, cfg.seq_len + 1)
            )[lo:hi]
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
        }

    def state(self, step: int) -> dict:
        return {"step": int(step), "seed": self.cfg.seed, "kind": self.cfg.kind}

    @staticmethod
    def resume_step(state: dict) -> int:
        return int(state["step"])
