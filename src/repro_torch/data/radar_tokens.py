"""Radar → token pipeline: LM data straight out of the DataTree.

The port's own copy of the reference package's ``data/radar_tokens.py``
(numpy only, over the port's :class:`~repro_torch.store.Session`), so
both packages draw bitwise-equal token batches from one archive.

The paper's closing claim is "AI-ready weather infrastructure"; this module
is that claim made concrete.  Reflectivity fields stream out of the
Icechunk store chunk-aligned (time-chunk granular reads — the same partial
-read primitive behind the QVP speedups), are quantized to a small vocab,
and become next-token-prediction sequences:

    token = quantize(DBZH[t, az, gate])         # 1 dBZ-bin per gate
    sequence = [BOS, scan t ray 0, ray 1, ...]  # raster order per scan

Determinism: (snapshot, seed, step) fully determine every batch, so a
restarted run replays identical data — the training-loop face of the
paper's §5.4 bitwise-reproducibility property.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..store import Session

DBZ_MIN, DBZ_MAX = -32.0, 64.0


@dataclass(frozen=True)
class TokenizerSpec:
    """Reflectivity-to-token quantization spec (dBZ bins plus specials)."""
    vocab_size: int = 256            # dBZ bins + specials
    n_special: int = 2               # 0 = PAD, 1 = BOS

    @property
    def n_bins(self) -> int:
        return self.vocab_size - self.n_special

    def encode(self, dbz: np.ndarray) -> np.ndarray:
        x = np.nan_to_num(np.asarray(dbz, np.float32), nan=DBZ_MIN)
        x = np.clip((x - DBZ_MIN) / (DBZ_MAX - DBZ_MIN), 0.0, 1.0)
        return (x * (self.n_bins - 1)).astype(np.int32) + self.n_special

    def decode(self, tokens: np.ndarray) -> np.ndarray:
        t = np.maximum(np.asarray(tokens, np.int32) - self.n_special, 0)
        return t / (self.n_bins - 1) * (DBZ_MAX - DBZ_MIN) + DBZ_MIN


class RadarTokenDataset:
    """Deterministic, shardable token batches from an archive session.

    Each example is one radar scan's reflectivity raster (subsampled to
    ``seq_len`` gates).  ``host_id``/``n_hosts`` split the scan index space
    for multi-host input pipelines — each host reads only the time chunks
    under its shard (chunk-aligned, no overlap).
    """

    def __init__(
        self,
        session: Session,
        *,
        vcp: str,
        sweep: int = 0,
        moment: str = "DBZH",
        seq_len: int = 1024,
        tokenizer: Optional[TokenizerSpec] = None,
        host_id: int = 0,
        n_hosts: int = 1,
    ):
        self.session = session
        self.array = session.array(f"{vcp}/sweep_{sweep}/{moment}")
        self.times = session.array(f"{vcp}/time").read()
        self.seq_len = seq_len
        self.tok = tokenizer or TokenizerSpec()
        self.host_id, self.n_hosts = host_id, n_hosts
        self.n_scans = self.array.shape[0]
        n_az, n_gates = self.array.shape[1], self.array.shape[2]
        # raster subsample: fixed stride over (az, range) to seq_len gates
        total = n_az * n_gates
        self.flat_idx = np.linspace(0, total - 1, seq_len).astype(np.int64)
        self._az = self.flat_idx // n_gates
        self._gate = self.flat_idx % n_gates

    def scan_tokens(self, scan: int) -> np.ndarray:
        field = self.array[scan]                  # one time-chunk-aligned read
        vals = field[self._az, self._gate]
        toks = self.tok.encode(vals)
        toks[0] = 1                               # BOS
        return toks

    def batches(self, batch: int, *, seed: int = 0,
                start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite deterministic stream; resume with ``start_step``."""
        step = start_step
        while True:
            rng = np.random.default_rng((seed, step))
            scans = rng.integers(0, self.n_scans, size=batch)
            scans = scans[self.host_id::self.n_hosts]
            toks = np.stack([self.scan_tokens(int(s)) for s in scans])
            yield {
                "tokens": toks,
                "targets": np.roll(toks, -1, axis=-1),
                "step": np.int64(step),
            }
            step += 1
