"""Real multi-host backend: jax.distributed + ('host', 'chip') mesh.

The device mapping of the reference's cross-worker scheduling
(reference: src/core/threads.cpp:100-159, SURVEY §5.8): across hosts the
picture-dependency DAG factors into independent closed GOPs
(parallel/hosts.split_gops), so the network never carries reference planes —
each host decodes its assigned GOPs entirely host-local and only display-
order bookkeeping crosses hosts.  Inside a host, the per-host decoder uses
the normal single/multi-card paths (GOP-chunk scan, mesh="rows",
decode_batch over local cards).

``MultiHostDecoder`` (parallel/hosts.py) remains the in-process simulation
harness (worker processes, core pinning); this module is the production
skeleton: ``jax.distributed.initialize``-based init so every process sees
the global device set, rank-derived GOP assignment, and host-local frame
delivery.  CI exercises it as two coordinated CPU processes
(tests/test_multihost.py::test_jax_distributed_two_process_decode).
"""
from __future__ import annotations

import os
from typing import List, Optional

from .hosts import split_gops


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize the jax.distributed runtime for this host.

    Pass the three arguments explicitly (coordinator = "host0:port");
    without them ``jax.distributed.initialize`` fails unless the cluster
    environment supplies them."""
    import jax
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def host_chip_mesh(axes=("host", "chip")):
    """Global ('host', 'chip') mesh: rows = processes, columns = that
    process's local devices.  Collectives along "chip" ride the links
    between a host's cards; along "host" they cross the network —
    shardings in this package only ever communicate along "chip" (GOPs
    are host-independent)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    procs = jax.process_count()
    all_devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    per_host = len(all_devs) // procs
    grid = np.array(all_devs).reshape(procs, per_host)
    return Mesh(grid, axes)


class DistributedDecoder:
    """Rank-r host of a jax.distributed world decoding one elementary
    stream: GOP chunk i belongs to host (i mod world).  ``decode`` returns
    this host's frames as (chunk_index, [frame bytes...]) pairs — frames
    stay host-local (the serving pattern: each host feeds its own
    downstream consumers); a display-order merge across hosts is a
    metadata-only exchange (chunk index -> rank is deterministic, so every
    host already knows the global order)."""

    def __init__(self, config=None, decoder_cls=None):
        import jax
        from ..runtime.decoder import DecoderConfig, MP2VDecoder
        self.rank = jax.process_index()
        self.world = jax.process_count()
        cls = decoder_cls or MP2VDecoder
        self.dec = cls(config or DecoderConfig())

    def my_chunks(self, data: bytes):
        return [c for c in split_gops(data) if c.index % self.world == self.rank]

    def decode(self, data: bytes) -> List[tuple]:
        out = []
        for c in self.my_chunks(data):
            self.dec.reset()
            frames = self.dec.decode(c.data)
            out.append((c.index, [f.tobytes() for f in frames]))
        return out


def merge_display_order(per_host_results: List[List[tuple]]) -> List[bytes]:
    """Deterministic display-order merge of every host's (chunk_index,
    frames) pairs (chunk indices are globally unique and ordered)."""
    by_index = {}
    for host in per_host_results:
        for idx, frames in host:
            by_index[idx] = frames
    out: List[bytes] = []
    for idx in sorted(by_index):
        out.extend(by_index[idx])
    return out
