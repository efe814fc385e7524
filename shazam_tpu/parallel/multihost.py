"""Multi-host catalog spanning: song shards across processes over the
network between hosts.

The reference's only scale-out knob was an Elasticsearch shard count it
pinned to 1 (``elastic_database.py:42,80``) — one external server, one
host. Here a catalog larger than one host's device memory spans
*processes*:

- ``init_multihost`` brings up ``jax.distributed`` (the JAX runtime's
  process-spanning rendezvous; collectives ride NVLink within a host
  and the network across hosts — on CPU test rigs, Gloo).
- ``SpannedCatalog`` places the by-song regime (``bigcatalog.py``) on a
  global mesh whose devices span every process. Each process
  materializes ONLY its own devices' song shards; the one collective per
  query is the tiny (topn x n_shards) candidate all_gather, which a
  cross-host hop absorbs easily (the histograms and binary searches are
  all shard-local).

Deterministic layout contract: global song s lives on shard
``s % n_shards`` as local id ``s // n_shards`` — every process derives
the same layout from the same catalog metadata, no coordination needed.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ..index.store import FingerprintIndex
from ..match.align import align_results, MatchResult
from ..match.prepare import QueryPairs
from ..index.search import build_head, stacked_head_bits
from .bigcatalog import (pack_shard_rows, shard_index_by_song,
                         sharded_match_by_song)


def init_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
) -> None:
    """Initialize the JAX distributed runtime for catalog spanning.

    :param coordinator_address: "host:port" of process 0.
    :param local_device_count: on CPU rigs, fake this many local devices
        per process (must be set before the backend initializes).
    """
    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={local_device_count}"
            ).strip()
    import jax

    # NB: must not touch the backend before initialize(); read the
    # *configured* platform rather than jax.default_backend(). CPU
    # collectives only where the CPU is named: an unset platform list
    # is the normal case on a GPU host, whose collectives go over NCCL.
    platforms = jax.config.jax_platforms or ""
    if "cpu" in platforms.split(","):
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass  # older jax: CPU collectives default works or raises later
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh():
    """One-axis mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), ("shard",))


class SpannedCatalog:
    """A by-song sharded catalog whose shards span host processes."""

    def __init__(self, index_meta, mesh=None):
        """index_meta: (n_songs, max_offset, offset_stride) — identical on
        every process (derived from the same catalog metadata)."""
        import jax

        self.mesh = mesh or global_mesh()
        self.n_songs, self.max_offset, self._stride = index_meta
        self.n_shards = self.mesh.devices.size
        self.n_local_songs = -(-max(self.n_songs, 1) // self.n_shards)
        self._arrays = None

    @classmethod
    def from_full_index(cls, index: FingerprintIndex, mesh=None):
        """Every process holds the full index (small catalogs / tests):
        each keeps only the rows of its own addressable shards."""
        cat = cls((index.n_songs, index.max_offset, index.offset_stride),
                  mesh=mesh)
        stacked, n_local, stride = shard_index_by_song(index, cat.n_shards)
        assert n_local == cat.n_local_songs and stride == cat._stride
        cat._place(stacked)
        return cat

    def _my_shard_ids(self) -> Sequence[int]:
        devs = list(self.mesh.devices.reshape(-1))
        import jax

        return [i for i, d in enumerate(devs) if d.process_index
                == jax.process_index()]

    def _place(self, stacked) -> None:
        """Build global arrays from full stacked (n_shards, rows) arrays."""
        mine = self._my_shard_ids()
        self._place_local(tuple(a[mine] for a in stacked))

    def _place_local(self, local_stacked) -> None:
        """Build global arrays from THIS process's shard rows only.

        local_stacked: (n_my_shards, rows) uint32 arrays, rows for my
        shard ids in ascending order — the distributed-ingest path, where
        no process ever holds the full index.
        """
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(self.mesh, P("shard", None))
        self._arrays = tuple(
            jax.make_array_from_process_local_data(
                sharding, np.ascontiguousarray(a),
                (self.n_shards,) + a.shape[1:],
            )
            for a in local_stacked
        )
        # per-shard bucket-CDF heads (exact search windows; hot hash
        # runs defeat the interpolation fallback) — computed shard-local
        # under jit, no cross-process data movement
        bits = stacked_head_bits(self._arrays[0].shape[1])
        if bits is not None:
            import functools

            fn = jax.jit(
                jax.vmap(functools.partial(build_head, bits=bits)),
                out_shardings=sharding,
            )
            self._head = fn(self._arrays[0])
        else:
            self._head = None

    # ---- persistence: per-process shard files -------------------------
    def save_local_shards(self, dir_path: str) -> str:
        """Write THIS process's shard rows + meta to one npz.

        A spanned catalog restarts from these files (same process/device
        topology) without refingerprinting anything.
        """
        import jax

        os.makedirs(dir_path, exist_ok=True)
        path = os.path.join(dir_path, f"shards_p{jax.process_index():03d}.npz")
        n_cols = len(self._arrays)
        cols = {}
        for c, a in enumerate(self._arrays):
            shards = sorted(a.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            cols[f"col{c}"] = np.concatenate(
                [np.asarray(s.data) for s in shards]
            )
        from ..utils.persist import atomic_savez

        atomic_savez(
            path,
            meta=np.array([self.n_songs, self.max_offset, self._stride,
                           self.n_shards, n_cols], np.int64),
            # WHICH global shard ids these rows belong to: a restart
            # whose process->shard assignment differs (permuted mesh,
            # reordered hosts) would otherwise serve every song under
            # the wrong global id with no error
            shard_ids=np.asarray(sorted(self._my_shard_ids()), np.int64),
            **cols,
        )
        return path

    @classmethod
    def load_local_shards(cls, dir_path: str, mesh=None) -> "SpannedCatalog":
        import jax

        path = os.path.join(dir_path, f"shards_p{jax.process_index():03d}.npz")
        with np.load(path) as z:
            meta = z["meta"]
            n_cols = int(meta[4])
            local = tuple(z[f"col{c}"] for c in range(n_cols))
            saved_ids = (z["shard_ids"].tolist()
                         if "shard_ids" in z.files else None)
        cat = cls((int(meta[0]), int(meta[1]), int(meta[2])), mesh=mesh)
        if cat.n_shards != int(meta[3]):
            raise ValueError(
                f"shard file was written for {int(meta[3])} shards, "
                f"mesh has {cat.n_shards}"
            )
        mine = sorted(cat._my_shard_ids())
        if saved_ids is not None and saved_ids != mine:
            # same shard COUNT but a different process->shard assignment:
            # placing these rows would serve every song under the wrong
            # global id (sid = local * n_shards + shard) silently
            raise ValueError(
                f"shard file holds global shards {saved_ids} but this "
                f"process owns {mine}: restart with the same process/"
                "device topology the catalog was saved under"
            )
        cat._place_local(local)
        return cat

    def _replicate(self, a: np.ndarray):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.make_array_from_process_local_data(
            NamedSharding(self.mesh, P()), np.asarray(a), a.shape
        )

    def match(self, q: QueryPairs, *, topn: int = 2,
              match_capacity: int = 65536, q_frames: Optional[int] = None,
              catalog=None, config=None) -> MatchResult:
        """Match prepared query pairs across every process's shards.

        ``q_frames`` defaults to the smallest power-of-two window
        covering the query's max frame offset (>= 1024): a fixed window
        silently drops votes with deltas below its floor on long clips
        (the reference handles any clip length, ``recognizer.py:289-338``).
        Pass it explicitly only to pin a compile shape.
        """
        from ..config import DEFAULT_CONFIG

        if q_frames is None:
            from ..match.prepare import q_frames_for_max_offset

            max_t = int(np.max(q.t[: q.n_pairs])) if q.n_pairs else 0
            q_frames = q_frames_for_max_offset(max_t)
        delta_min = -q_frames
        delta_range = self.max_offset + 2 * q_frames
        args = tuple(
            self._replicate(a)
            for a in (q.hi, q.lo, q.ex, q.t, q.valid, q.first)
        )
        import jax

        from .bigcatalog import effective_match_capacity

        cfg = config or DEFAULT_CONFIG
        cap, cap_max = match_capacity, cfg.match_capacity_max
        while True:
            raw = jax.device_get(sharded_match_by_song(
                self.mesh, self._arrays, self.n_local_songs, self._stride,
                *args,
                delta_min=delta_min, delta_range=delta_range,
                match_capacity=cap, topn=topn,
                sharded_head=self._head,
            ))
            total = int(raw.total_rows)
            # the by-song exactness bound is per-shard, so judge (and
            # escalate — hyper-common hashes own 10K-70K rows at
            # reference scale) against the effective n_shards * cap
            # bound; total is replicated, so every process takes the
            # same branch and the collective programs stay in lockstep
            eff = effective_match_capacity(cap, self.n_shards)
            if total <= eff or cap >= cap_max:
                break
            while effective_match_capacity(cap, self.n_shards) < total \
                    and cap < cap_max:
                cap *= 4
            cap = min(cap, cap_max)
        return align_results(raw, q.n_pairs, catalog=catalog,
                             config=cfg,
                             match_capacity=effective_match_capacity(
                                 cap, self.n_shards))


def distributed_ingest_arrays(
    song_names: Sequence[str],
    load_fn: Callable[[int], np.ndarray],
    config=None,
    mesh=None,
    batch_size: int = 8,
    song_peak_capacity: Optional[int] = None,
    chunk_songs: int = 32,
) -> Tuple["SpannedCatalog", "object"]:
    """Shard the *fingerprinting work itself* across host processes.

    Every process receives the same deterministic ``song_names`` list
    (global song id = list position); it decodes and fingerprints ONLY
    the songs whose round-robin shard (``s % n_shards``) lives on one of
    its own devices, in O(chunk) host memory, then places its shard rows
    directly on its devices.  No process ever materializes the full
    catalog — audio, fingerprints, or index.  The reference fingerprints
    on one host into one DB (``__init__.py:325-405``); this is that
    driver spanned over a pod.

    :param load_fn: global song id -> mono samples (int16/float32);
        called only for songs this process owns.

    Byte-identical duplicate AUDIO is deduped per-process only (the
    SHA-1 resume dedup sees one process's songs): two identical songs
    whose round-robin shards land on different processes ingest as two
    catalog entries, unlike single-host ``SIA.ingest_arrays`` where the
    second is skipped. Dedupe the song list globally before calling if
    that matters (content hashes require loading the audio, which no
    single process does here by design).
    :returns: (SpannedCatalog ready to ``match``, local SIA whose catalog
        holds THIS process's songs — resolve foreign names via metadata
        replication or the owning process).
    """
    import jax
    from jax.experimental import multihost_utils

    from ..api import SIA
    from ..config import DEFAULT_CONFIG

    if len(set(song_names)) != len(song_names):
        raise ValueError("song names must be unique (they key the id remap)")

    mesh = mesh or global_mesh()
    n_shards = mesh.devices.size
    n_songs = len(song_names)
    cat = SpannedCatalog((n_songs, 0, 0), mesh=mesh)  # meta fixed below
    mine = set(cat._my_shard_ids())
    owned = [s for s in range(n_songs) if s % n_shards in mine]

    # ---- local fingerprint pass (streaming, O(chunk) host audio) ----
    local = SIA(config or DEFAULT_CONFIG)
    for base in range(0, len(owned), chunk_songs):
        part = [(song_names[s], load_fn(s))
                for s in owned[base:base + chunk_songs]]
        local.ingest_arrays(part, batch_size=batch_size,
                            song_peak_capacity=song_peak_capacity)
    ix = local.index
    sid_of_name = {d["song_name"]: d["song_id"]
                   for d in local.catalog.get_songs()}
    remap = np.zeros(max(sid_of_name.values(), default=0) + 1, np.uint32)
    for s in owned:
        sid = sid_of_name.get(song_names[s])
        if sid is None:
            # byte-identical duplicate: ingest_arrays dedups by sample
            # SHA-1 (the reference skips duplicate files the same way,
            # ``__init__.py:344-349``), so this name owns no rows —
            # queries resolve to the first copy instead of crashing here
            continue
        remap[sid] = s
    gsid = remap[ix.song_id] if ix.n_hashes else ix.song_id

    # ---- agree on global meta (one tiny cross-host allgather at ingest) ----
    shard_of = gsid % n_shards if ix.n_hashes else gsid
    counts = np.bincount(shard_of, minlength=n_shards) if ix.n_hashes \
        else np.zeros(n_shards, np.int64)
    g = np.asarray(multihost_utils.process_allgather(
        np.array([int(ix.max_offset), int(counts.max() if len(counts) else 0)],
                 np.int64)
    )).reshape(-1, 2)
    gmax_off = int(g[:, 0].max())
    rows_per = max(int(g[:, 1].max()), 1)
    stride = 1
    while stride <= gmax_off:
        stride <<= 1
    if max(n_songs, 1) * stride > (1 << 32):
        stride = 0

    # ---- build MY shards' padded sorted rows (bigcatalog layout) ----
    n_local_songs = cat.n_local_songs
    local_sid = (gsid // n_shards).astype(np.uint32)
    per_shard = []
    for d in sorted(mine):
        sel = shard_of == d
        per_shard.append(pack_shard_rows(
            ix.key_hi[sel], ix.key_lo[sel], ix.key_ex[sel],
            local_sid[sel], ix.offset[sel],
            rows_per=rows_per, stride=stride, n_local_songs=n_local_songs,
        ))

    local_stacked = tuple(
        np.stack([per_shard[i][c] for i in range(len(per_shard))])
        for c in range(len(per_shard[0]))
    )
    cat.n_songs, cat.max_offset, cat._stride = n_songs, gmax_off, stride
    cat._place_local(local_stacked)
    return cat, local
