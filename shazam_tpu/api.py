"""Public framework API: ingest + recognition.

Replacement for the reference's driver layer:

- ``SIA.ingest_directory`` — reference ``fingerprint_directory``
  (``__init__.py:325-405``): walk a folder, dedupe by file SHA-1 (resume),
  fingerprint in *batches on the device* (vmap over a padded song matrix —
  the device analog of the multiprocessing pool), record songs in the
  catalog, and merge into the device-memory index. A song becomes durable only
  after its hashes are merged (set_song_fingerprinted semantics).
- ``SIA.recognize_file`` / ``recognize_samples`` — reference
  ``recognizer.py`` main path: fingerprint channels, set-union the pairs,
  match against the index, align + rank, return reference-shaped result
  dicts plus the same stage timings (fingerprint/query/align) the
  reference logs per trial.

Shapes are bucketed (padded to the next 2^18-sample multiple) so XLA
compiles one program per bucket, not per file.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import FingerprintConfig, DEFAULT_CONFIG
from .audio.io import read, find_files, unique_file_hash
from .ops.fingerprint import (
    Fingerprints,
    fingerprint_batch,
    fingerprint_samples,
    fingerprints_to_pairs,
)
from .index.store import FingerprintIndex, build_index, merge_into
from .index.devmerge import DeviceIndex
from .index.catalog import SongCatalog
from .match.prepare import prepare_query
from .index.search import maybe_build_head
from .match.lookup import (match_query, match_query_pruned,
                           match_query_sparse, query_total)
from .match.align import align_results


def _bucket_len(n: int, step: int = 1 << 18) -> int:
    """Round up to a multiple of 2^18 samples (~5.9 s @ 44.1 kHz).

    Linear buckets waste <= one step of padding (a power-of-two scheme
    pads a 30 s song by 60%, and every op in the pipeline scales with the
    padded length); one compiled program per bucket, ~10 buckets covers a
    4-minute catalog.
    """
    return -(-max(n, 1) // step) * step


def _batch_fingerprints(fp: Fingerprints, i: int) -> Fingerprints:
    return Fingerprints(*(np.asarray(a)[i] for a in fp))


class _PreparedBatch(NamedTuple):
    """``SIA.prepare_batch`` output: everything ``match_prepared_batch``
    needs, host-resident, so a serving pipeline can hand it between
    threads (fingerprint batch k+1 while batch k's match dispatch is in
    flight — serve.MicroBatcher)."""

    clips: List[np.ndarray]        # original clips (retry paths need them)
    queries: List                  # per-lane QueryPairs (align needs n_pairs)
    stack: Dict[str, np.ndarray]   # padded (B, q_cap) query columns
    peak_over: set                 # clip ids whose peaks overflowed
    topn: Optional[int]
    match_capacity: Optional[int]  # base-tier override
    fingerprint_time: float
    # stage-1 probe results (big pinned/bounds-policy indexes): the
    # uploaded device query columns, each clip's exact total, and the
    # device-resident (lb, ub) search bounds. Running the probe in
    # prepare_batch puts its device round trip on the PIPELINED stage
    # (serve.MicroBatcher overlaps it with the previous batch's match
    # dispatch) instead of serializing it into the match stage. None
    # when the gate doesn't apply (match_prepared_batch then probes
    # itself if its policy needs one).
    q_dev: Optional[Tuple] = None
    probe_totals: Optional[np.ndarray] = None
    probe_bounds: Optional[Tuple] = None


class SIA:
    """Sistema Identificador de Audio — accelerator edition.

    One object owns the config, the song catalog (host sqlite) and the
    fingerprint index (HBM-resident once queried).
    """

    def __init__(
        self,
        config: FingerprintConfig = DEFAULT_CONFIG,
        catalog_path: str = ":memory:",
        index: Optional[FingerprintIndex] = None,
        device_resident: bool = False,
        device_reserve_hashes: int = 0,
        device_span_rows: int = 0,
        resample: bool = True,
    ):
        self.config = config
        # mismatched-rate audio: polyphase-resample to config.sample_rate
        # (True) or reject loudly (False).  The reference silently
        # fingerprinted native-rate samples with 44.1 kHz constants
        # (``__init__.py:86-95,232``) — mixed-rate corpora could never
        # cross-match; neither behavior here reproduces that bug.
        self.resample = resample
        self.catalog = SongCatalog(catalog_path)
        self.catalog.delete_unfingerprinted()  # reference crash recovery
        self.device_resident = device_resident
        # preallocated HBM capacity: one merge-program compile for a
        # whole ingest instead of one per capacity doubling
        self.device_reserve_hashes = device_reserve_hashes
        # > 0: hold the index as multiple sorted spans of this capacity
        # (index/devmerge.SpannedDeviceStore): spans bound every
        # device program's memory and run time at O(span_rows) instead
        # of O(index), and queries search all spans.  The size at which
        # one flat buffer stops fitting was set for a 16 GB device and
        # has not been re-derived for larger ones.  Spans only exist
        # device-resident, so the flag implies it.
        self.device_span_rows = device_span_rows
        if device_span_rows:
            self.device_resident = True
        self._dev_store: Optional[DeviceIndex] = None
        self._host_stale = False
        self.index = index or build_index([], n_songs=0)
        self._device_index = None
        self._device_head = None
        self._head_src = None
        self._uview = None
        self._usteps = 0
        self._uview_src = None
        # self-tuning decide tier (config.decide_adapt_window):
        # [attempts, undecided] over the current window + the
        # accumulated tier boost
        self._decide_stats = [0, 0]
        self._decide_boost = 0
        self._max_off = 0

    # ------------------------------------------------------------------ #
    # index residency
    # ------------------------------------------------------------------ #
    @property
    def index(self) -> FingerprintIndex:
        """Host-side index; device-resident mode syncs from HBM on access."""
        if self._host_stale:
            self._index = self._dev_store.to_host()
            self._host_stale = False
        return self._index

    @index.setter
    def index(self, ix: FingerprintIndex) -> None:
        self._index = ix
        self._host_stale = False
        self._dev_store = None

    def _live_n_songs(self) -> int:
        """Catalog size without forcing a device->host index sync."""
        if self._dev_store is not None:
            return self._dev_store.n_songs
        return self._index.n_songs

    def _live_n_hashes(self) -> int:
        if self._dev_store is not None:
            return self._dev_store.n_valid
        return self._index.n_hashes

    def _absorb_addition(self, addition: FingerprintIndex) -> None:
        """Merge a sorted addition run into the live index.

        Default: host ``merge_into`` (O(n) memcpy-speed) + lazy HBM
        re-upload.  Device-resident: the run is merged *on the device*
        (index/devmerge.py) — no host merge, no index re-upload; the
        host copy materializes lazily on ``.index`` access (save/stats).
        """
        if self.device_resident:
            self._ensure_dev_store().merge(addition)
            self._host_stale = True
        else:
            self.index = merge_into(self.index, addition)
        self._device_index = None

    def _ensure_dev_store(self) -> DeviceIndex:
        if self._dev_store is None:
            if self.device_span_rows:
                from .index.devmerge import SpannedDeviceStore

                self._dev_store = SpannedDeviceStore.from_host(
                    self.index, span_rows=self.device_span_rows,
                    reserve=self.device_reserve_hashes,
                )
            else:
                self._dev_store = DeviceIndex.from_host(
                    self.index, reserve=self.device_reserve_hashes
                )
        return self._dev_store

    @property
    def _is_spanned(self) -> bool:
        return bool(self.device_resident and self.device_span_rows)

    # ------------------------------------------------------------------ #
    # ingest
    # ------------------------------------------------------------------ #
    def ingest_directory(
        self,
        path: str,
        extensions: Sequence[str] = (".wav",),
        limit: Optional[float] = None,
        batch_size: int = 8,
        song_peak_capacity: Optional[int] = None,
        verbose: bool = False,
    ) -> Dict:
        """Fingerprint every matching file under `path` into the index.

        Resumable: files whose SHA-1 is already fingerprinted are skipped
        (reference ``__init__.py:344-349``).
        """
        files = [p for p, _ in find_files(path, list(extensions))]
        files.sort()
        return self.ingest_files(
            files, limit=limit, batch_size=batch_size,
            song_peak_capacity=song_peak_capacity, verbose=verbose,
        )

    def ingest_files(
        self,
        files: Sequence[str],
        limit: Optional[float] = None,
        batch_size: int = 8,
        song_peak_capacity: Optional[int] = None,
        verbose: bool = False,
        merge_chunk_hashes: int = 4_000_000,
    ) -> Dict:
        """Streaming ingest: host memory stays O(batch), not O(corpus).

        The reference's pool streams song-by-song (``__init__.py:335-357``);
        here decode and device fingerprinting overlap (one batch in
        flight: the C++ loader fills batch k+1 while the device chews
        batch k) and the index absorbs finished songs in sorted-run
        merges every ``merge_chunk_hashes`` hashes (``merge_into``, ~O(n))
        instead of one corpus-sized sort at the end.
        """
        known = self.catalog.fingerprinted_file_hashes()
        todo: List[Tuple[str, str]] = []
        skipped = 0
        try:
            from . import native as _native

            native_sha = _native.sha1_file if _native.available() else None
        except Exception:
            native_sha = None
        for f in files:
            sha = (native_sha(f) if native_sha else None) or unique_file_hash(f)
            if sha in known:
                skipped += 1
                continue
            todo.append((f, sha))
        return self._ingest_stream(
            todo, n_inputs=len(files), skipped=skipped, limit=limit,
            batch_size=batch_size, song_peak_capacity=song_peak_capacity,
            merge_chunk_hashes=merge_chunk_hashes, verbose=verbose,
        )

    def ingest_arrays(
        self,
        named_samples: Sequence[Tuple[str, np.ndarray]],
        batch_size: int = 8,
        song_peak_capacity: Optional[int] = None,
        verbose: bool = False,
    ) -> Dict:
        """Ingest already-decoded mono songs: [(name, samples int16/f32)].

        The in-memory twin of ``ingest_files`` (no filesystem round trip —
        streaming pipelines and very large synthetic catalogs). Dedup uses
        the SHA-1 of the raw sample bytes as the "file" hash.
        """
        import hashlib

        known = self.catalog.fingerprinted_file_hashes()
        pending = []
        skipped = 0
        for name, samples in named_samples:
            arr = np.asarray(samples)
            sha = hashlib.sha1(arr.tobytes()).hexdigest().upper()
            if sha in known:
                skipped += 1
                continue
            pending.append((name, sha, [arr]))
        return self._ingest_pending(
            pending, n_inputs=len(named_samples), skipped=skipped,
            batch_size=batch_size, song_peak_capacity=song_peak_capacity,
            verbose=verbose,
        )

    def ingest_channels(
        self,
        name: str,
        channels: Sequence[np.ndarray],
        batch_size: int = 8,
        song_peak_capacity: Optional[int] = None,
    ) -> Dict:
        """Ingest ONE song from decoded channels (per-channel fingerprints
        hash-set unioned, like ``ingest_files``; reference
        ``recognizer.py:377-382``). Dedup key = SHA-1 of the channel bytes.

        This is the online-ingest primitive behind the serving daemon's
        ``POST /ingest``: the reference's deployments inserted songs into
        the DB while recognizers queried it (``__init__.py:325-405``);
        here the index grows through the same merge path batch ingest
        uses.  NB with the host-resident index every growth step changes
        the match program's shape (a recompile); a serving deployment that ingests online should build
        with ``device_resident=True`` and ``device_reserve_hashes`` so
        the device capacity (and program shapes) stay fixed across
        merges.  ``name`` is treated like a file basename (extension
        stripped).
        """
        import hashlib

        chans = [np.asarray(c) for c in channels if len(c)]
        if not chans:
            raise ValueError("no non-empty channels to ingest")
        h = hashlib.sha1()
        for c in chans:
            h.update(c.tobytes())
        sha = h.hexdigest().upper()
        if sha in self.catalog.fingerprinted_file_hashes():
            return {"files": 1, "skipped": 1, "ingested": 0, "hashes": 0,
                    "overflowed": [], "merges": 0}
        return self._ingest_pending(
            [(name, sha, chans)], n_inputs=1, skipped=0,
            batch_size=batch_size, song_peak_capacity=song_peak_capacity,
            verbose=False,
        )

    def ingest_device_batch(
        self,
        names: Sequence[str],
        samples: "jnp.ndarray",
        n_valid_samples: Sequence[int],
        shas: Optional[Sequence[str]] = None,
        song_peak_capacity: Optional[int] = None,
        per_song_hash_capacity: int = 32768,
        defer_sort: bool = False,
    ) -> Dict:
        """Zero-copy ingest of audio already resident on the device.

        Device-resident mode only.  ``samples`` is a (B, blen) float32
        device array — synthesized on the chip, or handed over from an
        upstream decode job — and never needs a host copy; fingerprints,
        the sorted/deduped addition run (index/devingest.py) and the
        merge (index/devmerge.py) all stay in HBM.  Host traffic per
        call: a (B,) song-id upload plus O(B) scalars down.  Rows with
        the same name are channels of one song (the reference's channel
        set-union, ``__init__.py:254-266``, happens in the device dedup
        because the run payload encodes the song id).

        ``shas`` are the resume keys (reference file-SHA-1 semantics);
        without host bytes they default to the SHA-1 of the name.
        """
        import hashlib

        from .index.devingest import device_sorted_run
        from .index.devmerge import _capacity

        if not self.device_resident:
            raise ValueError("ingest_device_batch requires "
                             "SIA(device_resident=True)")
        t_start = time.time()
        bsz = int(samples.shape[0])
        if len(names) != bsz or len(n_valid_samples) != bsz:
            raise ValueError("names / n_valid_samples must match batch")
        if shas is None:
            shas = [hashlib.sha1(n.encode()).hexdigest().upper()
                    for n in names]
        stats = {"files": len(set(names)), "skipped": 0, "ingested": 0,
                 "hashes": 0, "overflowed": [], "merges": 0}

        known = self.catalog.fingerprinted_file_hashes()
        keep = [i for i, s in enumerate(shas) if s.upper() not in known]
        stats["skipped"] = stats["files"] - len(
            {names[i] for i in keep})
        if not keep:
            stats["seconds"] = time.time() - t_start
            return stats
        if len(keep) != bsz:
            samples = samples[jnp.asarray(keep)]
            names = [names[i] for i in keep]
            shas = [shas[i] for i in keep]
            n_valid_samples = [n_valid_samples[i] for i in keep]
            bsz = len(keep)

        peak_cap = song_peak_capacity or max(self.config.peak_capacity,
                                             16384)

        def fp_of(rows_dev, nv, cap):
            return fingerprint_batch(
                rows_dev, jnp.asarray(np.asarray(nv, np.int32)),
                **self._fp_kwargs(peak_capacity=cap),
            )

        fp = fp_of(samples, n_valid_samples, peak_cap)
        # rows whose peaks overflowed are masked ON DEVICE for
        # the first run (no host sync before the merge): the per-batch
        # n_peaks fetch rides the same device_get as the run counts,
        # halving the host round trips of the steady-state ingest loop
        ok_rows_dev = fp.n_peaks <= jnp.uint32(peak_cap)

        # catalog registration first: the device run packs REAL song ids
        sid_of_name: Dict[str, int] = {}
        for i, name in enumerate(names):
            if name not in sid_of_name:
                sid_of_name[name] = self.catalog.insert_song(
                    name, shas[i], 0)
        row_sids = np.asarray([sid_of_name[names[i]]
                               for i in range(bsz)], np.uint32)

        # layout: stride must cover the largest possible frame offset
        # (host-derivable bound — no device round trip)
        wsize, hop = self.config.window_size, self.config.hop
        bound_off = max(
            max((int(n) - wsize) // hop + 1 for n in n_valid_samples), 0)
        n_songs_new = max(max(sid_of_name.values(), default=-1) + 1,
                          self._live_n_songs())
        store = self._ensure_dev_store()
        store._ensure_layout(n_songs_new,
                             max(store.max_offset, bound_off))
        if store.stride == 0:
            raise ValueError(
                "catalog too large for the packed payload layout; "
                "use the host ingest path (ingest_arrays/ingest_files)")

        song_totals: Dict[int, int] = {}

        def run_and_merge(one_fp, sids_np, drop_rows=None,
                          keep_mask_dev=None):
            valid = one_fp.valid
            if drop_rows:
                rows = np.ones(valid.shape[0], bool)
                rows[list(drop_rows)] = False
                valid = valid & jnp.asarray(rows)[:, None]
            if keep_mask_dev is not None:
                valid = valid & keep_mask_dev[:, None]
            cap = _capacity(valid.shape[0] * per_song_hash_capacity)
            cols, n_run, counts, overflowed = device_sorted_run(
                one_fp.hi, one_fp.lo, one_fp.ex, one_fp.t1, valid,
                jnp.asarray(sids_np), stride=store.stride,
                addition_cap=cap,
            )
            n_run, counts, overflowed, n_peaks_h = jax.device_get(
                (n_run, counts, overflowed, one_fp.n_peaks))
            if bool(overflowed):
                raise ValueError(
                    "device addition run overflowed "
                    f"{cap} rows; raise per_song_hash_capacity")
            if defer_sort:
                # bulk-ingest mode: memcpy-class tail append now, ONE
                # global sort when the index is next queried/saved —
                # the scatter merge is O(base) per call
                store.append_run(cols, int(n_run), n_songs_new,
                                 bound_off)
            else:
                store.merge_device_run(cols, int(n_run), n_songs_new,
                                       bound_off)
            stats["merges"] += 1
            stats["hashes"] += int(n_run)
            per_sid = {}  # each row of a song reports the song total
            for row, sid in enumerate(sids_np):
                if counts[row]:
                    per_sid[int(sid)] = int(counts[row])
            for sid, n in per_sid.items():
                song_totals[sid] = song_totals.get(sid, 0) + n
            return np.asarray(n_peaks_h)

        n_peaks = run_and_merge(fp, row_sids, keep_mask_dev=ok_rows_dev)
        over_rows = [i for i in range(bsz) if n_peaks[i] > peak_cap]
        if over_rows:
            # peak-capacity overflow: redo those rows at 2x capacity.
            # The retry batch is cycle-padded to the full batch size so
            # every retry reuses ONE compiled shape.  Rows still
            # flagged after the retry are NOT ingested (a truncated
            # constellation would silently drop the song's tail) — they
            # stay unfingerprinted in the catalog (purged on next open)
            # and are reported in stats["overflowed"].  NB: a
            # multi-channel song split across the two runs skips the
            # cross-run pair union (counts add).
            stats["fallbacks"] = len(over_rows)
            retry_rows = (over_rows * bsz)[:bsz]   # cycle-pad to bsz
            retry_fp = fp_of(samples[jnp.asarray(retry_rows)],
                             [n_valid_samples[i] for i in retry_rows],
                             2 * peak_cap)
            retry_n = run_and_merge(
                retry_fp, row_sids[retry_rows],
                drop_rows=set(range(len(over_rows), bsz)),
                keep_mask_dev=retry_fp.n_peaks <= jnp.uint32(2 * peak_cap),
            )  # pad rows masked; still-flagged rows masked on device
            dead_pos = [j for j in range(len(over_rows))
                        if retry_n[j] > 2 * peak_cap]
            stats["overflowed"] = [names[over_rows[j]] for j in dead_pos]

        self._host_stale = True
        self._device_index = None
        dead_names = set(stats["overflowed"])
        for name, sid in sid_of_name.items():
            if name in dead_names:
                continue  # stays unfingerprinted -> purged on next open
            self.catalog.update_song_hashes(sid, song_totals.get(sid, 0))
            self.catalog.set_song_fingerprinted(sid)
            stats["ingested"] += 1
        stats["seconds"] = time.time() - t_start
        return stats

    def _ingest_stream(
        self,
        todo: List[Tuple[str, str]],
        *,
        n_inputs: int,
        skipped: int,
        limit: Optional[float],
        batch_size: int,
        song_peak_capacity: Optional[int],
        merge_chunk_hashes: int,
        verbose: bool,
    ) -> Dict:
        t_start = time.time()
        peak_cap = song_peak_capacity or max(self.config.peak_capacity, 16384)
        fs_cfg = self.config.sample_rate
        stats = {"files": n_inputs, "skipped": skipped, "ingested": 0,
                 "hashes": 0, "overflowed": [], "merges": 0,
                 "peak_pending_channels": 0}

        try:
            from . import native as _native

            native_batch = _native.load_batch if _native.available() else None
        except Exception:
            native_batch = None

        from .audio.io import probe

        # ---- plan: header probes only; (file, channel) rows per bucket ----
        rows_by_bucket: Dict[int, List[Tuple[int, int, int]]] = {}
        song_expect: List[int] = []    # outstanding channels per song
        unknown: List[int] = []        # songs needing an eager decode
        for si, (f, _sha) in enumerate(todo):
            info = probe(f)
            if info is None:
                unknown.append(si)
                song_expect.append(-1)
                continue
            n_ch, fs, frames = info
            if fs != fs_cfg:
                if self.resample:
                    # rate conversion changes the frame count, so the
                    # header-only plan can't bucket it — eager decode
                    unknown.append(si)
                    song_expect.append(-1)
                    continue
                raise ValueError(f"{f}: sample rate {fs} != config {fs_cfg}")
            if limit is not None:
                frames = min(frames, int(limit * fs))
            song_expect.append(n_ch)
            rows_by_bucket.setdefault(_bucket_len(frames), []).extend(
                (si, c, frames) for c in range(n_ch)
            )

        song_fps: Dict[int, List[Fingerprints]] = {}
        chunk_entries: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
        chunk_sids: List[int] = []
        pending_hashes = 0
        pending_channels = 0

        def decode_rows(rows, blen):
            """(len(rows), blen) float32 batch + valid lengths.

            Fast path: the threaded C++ loader fills the whole matrix
            GIL-free when every row is a channel-0 read.
            """
            if native_batch is not None and all(c == 0 for _si, c, _n in rows):
                out = native_batch([todo[si][0] for si, _c, _n in rows], blen)
                if out is not None:
                    mat, nv, _shas = out
                    n_valid = np.minimum(
                        nv.astype(np.int32),
                        np.array([n for _si, _c, n in rows], np.int32),
                    )
                    for i, lim in enumerate(n_valid):
                        mat[i, lim:] = 0.0
                    return mat, n_valid
            # int16 batch when every channel decodes integral (WAV):
            # halves the host->device upload (cast happens on device)
            batch = None
            n_valid = np.zeros(len(rows), np.int32)
            cache: Dict[str, List[np.ndarray]] = {}
            for i, (si, c, frames) in enumerate(rows):
                f = todo[si][0]
                if f not in cache:
                    cache.clear()  # one file's channels at a time
                    cache[f] = read(f, limit)[0]
                data = cache[f][c][:frames]
                if batch is None:
                    dt = np.int16 if all(
                        ch.dtype == np.int16 for ch in cache[f]
                    ) else np.float32
                    batch = np.zeros((len(rows), blen), dt)
                if batch.dtype == np.int16 and data.dtype != np.int16:
                    batch = batch.astype(np.float32)
                batch[i, : len(data)] = data
                n_valid[i] = len(data)
            if batch is None:
                batch = np.zeros((len(rows), blen), np.float32)
            return batch, n_valid

        def finalize_song(si):
            nonlocal pending_hashes
            f, sha = todo[si]
            hi, lo, ex, t1 = self._union_channel_pairs(song_fps.pop(si, []))
            song_name = os.path.splitext(os.path.basename(f))[0]
            sid = self.catalog.insert_song(song_name, sha, int(hi.size))
            chunk_entries.append((sid, hi, lo, ex, t1))
            chunk_sids.append(sid)
            pending_hashes += int(hi.size)
            stats["ingested"] += 1
            stats["hashes"] += int(hi.size)
            if verbose:
                print(f"ingested {song_name}: {hi.size} hashes (song_id={sid})")

        def maybe_merge(force=False):
            nonlocal pending_hashes
            if not chunk_entries or (not force and pending_hashes < merge_chunk_hashes):
                return
            n_songs = max(max(e[0] for e in chunk_entries) + 1,
                          self._live_n_songs())
            addition = build_index(chunk_entries, n_songs=n_songs)
            self._absorb_addition(addition)
            for sid in chunk_sids:
                self.catalog.set_song_fingerprinted(sid)
            chunk_entries.clear()
            chunk_sids.clear()
            pending_hashes = 0
            stats["merges"] += 1

        def collect(inflight):
            nonlocal pending_channels
            fp_dev, rows, batch_np = inflight
            fp = jax.device_get(fp_dev)
            for row, (si, _c, _n) in enumerate(rows):
                one = _batch_fingerprints(fp, row)
                if int(one.n_peaks) > peak_cap:
                    # peak-capacity overflow: retry at 2x capacity
                    # (never a silent drop)
                    one = jax.device_get(fingerprint_samples(
                        jnp.asarray(batch_np[row], dtype=np.float32),
                        jnp.int32(int(_n)),
                        **self._fp_kwargs(peak_capacity=2 * peak_cap),
                    ))
                    stats["fallbacks"] = stats.get("fallbacks", 0) + 1
                    if int(one.n_peaks) > 2 * peak_cap:
                        stats["overflowed"].append(todo[si][0])
                song_fps.setdefault(si, []).append(one)
                pending_channels -= 1
                song_expect[si] -= 1
                if song_expect[si] == 0:
                    finalize_song(si)
            maybe_merge()

        # ---- stream: decode chunk k+1 while the device runs chunk k ----
        inflight = None
        for blen in sorted(rows_by_bucket):
            rows = rows_by_bucket[blen]
            for base in range(0, len(rows), batch_size):
                chunk = rows[base : base + batch_size]
                batch_np, n_valid = decode_rows(chunk, blen)
                pending_channels += len(chunk)
                stats["peak_pending_channels"] = max(
                    stats["peak_pending_channels"], pending_channels
                )
                batch_dev = jnp.asarray(batch_np)
                if batch_np.dtype == np.int16:
                    batch_dev = batch_dev.astype(jnp.float32)
                fp_dev = fingerprint_batch(
                    batch_dev, jnp.asarray(n_valid),
                    **self._fp_kwargs(peak_capacity=peak_cap),
                )  # async dispatch: host decodes on while this runs
                if inflight is not None:
                    collect(inflight)
                inflight = (fp_dev, chunk, batch_np)
        if inflight is not None:
            collect(inflight)

        # ---- files the probe couldn't size: eager decode, same machinery
        for si in unknown:
            f, _sha = todo[si]
            channels, fs, _ = read(f, limit)
            if fs != fs_cfg:
                if not self.resample:
                    raise ValueError(
                        f"{f}: sample rate {fs} != config {fs_cfg}")
                from .audio.resample import resample_channels

                channels = resample_channels(channels, fs, fs_cfg)
            song_expect[si] = len(channels)
            blen = _bucket_len(max(len(ch) for ch in channels))
            batch_np = np.zeros((len(channels), blen), np.float32)
            n_valid = np.zeros(len(channels), np.int32)
            for i, ch in enumerate(channels):
                batch_np[i, : len(ch)] = ch
                n_valid[i] = len(ch)
            fp_dev = fingerprint_batch(
                jnp.asarray(batch_np), jnp.asarray(n_valid),
                **self._fp_kwargs(peak_capacity=peak_cap),
            )
            pending_channels += len(channels)
            stats["peak_pending_channels"] = max(
                stats["peak_pending_channels"], pending_channels
            )
            collect((fp_dev, [(si, c, int(n_valid[c])) for c in range(len(channels))],
                     batch_np))

        maybe_merge(force=True)
        stats["seconds"] = time.time() - t_start
        return stats

    @staticmethod
    def _union_channel_pairs(fps: List[Fingerprints]):
        """Per-song channel set-union of (hash, offset) pairs
        (reference ``get_file_fingerprints``, ``__init__.py:254-266``)."""
        his, los, exs, t1s = [], [], [], []
        for one in fps:
            hi, lo, ex, t1 = fingerprints_to_pairs(one, dedup=False)
            his.append(hi)
            los.append(lo)
            exs.append(ex)
            t1s.append(t1)
        hi = np.concatenate(his) if his else np.zeros(0, np.uint32)
        lo = np.concatenate(los) if los else np.zeros(0, np.uint32)
        ex = np.concatenate(exs) if exs else np.zeros(0, np.uint32)
        t1 = np.concatenate(t1s) if t1s else np.zeros(0, np.uint32)
        if hi.size:
            stacked = np.unique(
                np.stack([hi.astype(np.uint64), lo.astype(np.uint64),
                          ex.astype(np.uint64), t1.astype(np.uint64)], 1),
                axis=0,
            )
            hi, lo, ex, t1 = (
                stacked[:, i].astype(np.uint32) for i in range(4)
            )
        return hi, lo, ex, t1

    def _ingest_pending(
        self,
        pending: List[Tuple[str, str, List[np.ndarray]]],
        n_inputs: int,
        skipped: int,
        batch_size: int,
        song_peak_capacity: Optional[int],
        verbose: bool,
    ) -> Dict:
        t_start = time.time()
        peak_cap = song_peak_capacity or max(self.config.peak_capacity, 16384)
        new_entries = []
        stats = {"files": n_inputs, "skipped": skipped, "ingested": 0,
                 "hashes": 0, "overflowed": []}

        # flatten channels; remember song boundaries
        chan_meta: List[Tuple[int, int]] = []  # (song_idx, n_samples)
        chan_data: List[np.ndarray] = []
        for si, (_f, _sha, channels) in enumerate(pending):
            for ch in channels:
                chan_meta.append((si, len(ch)))
                chan_data.append(ch)

        # bucket channels by padded length, batch within bucket
        by_bucket: Dict[int, List[int]] = {}
        for ci, ch in enumerate(chan_data):
            by_bucket.setdefault(_bucket_len(len(ch)), []).append(ci)

        song_fps: Dict[int, List[Fingerprints]] = {}
        for blen, chan_ids in sorted(by_bucket.items()):
            for base in range(0, len(chan_ids), batch_size):
                ids = chan_ids[base:base + batch_size]
                # upload int16 when the sources are integral (WAV/synth
                # audio): halves host->device transfer; the exact cast
                # to float32 happens on the device
                all_int = all(
                    chan_data[ci].dtype == np.int16 for ci in ids
                )
                batch = np.zeros(
                    (len(ids), blen), np.int16 if all_int else np.float32
                )
                n_valid = np.zeros(len(ids), np.int32)
                for row, ci in enumerate(ids):
                    ch = chan_data[ci]
                    batch[row, : len(ch)] = ch
                    n_valid[row] = len(ch)
                batch_dev = jnp.asarray(batch)
                if all_int:
                    batch_dev = batch_dev.astype(jnp.float32)
                fp = fingerprint_batch(
                    batch_dev, jnp.asarray(n_valid),
                    **self._fp_kwargs(peak_capacity=peak_cap),
                )
                fp = jax.device_get(fp)
                for row, ci in enumerate(ids):
                    si = chan_meta[ci][0]
                    one = _batch_fingerprints(fp, row)
                    if int(one.n_peaks) > peak_cap:
                        # peak-capacity overflow: retry this channel
                        # with 2x capacity
                        ch = chan_data[ci]
                        pad2 = np.zeros(blen, np.float32)
                        pad2[: len(ch)] = ch
                        one = jax.device_get(fingerprint_samples(
                            jnp.asarray(pad2), jnp.int32(len(ch)),
                            **self._fp_kwargs(peak_capacity=2 * peak_cap),
                        ))
                        stats["fallbacks"] = stats.get("fallbacks", 0) + 1
                        if int(one.n_peaks) > 2 * peak_cap:
                            stats["overflowed"].append(pending[si][0])
                    song_fps.setdefault(si, []).append(one)

        # per-song channel union + catalog insert + index entry
        for si, (f, sha, _channels) in enumerate(pending):
            hi, lo, ex, t1 = self._union_channel_pairs(song_fps.get(si, []))
            song_name = os.path.splitext(os.path.basename(f))[0]
            sid = self.catalog.insert_song(song_name, sha, int(hi.size))
            new_entries.append((sid, hi, lo, ex, t1))
            stats["ingested"] += 1
            stats["hashes"] += int(hi.size)
            if verbose:
                print(f"ingested {song_name}: {hi.size} hashes (song_id={sid})")

        if new_entries:
            n_songs = max(e[0] for e in new_entries) + 1
            addition = build_index(
                new_entries, n_songs=max(n_songs, self._live_n_songs())
            )
            self._absorb_addition(addition)
            for sid, *_rest in new_entries:
                self.catalog.set_song_fingerprinted(sid)

        stats["seconds"] = time.time() - t_start
        return stats

    # ------------------------------------------------------------------ #
    # recognition
    # ------------------------------------------------------------------ #
    def _ensure_device_index(self):
        if self.device_resident:
            self._ensure_dev_store()
            self._offset_stride = self._dev_store.stride
            self._max_off = ((self._dev_store.max_offset // 4096) + 1) * 4096
            return self._dev_store.query_cols()
        if self._device_index is None:
            self._device_index = self.index.device_arrays()
            self._offset_stride = self.index.offset_stride
            # histogram window base: covers the longest song, rounded up
            # so catalog growth doesn't recompile every merge
            self._max_off = ((self.index.max_offset // 4096) + 1) * 4096
        return self._device_index

    def _ensure_head(self, dev):
        """Bucket-CDF head over dev's key_hi (see index/search.build_head).

        Cached by column identity: a merge/finalize/rebuild swaps the
        device arrays, which invalidates the head automatically. Small
        indexes skip it (the plain descent already wins there).
        """
        k_hi = dev[0]
        if self._head_src is not k_hi:
            self._device_head = maybe_build_head(k_hi)
            self._head_src = k_hi
        return self._device_head

    def _ensure_uview(self, dev):
        """(UniqueView, steps) over the host index's key columns — or
        (None, 0) when unavailable/not worthwhile.

        The unique table collapses duplicate 80-bit keys so the search
        is ONE fixed-round descent with a free upper bound
        (index/search.UniqueView). Built host-side in one numpy pass,
        so it exists only for host-backed flat indexes (load/ingest
        paths); device-resident and spanned stores keep the bucket-CDF
        head search. Cached by device-column identity like the head —
        any mutation swaps the columns and invalidates it.
        """
        if self.device_resident or self._is_spanned:
            return None, 0
        k_hi = dev[0]
        if self._uview_src is not k_hi:
            from .index.search import build_unique_view

            self._uview, self._usteps = build_unique_view(
                self.index.key_hi, self.index.key_lo, self.index.key_ex)
            self._uview_src = k_hi
        return self._uview, self._usteps

    def _span_uview(self):
        """(stacked UniqueView, steps) of a consolidated spanned store,
        or (None, 0) — the spanned matchers' preferred search table."""
        store = self._dev_store
        if store is not None and getattr(store, "is_spanned", False):
            return store.uview
        return None, 0

    def _ensure_heads(self, devs):
        """Per-span bucket-CDF heads (spanned store), cached by identity.

        Sealed spans never change (finalize only sorts pending appends),
        so their heads build once; the active span's columns swap on
        every append and its head rebuilds on next query — all spans
        share one capacity, so the build is ONE compiled program.
        Consolidated (stacked) stores get one (n_spans, 2^bits + 1)
        stacked head, built vmapped.
        """
        if not isinstance(devs[0], tuple):   # stacked (n_spans, rows)
            k_hi = devs[0]
            if self._head_src is not k_hi:
                from .index.search import build_head, stacked_head_bits

                bits = stacked_head_bits(k_hi.shape[1])
                self._device_head = (
                    jax.vmap(lambda h: build_head(h, bits=bits))(k_hi)
                    if bits is not None else None)
                self._head_src = k_hi
            return self._device_head
        cached = getattr(self, "_span_heads", [])
        out = []
        for i, arrs in enumerate(devs):
            k_hi = arrs[0]
            if i < len(cached) and cached[i][0] is k_hi:
                out.append(cached[i])
            else:
                out.append((k_hi, maybe_build_head(k_hi)))
        self._span_heads = out
        return tuple(h for _, h in out)

    def _fp_kwargs(self, peak_capacity: Optional[int] = None) -> Dict:
        """The fingerprint kwargs every path shares, single-sourced: a
        new config knob must not silently diverge between the many
        ingest/recognize call sites (they all spell the same ten)."""
        c = self.config
        return dict(
            fs=c.sample_rate, wsize=c.window_size, hop=c.hop,
            amp_min=c.amp_min, radius=c.peak_neighborhood_size,
            fan_value=c.fan_value, min_dt=c.min_hash_time_delta,
            max_dt=c.max_hash_time_delta,
            peak_capacity=(c.peak_capacity if peak_capacity is None
                           else peak_capacity),
        )

    def _q_frames_for(self, n_samples: int) -> int:
        """Smallest power-of-two frame window covering a query's offsets.

        The reference handles any clip length (``recognizer.py:289-338``);
        a fixed window silently drops votes with deltas below -q_frames.
        Bucketing keeps one compiled program for all <=47 s queries and
        recompiles only on the rare longer ones.
        """
        from .match.prepare import q_frames_for_max_offset

        n_frames = max(
            (n_samples - self.config.window_size) // self.config.hop + 1, 1
        )
        return q_frames_for_max_offset(n_frames - 1)

    def _delta_params_for(self, n_samples: int) -> Tuple[int, int]:
        q_frames = self._q_frames_for(n_samples)
        return (-q_frames, self._max_off + 2 * q_frames)

    def _fingerprint_channel(self, samples: np.ndarray) -> Fingerprints:
        blen = _bucket_len(len(samples))
        padded = np.zeros(blen, np.float32)
        padded[: len(samples)] = samples
        # Escalating capacity: a long clip (full-length
        # track through recognize_file) legitimately exceeds peak_capacity,
        # and every query path terminates here — truncating would silently
        # drop the clip tail's hashes (the reference handles any clip
        # length, ``recognizer.py:289-338``). n_peaks reports the true
        # count even when clamped, so one retry usually fits.
        cap = self.config.peak_capacity
        while True:
            fp = fingerprint_samples(
                jnp.asarray(padded), jnp.int32(len(samples)),
                **self._fp_kwargs(peak_capacity=cap),
            )
            if int(fp.n_peaks) <= cap or cap >= (1 << 22):
                return fp
            while cap < int(fp.n_peaks) and cap < (1 << 22):
                cap *= 2

    def recognize_samples(
        self,
        channels: Sequence[np.ndarray],
        topn: Optional[int] = None,
        early_exit: bool = False,
        q_pad_to: Optional[int] = None,
    ) -> Dict:
        """Recognize already-decoded audio channels.

        Returns the reference's result schema: ranked result dicts plus
        fingerprint/query/align stage times (``recognizer_test.py:607-610``).

        early_exit=True enables the apriori batched matcher with the
        reference's 2x-leader stop rule (``recognizer_apriori.py:303``).

        q_pad_to raises the query-pair padding bucket (never lowers it):
        the match program's shape is the pow2 pair bucket, so a serving
        warmup uses this to precompile buckets real clips will hit
        (``serve.warmup``) — results are identical at any padding.
        """
        t0 = time.time()
        channels = [np.asarray(ch) for ch in channels if len(ch)]
        if not channels:
            # empty input (e.g. a stream queried before any audio):
            # the reference returns no matches, not a crash
            return {
                "results": [], "total_matches": 0, "overflowed": False,
                "partial_counts": False,
                "input_hashes": 0, "fingerprint_time": 0.0,
                "query_time": 0.0, "align_time": 0.0, "total_time": 0.0,
            }
        fps = [self._fingerprint_channel(ch) for ch in channels]
        q = prepare_query(fps)
        if q_pad_to is not None and q_pad_to > len(q.hi):
            q = prepare_query(fps, pad_to=q_pad_to)
        jax.block_until_ready(fps[-1].hi)
        fingerprint_time = time.time() - t0

        t0 = time.time()
        raw, cap_used = self._match_prepared(
            q, n_samples=max(len(ch) for ch in channels) if channels else 0,
            topn=topn, early_exit=early_exit,
        )
        query_time = time.time() - t0

        t0 = time.time()
        matched = align_results(
            raw, q.n_pairs, catalog=self.catalog, config=self.config,
            match_capacity=cap_used,
        )
        align_time = time.time() - t0

        return {
            "results": matched.results,
            "total_matches": matched.total_matches,
            "overflowed": matched.overflowed,
            "partial_counts": matched.partial_counts,
            "input_hashes": q.n_pairs,
            "fingerprint_time": fingerprint_time,
            "query_time": query_time,
            "align_time": align_time,
            "total_time": fingerprint_time + query_time + align_time,
        }

    def _match_prepared(self, q, n_samples: int, topn: Optional[int] = None,
                        early_exit: bool = False,
                        min_capacity: Optional[int] = None):
        """Match prepared query pairs; returns (host RawMatch, capacity
        actually used) — overflow is judged against the escalated tier.

        The shared match stage behind ``recognize_samples`` and the
        incremental ``StreamRecognizer`` (which fingerprints its own
        pairs and only needs the index lookup + vote here).

        ``min_capacity``: a caller that already KNOWS the query's exact
        row count (``recognize_batch``'s base dispatch reports exact
        totals even when clamped) passes it to start at the fitting
        tier — the probe dispatch at the fast tier is pure waste then.
        """
        dev = self._ensure_device_index()
        delta_min, delta_range = self._delta_params_for(n_samples)
        n_songs_live = max(self._live_n_songs(), 1)
        # apriori accumulates a dense histogram across batches — past the
        # sparse-matcher threshold that allocation is the ~0.5 GB/query
        # cost the sparse path exists to avoid, so early exit is a net
        # loss there (see benchmarks/apriori_timing.py); take the full
        # match instead
        # (warn rather than silently change semantics vs the reference's
        # partial-scan apriori mode)
        if early_exit and (self._is_spanned
                           or n_songs_live * delta_range > self.config.sparse_vote_threshold):
            import warnings

            warnings.warn(
                "early_exit is unavailable for "
                + ("spanned stores" if self._is_spanned
                   else "catalogs past the sparse-matcher threshold")
                + "; running a full match (identical top-1, but "
                "vote counts reflect the full scan, not a partial one)",
                stacklevel=3,
            )
        if self._is_spanned:
            return self._match_prepared_spanned(
                dev, q, n_songs=n_songs_live, delta_min=delta_min,
                delta_range=delta_range, topn=topn,
                min_capacity=min_capacity)
        head = self._ensure_head(dev)
        uview, usteps = self._ensure_uview(dev)
        if early_exit and n_songs_live * delta_range <= self.config.sparse_vote_threshold:
            # the single-dispatch while_loop variant: the margin test
            # runs on device, so an early exit actually pays instead of
            # trading batches for host round trips
            from .match.apriori import match_query_apriori_ondevice

            raw, _batches, clamped = match_query_apriori_ondevice(
                dev, q,
                n_songs=n_songs_live,
                delta_min=delta_min,
                delta_range=delta_range,
                match_capacity=self.config.match_capacity,
                topn=topn or self.config.topn,
                offset_stride=self._offset_stride,
                head=head,
            )
            # total_rows accumulates across batches, so it legitimately
            # exceeds one batch's match_capacity; only a per-batch clamp
            # (votes actually dropped) should flag overflow downstream
            cap_used = (self.config.match_capacity if clamped
                        else max(int(raw.total_rows),
                                 self.config.match_capacity))
            return raw, cap_used
        # tiered expansion: the fast capacity covers typical queries at
        # ~1/4 the gather cost; overflows escalate x4 up to
        # match_capacity_max (hyper-common hashes in large catalogs can
        # legitimately expand one query to 100K+ rows, and the reference
        # counts every row's vote)
        caps = self._match_tiers()
        if min_capacity is not None:
            caps = [c for c in caps if c >= min_capacity] or caps[-1:]

        n_songs = max(self._live_n_songs(), 1)
        # big catalogs: the dense (n_songs, delta_range) vote histogram
        # costs ~3 passes over n_songs*delta_range*4 bytes per query
        # (~1.5 GB at 12K songs); the sort-based sparse matcher
        # is O(match_capacity) and element-identical (tested)
        use_sparse = n_songs * delta_range > self.config.sparse_vote_threshold
        # vote_rank selects among the element-identical sparse ranks
        # per tier (config.vote_rank via _rank_for): "pruned" =
        # candidate-pruned with in-program sort fallback; "sort";
        # "scan" = scatter-free sort+scan rank
        n_cand = self.config.rank_candidates
        eblk = self._expand_block_for(dev)
        eruns = self.config.expand_block_runs
        bounds_dev = None   # probe's (lb, ub), device-resident

        def run(cap, blk=None, with_bounds=False):
            q_args = (jnp.asarray(q.hi), jnp.asarray(q.lo),
                      jnp.asarray(q.ex), jnp.asarray(q.t),
                      jnp.asarray(q.valid), jnp.asarray(q.first))
            b = self._eblk_for_cap(eblk, cap) if blk is None else blk
            vrank = self._rank_for(cap)
            kw = dict(n_songs=n_songs, delta_min=delta_min,
                      delta_range=delta_range, match_capacity=cap,
                      topn=topn or self.config.topn,
                      offset_stride=self._offset_stride,
                      head=head, uview=uview, u_steps=usteps)
            if use_sparse and not with_bounds and vrank == "pruned" \
                    and n_cand > 0:
                raw, _ok = jax.device_get(match_query_pruned(
                    dev, *q_args, n_candidates=n_cand,
                    expand_block=b, expand_runs=eruns,
                    bounds=bounds_dev, **kw))
                return raw
            if use_sparse:
                if with_bounds:
                    # decided-first dispatch: same match program, but
                    # the search bounds come back device-resident for
                    # the (rare) fitted re-dispatch to reuse
                    raw_d, lb_d, ub_d = match_query_sparse(
                        dev, *q_args,
                        vote_rank=vrank if vrank != "pruned" else "sort",
                        expand_block=b, expand_runs=eruns,
                        with_bounds=True, **kw)
                    return jax.device_get(raw_d), (lb_d, ub_d)
                return jax.device_get(match_query_sparse(
                    dev, *q_args,
                    vote_rank=vrank if vrank != "pruned" else "sort",
                    expand_block=b, expand_runs=eruns,
                    bounds=bounds_dev, **kw))
            return jax.device_get(match_query(dev, *q_args, **kw))

        # big-index escalation policy (config.escalation_policy):
        #
        # decided-first ("decide"/"auto"): ONE dispatch at the
        # match_capacity tier that also returns its search bounds. Most
        # real queries either fit it or are PROVABLY decided under the
        # clamp (margin > excluded runs), so the median query pays one
        # fast dispatch instead
        # of probe + fitted. Undecided queries re-dispatch once at the
        # tier their exact total fits, reusing the bounds.
        #
        # bounds-first ("bounds", or "auto" with decision_escalation
        # off): most real queries overflow the fast tier at production
        # scale, so a bounds-only probe reads the EXACT total
        # and the match dispatches straight to the fitting tier (full
        # vote counts on every query). Skipped when the caller already
        # knows the count via min_capacity.
        total = None
        big = (use_sparse and min_capacity is None
               and self.config.bounds_probe_min_rows
               and self._index_rows(dev)
               >= self.config.bounds_probe_min_rows)
        pol = self.config.escalation_policy
        decide_first = (pol == "decide"
                        or (pol == "auto" and self.config.decision_escalation))
        if big and decide_first:
            cap = self._decide_cap(caps)
            raw, bounds_dev = run(cap, with_bounds=True)
            clamped = (int(raw.total_rows) > cap
                       or int(raw.n_dropped) > 0)
            self._decide_record(
                1, int(clamped and not self._decided(raw)))
        elif big:
            total_d, lb_d, ub_d = query_total(
                dev, jnp.asarray(q.hi), jnp.asarray(q.lo),
                jnp.asarray(q.ex), jnp.asarray(q.valid),
                head=head, uview=uview, u_steps=usteps,
                with_bounds=True)
            total = int(jax.device_get(total_d))
            bounds_dev = (lb_d, ub_d)
            cap = next((c for c in caps if c >= total), caps[-1])
            raw = run(cap)
        else:
            cap = caps[0]
            raw = run(cap)
        if total is None:
            total = int(raw.total_rows)  # exact even when clamped
        if total > cap or int(raw.n_dropped) > 0:
            # n_dropped > 0 with total <= cap only happens under the
            # blocked expansion's nonempty-run budget (expand_block_runs)
            if self._decided(raw):
                # provably-exact early accept (see config.decision_
                # escalation): the escalated tier would return the same
                # top-1 song and offset — report a capacity that keeps
                # align_results' overflow check reading "result
                # unaffected by capacity"
                return raw, max(total, cap)
            if total > cap:
                fit = next((c for c in caps if c >= total), caps[-1])
                if fit != cap:      # not already at the terminal tier
                    cap = fit
                    raw = run(cap)
            if eblk and int(raw.n_dropped) > 0 and total <= cap:
                # > expand_block_runs nonempty runs: no capacity tier
                # cures a run-budget drop — the scalar expansion is the
                # exact terminal fallback (rare: > 1024 distinct matched
                # hashes in one clip)
                raw = run(cap, blk=0)
        return raw, cap

    def _rank_for(self, cap: int) -> str:
        """Resolve config.vote_rank per capacity tier: "auto" = pruned
        at the fast tier, scan at escalated tiers (the scatter-free
        rank for long expansion streams)."""
        v = self.config.vote_rank
        if v == "auto":
            return ("pruned" if cap <= self.config.match_capacity_fast
                    else "scan")
        return v

    def _eblk_for_cap(self, eblk: int, cap: int) -> int:
        """Blocked expansion only past expand_block_min_capacity: its
        static run-budget stream (2 * expand_block_runs * B elements)
        dwarfs the fast tier's own capacity."""
        return eblk if cap >= self.config.expand_block_min_capacity else 0

    def _expand_block_for_spanned(self, dev) -> int:
        """config.expand_block for the spanned store: only the
        CONSOLIDATED stacked layout has a blocked variant (flat row
        view; runs never straddle spans since span_rows is a pow2
        multiple of the block width). Per-span tuples return 0."""
        blk = self.config.expand_block
        if not blk or self._offset_stride == 0:
            return 0
        try:
            if isinstance(dev[0], (tuple, list)):
                return 0
            span_rows = int(dev[0].shape[1])
        except (TypeError, AttributeError, IndexError):
            return 0
        return blk if span_rows % blk == 0 else 0

    def _spanned_rows(self, dev) -> int:
        """Total row capacity of a spanned device layout (0 unknown)."""
        try:
            if isinstance(dev[0], (tuple, list)):
                return sum(int(c[0].shape[0]) for c in dev)
            return int(dev[0].shape[0]) * int(dev[0].shape[1])
        except (TypeError, AttributeError, IndexError):
            return 0

    def _index_rows(self, dev) -> int:
        """Row capacity of the device index columns (0 when unknown)."""
        try:
            return int(dev[3].shape[0])
        except (TypeError, AttributeError, IndexError):
            return 0

    def _expand_block_for(self, dev) -> int:
        """config.expand_block, gated on the layout actually supporting
        block-gather expansion: packed payload (offset_stride > 0) with
        device capacity a multiple of the block width (device_arrays
        pads host-loaded indexes to 512; device-resident stores carry
        power-of-two capacities). Spanned stores expand through
        _expand_stacked, which has no blocked variant yet — 0 there."""
        blk = self.config.expand_block
        if not blk or self._offset_stride == 0 or self._is_spanned:
            return 0
        try:
            rows = int(dev[3].shape[0])
        except (TypeError, AttributeError, IndexError):
            return 0
        return blk if rows % blk == 0 else 0

    def _decided(self, raw) -> bool:
        """True iff a capacity-clamped RawMatch is PROVABLY the full
        answer: every excluded run adds <= 1 vote to any (song, delta)
        bin, so a top-1 margin over the strongest challenger larger
        than the excluded-run count cannot be overturned."""
        if not self.config.decision_escalation:
            return False
        return (int(raw.top_votes[0]) - int(raw.runner_votes)
                > int(raw.n_dropped))

    def _match_tiers(self):
        caps = [self.config.match_capacity_fast, self.config.match_capacity]
        if caps[0] >= caps[1]:
            caps = caps[1:]
        while caps[-1] < self.config.match_capacity_max:
            step = 2 if caps[-1] >= self.config.match_tier_fine_from else 4
            caps.append(min(caps[-1] * step, self.config.match_capacity_max))
        return caps

    def _decide_cap(self, caps):
        """The decided-first dispatch tier: config.decide_capacity
        (defaulting to the match_capacity tier), plus any self-tuning
        boost ``_decide_record`` accumulated (see
        config.decide_adapt_window)."""
        want = self.config.decide_capacity or self.config.match_capacity
        idx = next((i for i, c in enumerate(caps) if c >= want),
                   len(caps) - 1)
        idx = min(idx + self._decide_boost, len(caps) - 1)
        while idx > 0 and caps[idx] > self.config.decide_adapt_max \
                and caps[idx] > want:
            idx -= 1
        return caps[idx]

    def _decide_record(self, attempts: int, undecided: int) -> None:
        """Feed the self-tuning decide tier: over each
        config.decide_adapt_window of unpinned decided-first dispatches,
        an undecided rate above 1/2 raises the tier one step (corpora
        with long hyper-common runs need a bigger run budget before
        margins certify; the optimum is corpus-dependent). Counter races
        between serving threads only blur the window — harmless."""
        w = self.config.decide_adapt_window
        if not w:
            return
        self._decide_stats[0] += attempts
        self._decide_stats[1] += undecided
        if self._decide_stats[0] >= w:
            a, u = self._decide_stats
            self._decide_stats = [0, 0]
            if u * 2 > a:
                self._decide_boost += 1

    def _match_prepared_spanned(self, dev, q, *, n_songs, delta_min,
                                delta_range, topn, min_capacity=None):
        """Spanned-store match: every span searched, votes counted once.

        Each span's expansion clamps independently at the tier capacity,
        so the retry trigger is the LARGEST per-span count (exact even
        when clamped); the returned capacity-for-overflow is the sum
        semantics ``align_results`` expects — when no span clamped,
        nothing was dropped even if the summed total exceeds one tier.
        """
        from .match.lookup import (match_query_pruned_spanned,
                                   match_query_sparse_spanned,
                                   query_total_spanned)

        uviews, usteps = self._span_uview()
        # the uview supersedes the bucket-CDF heads for the stacked
        # layout — skip their build (a 134M-row searchsorted per span)
        heads = None if uviews is not None else self._ensure_heads(dev)
        caps = self._match_tiers()
        if min_capacity is not None:
            caps = [c for c in caps if c >= min_capacity] or caps[-1:]
        n_cand = self.config.rank_candidates
        eblk_s = self._expand_block_for_spanned(dev)
        eruns = self.config.expand_block_runs
        bounds_dev = None   # probe's stacked (lb, ub), device-resident

        def run(cap, blk=None, with_bounds=False):
            vrank = self._rank_for(cap)
            b = self._eblk_for_cap(eblk_s, cap) if blk is None else blk
            q_args = (jnp.asarray(q.hi), jnp.asarray(q.lo),
                      jnp.asarray(q.ex), jnp.asarray(q.t),
                      jnp.asarray(q.valid), jnp.asarray(q.first))
            kw = dict(n_songs=n_songs, delta_min=delta_min,
                      delta_range=delta_range, match_capacity=cap,
                      topn=topn or self.config.topn,
                      offset_stride=self._offset_stride,
                      heads=heads, uviews=uviews, u_steps=usteps)
            if vrank == "pruned" and n_cand > 0 and not with_bounds:
                raw, span_max, _ok = jax.device_get(
                    match_query_pruned_spanned(
                        dev, *q_args, n_candidates=n_cand, **kw))
                return raw, span_max
            if with_bounds:
                # spanned decided-first dispatch: same match program,
                # the stacked (n_spans, Q) descent comes back device-
                # resident for the (rare) fitted re-dispatch
                raw_d, sm_d, lb_d, ub_d = match_query_sparse_spanned(
                    dev, *q_args,
                    vote_rank=vrank if vrank != "pruned" else "sort",
                    expand_block=b, expand_runs=eruns,
                    with_bounds=True, **kw)
                raw, span_max = jax.device_get((raw_d, sm_d))
                return raw, span_max, (lb_d, ub_d)
            return jax.device_get(match_query_sparse_spanned(
                dev, *q_args,
                vote_rank=vrank if vrank != "pruned" else "sort",
                expand_block=b, expand_runs=eruns, bounds=bounds_dev,
                **kw))

        # big-store escalation policy (see _match_prepared): decided-
        # first dispatches ONCE at the match_capacity tier (stacked
        # layout; the program also returns its descent) and accepts
        # margin-certified clamps; bounds-first probes the exact global
        # total across spans and dispatches at the fitting tier.
        stacked = not isinstance(dev[0], (tuple, list))
        pol = self.config.escalation_policy
        decide_first = (pol == "decide"
                        or (pol == "auto" and self.config.decision_escalation))
        big = (min_capacity is None and self.config.bounds_probe_min_rows
               and self._spanned_rows(dev)
               >= self.config.bounds_probe_min_rows)
        if big and decide_first and stacked and eblk_s:
            cap = self._decide_cap(caps)
            raw, span_max, bounds_dev = run(cap, with_bounds=True)
            clamped = (int(span_max) > cap or int(raw.n_dropped) > 0)
            self._decide_record(
                1, int(clamped and not self._decided(raw)))
        elif big:
            if stacked:
                total_d, lb_d, ub_d = query_total_spanned(
                    dev, jnp.asarray(q.hi), jnp.asarray(q.lo),
                    jnp.asarray(q.ex), jnp.asarray(q.valid),
                    heads=heads, uviews=uviews, u_steps=usteps,
                    with_bounds=True)
                total_probe = int(jax.device_get(total_d))
                bounds_dev = (lb_d, ub_d)
            else:
                total_probe = int(jax.device_get(query_total_spanned(
                    dev, jnp.asarray(q.hi), jnp.asarray(q.lo),
                    jnp.asarray(q.ex), jnp.asarray(q.valid),
                    heads=heads, uviews=uviews, u_steps=usteps)))
            cap = next((c for c in caps if c >= total_probe), caps[-1])
            raw, span_max = run(cap)
        else:
            cap = caps[0]
            raw, span_max = run(cap)
        if int(span_max) > cap or int(raw.n_dropped) > 0:
            if self._decided(raw):
                return raw, max(int(raw.total_rows), cap)
            if int(span_max) > cap:
                cap = next((c for c in caps if c >= int(span_max)),
                           caps[-1])
                raw, span_max = run(cap)
            if eblk_s and int(raw.n_dropped) > 0 and int(span_max) <= cap:
                # stacked blocked expansion's nonempty-run budget
                # (expand_block_runs * n_spans) overflowed: no capacity
                # tier cures it — re-run through the scalar stacked
                # expansion (rare; exact either way)
                raw, span_max = run(cap, blk=0)
        if int(span_max) <= cap and int(raw.n_dropped) == 0:
            # no span clamped: every row voted; report a capacity that
            # keeps align_results' total>capacity overflow check honest
            return raw, max(int(raw.total_rows), cap)
        return raw, cap

    def recognize_clip(
        self,
        samples: np.ndarray,
        topn: Optional[int] = None,
    ) -> Dict:
        """Lowest-latency recognition of one mono clip: ONE device dispatch.

        Fingerprint, on-device query dedup, match and rank run as a single
        jitted program (see match/ondevice.py) — results identical to
        ``recognize_samples([samples])``, minus one host round trip.
        """
        from .match.ondevice import recognize_on_device

        t0 = time.time()
        samples = np.asarray(samples)
        blen = _bucket_len(len(samples))
        max_frames = (blen - self.config.window_size) // self.config.hop + 1
        if max_frames > 1 << 16:
            # >~51 min of audio: the single-dispatch dedup packs the frame
            # offset into 16 bits; route to the two-dispatch path instead
            return self.recognize_samples([samples], topn=topn)
        padded = np.zeros(blen, np.float32)
        padded[: len(samples)] = samples
        dev = self._ensure_device_index()
        delta_min, delta_range = self._delta_params_for(len(samples))
        # dedup-sort + binary-search cost is linear in query lanes: a 5 s
        # clip yields ~1-2K unique pairs, so 2K lanes cover it; longer
        # clips get 4K (overflow falls back to the two-dispatch path)
        q_cap = 2048 if len(samples) <= 6 * self.config.sample_rate else 4096

        if self._is_spanned:
            return self._recognize_clip_spanned(
                samples, padded, dev, delta_min=delta_min,
                delta_range=delta_range, q_cap=q_cap, topn=topn, t0=t0)
        n_songs_live = max(self._live_n_songs(), 1)
        one_cap = self.config.match_capacity_fast
        if (n_songs_live * delta_range > self.config.sparse_vote_threshold
                and self.config.bounds_probe_min_rows
                and self._index_rows(dev)
                >= self.config.bounds_probe_min_rows):
            # big index: at production scale every clip overflows the
            # fast tier. Decided-first ("decide"/"auto"): run the SAME
            # single-dispatch program at the match_capacity tier — a
            # clamped-but-decided result (the common case) finishes in
            # this one dispatch. "bounds": fingerprint + exact-total
            # probe in one dispatch, then ONE fitted match.
            pol = self.config.escalation_policy
            if (pol == "decide"
                    or (pol == "auto" and self.config.decision_escalation)):
                one_cap = self._decide_cap(self._match_tiers())
            else:
                return self._recognize_clip_probed(
                    samples, padded, dev, delta_min=delta_min,
                    delta_range=delta_range, q_cap=q_cap, topn=topn, t0=t0)
        head = self._ensure_head(dev)
        uview, usteps = self._ensure_uview(dev)
        raw, n_pairs, n_peaks, n_hashes = jax.device_get(recognize_on_device(
            jnp.asarray(padded)[None, :],
            jnp.asarray([len(samples)], np.int32),
            dev,
            **self._fp_kwargs(),
            n_songs=max(self._live_n_songs(), 1),
            delta_min=delta_min,
            delta_range=delta_range,
            match_capacity=one_cap,
            topn=topn or self.config.topn,
            offset_stride=self._offset_stride,
            query_capacity=q_cap,
            head=head, uview=uview, u_steps=usteps,
            rank_candidates=self.config.rank_candidates,
            sparse_threshold=self.config.sparse_vote_threshold,
            vote_rank=self._rank_for(one_cap),
            expand_block=self._eblk_for_cap(
                self._expand_block_for(dev), one_cap),
            expand_runs=self.config.expand_block_runs,
        ))
        device_time = time.time() - t0
        if (
            int(n_peaks) > self.config.peak_capacity
            or ((int(raw.total_rows) > one_cap
                 or int(raw.n_dropped) > 0)
                and not self._decided(raw))
            or int(n_hashes) > q_cap
        ):
            # overflow (peaks, query lanes, or an UNdecided clamped
            # match — see _decided: a clamped result whose top-1 margin
            # beats the excluded-run count is provably the full answer
            # and stays on this single-dispatch path): take the
            # two-dispatch path with full capacities
            return self.recognize_samples([samples], topn=topn)

        t0 = time.time()
        matched = align_results(
            raw, int(n_pairs), catalog=self.catalog, config=self.config,
            match_capacity=max(int(raw.total_rows), one_cap),
        )
        align_time = time.time() - t0
        return {
            "results": matched.results,
            "total_matches": matched.total_matches,
            "overflowed": matched.overflowed,
            "partial_counts": matched.partial_counts,
            "input_hashes": int(n_pairs),
            "fingerprint_time": device_time,  # one dispatch
            "query_time": 0.0,
            "align_time": align_time,
            "total_time": device_time + align_time,
        }

    def _recognize_clip_probed(self, samples, padded, dev, *, delta_min,
                               delta_range, q_cap, topn, t0):
        """Big-index solo recognition: fingerprint+probe, then one
        fitted match dispatch over the device-resident query pairs."""
        from .match.lookup import match_query_sparse
        from .match.ondevice import fingerprint_probe_on_device

        head = self._ensure_head(dev)
        uview, usteps = self._ensure_uview(dev)
        q_dev, n_pairs, n_peaks, n_hashes, total_d, lb_d, ub_d = \
            fingerprint_probe_on_device(
                jnp.asarray(padded)[None, :],
                jnp.asarray([len(samples)], np.int32),
                dev,
                **self._fp_kwargs(),
                query_capacity=q_cap,
                head=head, uview=uview, u_steps=usteps,
            )
        n_peaks_i, n_hashes_i = int(n_peaks), int(n_hashes)
        total = int(total_d)
        if (n_peaks_i > self.config.peak_capacity or n_hashes_i > q_cap):
            # capacity overflow (peaks or query lanes): the two-dispatch
            # path escalates those capacities
            return self.recognize_samples([samples], topn=topn)

        n_songs = max(self._live_n_songs(), 1)
        caps = self._match_tiers()
        cap = next((c for c in caps if c >= total), caps[-1])
        eblk = self._expand_block_for(dev)
        eruns = self.config.expand_block_runs

        def run(cap, blk=None):
            b = self._eblk_for_cap(eblk, cap) if blk is None else blk
            vrank = self._rank_for(cap)
            return jax.device_get(match_query_sparse(
                dev, *q_dev,
                n_songs=n_songs, delta_min=delta_min,
                delta_range=delta_range, match_capacity=cap,
                topn=topn or self.config.topn,
                offset_stride=self._offset_stride,
                head=head, uview=uview, u_steps=usteps,
                vote_rank=vrank if vrank != "pruned" else "sort",
                expand_block=b, expand_runs=eruns,
                bounds=(lb_d, ub_d)))

        raw = run(cap)
        if (int(raw.n_dropped) > 0 and not self._decided(raw)
                and total <= cap):
            # run-budget drop: scalar expansion is the exact terminal
            # fallback (total > cap means a genuine max-tier clamp —
            # handled by the honest align capacity below)
            raw = run(cap, blk=0)
        device_time = time.time() - t0

        # align capacity: max(total, cap) reads "unaffected by
        # capacity" — only when the result is exact (or provably so);
        # a max-tier clamp keeps cap so align flags the overflow
        exact = total <= cap and int(raw.n_dropped) == 0
        align_cap = (max(total, cap) if exact or self._decided(raw)
                     else cap)
        t0 = time.time()
        matched = align_results(
            raw, int(n_pairs), catalog=self.catalog, config=self.config,
            match_capacity=align_cap,
        )
        align_time = time.time() - t0
        return {
            "results": matched.results,
            "total_matches": matched.total_matches,
            "overflowed": matched.overflowed,
            "partial_counts": matched.partial_counts,
            "input_hashes": int(n_pairs),
            "fingerprint_time": device_time,  # probe + fitted dispatch
            "query_time": 0.0,
            "align_time": align_time,
            "total_time": device_time + align_time,
        }

    def _recognize_clip_spanned(self, samples, padded, dev, *, delta_min,
                                delta_range, q_cap, topn, t0):
        """Single-dispatch recognition against the spanned store."""
        from .match.ondevice import recognize_on_device_spanned

        uviews, usteps = self._span_uview()
        # the uview supersedes the bucket-CDF heads for the stacked
        # layout — skip their build (a 134M-row searchsorted per span)
        heads = None if uviews is not None else self._ensure_heads(dev)
        raw, span_max, n_pairs, n_peaks, n_hashes = jax.device_get(
            recognize_on_device_spanned(
                jnp.asarray(padded)[None, :],
                jnp.asarray([len(samples)], np.int32),
                dev,
                **self._fp_kwargs(),
                n_songs=max(self._live_n_songs(), 1),
                delta_min=delta_min,
                delta_range=delta_range,
                match_capacity=self.config.match_capacity_fast,
                topn=topn or self.config.topn,
                offset_stride=self._offset_stride,
                query_capacity=q_cap,
                heads=heads,
                uviews=uviews,
                u_steps=usteps,
                rank_candidates=self.config.rank_candidates,
                vote_rank=self._rank_for(self.config.match_capacity_fast),
            ))
        device_time = time.time() - t0
        if (
            int(n_peaks) > self.config.peak_capacity
            or ((int(span_max) > self.config.match_capacity_fast
                 or int(raw.n_dropped) > 0)
                and not self._decided(raw))
            or int(n_hashes) > q_cap
        ):
            # overflow (peaks, an UNdecided clamped span expansion, or
            # query lanes): the two-dispatch spanned path retries with
            # escalating tiers. A decided clamp (see _decided) is
            # provably the full answer and stays single-dispatch.
            return self.recognize_samples([samples], topn=topn)

        t0 = time.time()
        matched = align_results(
            raw, int(n_pairs), catalog=self.catalog, config=self.config,
            match_capacity=max(int(raw.total_rows),
                               self.config.match_capacity_fast),
        )
        align_time = time.time() - t0
        return {
            "results": matched.results,
            "total_matches": matched.total_matches,
            "overflowed": matched.overflowed,
            "partial_counts": matched.partial_counts,
            "input_hashes": int(n_pairs),
            "fingerprint_time": device_time,  # one dispatch
            "query_time": 0.0,
            "align_time": align_time,
            "total_time": device_time + align_time,
        }

    def recognize_batch(
        self,
        clips: Sequence[np.ndarray],
        topn: Optional[int] = None,
        pad_to_pow2: bool = False,
        q_pad_to: Optional[int] = None,
        match_capacity: Optional[int] = None,
    ) -> List[Dict]:
        """Recognize many mono clips in one device program (serving path).

        All clips are fingerprinted as one device batch and matched with a
        vmapped query batch — one compile, one dispatch, per-clip results
        identical to ``recognize_samples`` on each clip alone.

        ``pad_to_pow2`` rounds the batch axis up to a power of two with
        empty dummy clips: every program shape is static in clip count,
        so a serving deployment with varying micro-batch sizes compiles
        O(log max_batch) programs instead of one per size — the dummies
        cost one masked lane of compute and produce no output rows.

        ``match_capacity`` overrides the BASE dispatch tier (results are
        identical — per-clip escalation still runs on overflow). Serving
        warmups pass each tier of ``_match_tiers()`` so skewed catalogs
        (whose every batch escalates) compile the escalated-tier
        programs before the listener opens instead of inside a live
        request.

        Internally this is ``prepare_batch`` (fingerprint + host query
        prep) followed by ``match_prepared_batch`` (match dispatch +
        escalation + align) — a serving daemon can run the two stages on
        a two-deep pipeline so batch k+1 fingerprints while batch k's
        match round-trips the device (serve.MicroBatcher does).
        """
        pb = self.prepare_batch(clips, topn=topn, pad_to_pow2=pad_to_pow2,
                                q_pad_to=q_pad_to,
                                match_capacity=match_capacity)
        if pb is None:
            return []
        return self.match_prepared_batch(pb)

    def prepare_batch(
        self,
        clips: Sequence[np.ndarray],
        topn: Optional[int] = None,
        pad_to_pow2: bool = False,
        q_pad_to: Optional[int] = None,
        match_capacity: Optional[int] = None,
    ) -> Optional["_PreparedBatch"]:
        """Stage 1 of ``recognize_batch``: fingerprint the clips as one
        device batch and build the stacked host query arrays.
        Returns None for an empty batch."""
        t0 = time.time()
        n_real = len(clips)
        if n_real == 0:
            return None
        n_clips = n_real
        if pad_to_pow2:
            n_clips = 1
            while n_clips < n_real:
                n_clips <<= 1
        blen = max(_bucket_len(len(c)) for c in clips)
        batch = np.zeros((n_clips, blen), np.float32)
        n_valid = np.zeros(n_clips, np.int32)
        for i, c in enumerate(clips):
            batch[i, : len(c)] = c
            n_valid[i] = len(c)

        fp = fingerprint_batch(
            jnp.asarray(batch), jnp.asarray(n_valid),
            **self._fp_kwargs(),
        )
        hcap = int(fp.valid.shape[1])
        if n_clips * hcap >= (1 << 20):
            # download only the live hash prefix: the padded (B, 32768)
            # uint32 columns are ~40 MB per 64-clip batch while real 5 s
            # clips hold ~1-3K pairs.
            # One tiny sync reads the highest live index, then the
            # pow2-rounded prefix downloads — entries past it are
            # invalid by construction, so results are identical.
            h_last = int(jax.device_get(jnp.max(jnp.where(
                fp.valid,
                jnp.arange(hcap, dtype=jnp.uint32)[None, :] + 1,
                jnp.uint32(0)))))
            k = 1024
            while k < h_last:
                k <<= 1
            if k < hcap:
                fp = type(fp)(fp.hi[:, :k], fp.lo[:, :k], fp.ex[:, :k],
                              fp.t1[:, :k], fp.valid[:, :k], fp.n_peaks)
        fp = jax.device_get(fp)
        # Per-clip peak overflow: the batch path truncates at capacity,
        # so the clip must re-run alone
        # through recognize_samples' escalating fallback or its result
        # would silently diverge from the single-clip contract. Its batch
        # lanes are replaced with an empty query so the garbage neither
        # votes nor inflates the q_cap compile bucket.
        peak_over = {
            i for i in range(n_real)
            if int(fp.n_peaks[i]) > self.config.peak_capacity
        }
        queries = [
            prepare_query([]) if i in peak_over
            else prepare_query([_batch_fingerprints(fp, i)])
            for i in range(n_clips)
        ]
        q_cap = max(len(q.hi) for q in queries)
        if q_pad_to is not None:
            # warmup knob: precompile a larger pair bucket (see
            # recognize_samples) — padding lanes are invalid, results
            # identical
            q_cap = max(q_cap, q_pad_to)
        stack = {
            name: np.stack([
                np.pad(getattr(q, name), (0, q_cap - len(q.hi)))
                for q in queries
            ])
            for name in ("hi", "lo", "ex", "t", "valid", "first")
        }
        # stage-1 probe (see _PreparedBatch): pinned serving batches
        # (explicit match_capacity) and the "bounds" policy probe every
        # batch for bounds/tier — running it HERE lets the serving
        # pipeline overlap its device round trip with the previous
        # batch's match dispatch. Decided-first unpinned batches skip
        # the probe entirely (match_prepared_batch margin-checks).
        q_dev = probe_totals = probe_bounds = None
        pol = self.config.escalation_policy
        decide_first = (pol == "decide"
                        or (pol == "auto"
                            and self.config.decision_escalation))
        if not self._is_spanned and not decide_first \
                and self.config.bounds_probe_min_rows:
            dev = self._ensure_device_index()
            delta_min, delta_range = self._delta_params_for(
                max(len(c) for c in clips))
            use_sparse = (max(self._live_n_songs(), 1) * delta_range
                          > self.config.sparse_vote_threshold)
            if use_sparse and (self._index_rows(dev)
                               >= self.config.bounds_probe_min_rows):
                from .match.batched import query_totals_batched

                hd = self._ensure_head(dev)
                uview, usteps = self._ensure_uview(dev)
                q_dev = tuple(jnp.asarray(stack[n]) for n in
                              ("hi", "lo", "ex", "t", "valid", "first"))
                totals_d, lb_b, ub_b = query_totals_batched(
                    dev, q_dev[0], q_dev[1], q_dev[2], q_dev[4],
                    head=hd, uview=uview, u_steps=usteps)
                probe_totals = np.asarray(jax.device_get(totals_d))
                probe_bounds = (lb_b, ub_b)
        fingerprint_time = time.time() - t0
        return _PreparedBatch(
            clips=[np.asarray(c) for c in clips], queries=queries,
            stack=stack, peak_over=peak_over, topn=topn,
            match_capacity=match_capacity,
            fingerprint_time=fingerprint_time,
            q_dev=q_dev, probe_totals=probe_totals,
            probe_bounds=probe_bounds)

    def match_prepared_batch(self, pb: "_PreparedBatch") -> List[Dict]:
        """Stage 2 of ``recognize_batch``: one vmapped match dispatch
        over the prepared query stack, per-clip capacity escalation,
        host-side alignment. See ``recognize_batch`` for semantics."""
        from .match.batched import match_queries_batched

        clips, queries = pb.clips, pb.queries
        n_real = len(clips)
        topn = pb.topn
        match_capacity = pb.match_capacity
        peak_over = pb.peak_over
        fingerprint_time = pb.fingerprint_time

        t0 = time.time()
        dev = self._ensure_device_index()
        delta_min, delta_range = self._delta_params_for(
            max(len(c) for c in clips)
        )
        q_args = (pb.q_dev if pb.q_dev is not None else
                  tuple(jnp.asarray(pb.stack[n]) for n in
                        ("hi", "lo", "ex", "t", "valid", "first")))
        kw = dict(
            n_songs=max(self._live_n_songs(), 1),
            delta_min=delta_min, delta_range=delta_range,
            match_capacity=match_capacity or self.config.match_capacity,
            topn=topn or self.config.topn,
            offset_stride=self._offset_stride,
        )
        span_maxes = None
        use_sparse = (kw["n_songs"] * delta_range
                      > self.config.sparse_vote_threshold)
        eblk = (self._expand_block_for_spanned(dev) if self._is_spanned
                else self._expand_block_for(dev))
        probe_bounds = None   # batched probe's (lb, ub), device-resident
        if self._is_spanned:
            from .match.batched import match_queries_batched_spanned
        else:
            uview, usteps = self._ensure_uview(dev)

        def dispatch(cap, pruned=True):
            """One batched device program; returns (raw, span_maxes,
            oks, clamp).  ``oks`` is the per-clip pruned-rank exactness
            certificate (None on the sort/scan paths, which are
            unconditionally exact): under vmap the in-program cond
            fallback would execute both branches, so failed clips are
            instead re-dispatched solo below."""
            vrank = self._rank_for(cap)
            n_cand = (self.config.rank_candidates
                      if use_sparse and vrank == "pruned" else 0)
            sort_rank = vrank if vrank != "pruned" else "sort"
            b = self._eblk_for_cap(eblk, cap)
            kw2 = dict(kw, match_capacity=cap)
            want = pruned and n_cand > 0
            if self._is_spanned:
                # NB distinct names from the flat branch's closure
                # (uview/usteps) — assigning those here would shadow
                # them for the whole function
                s_uviews, s_usteps = self._span_uview()
                heads = (None if s_uviews is not None
                         else self._ensure_heads(dev))
                if want:
                    r, sm, oks = jax.device_get(
                        match_queries_batched_spanned(
                            dev, *q_args, heads=heads,
                            uviews=s_uviews, u_steps=s_usteps,
                            rank_candidates=n_cand, **kw2))
                else:
                    r, sm = jax.device_get(match_queries_batched_spanned(
                        dev, *q_args, heads=heads,
                        uviews=s_uviews, u_steps=s_usteps,
                        vote_rank=sort_rank, expand_block=b,
                        expand_runs=self.config.expand_block_runs,
                        **kw2))
                    oks = None
                cl = np.asarray(sm)[:n_real]
            else:
                hd = self._ensure_head(dev)
                if want:
                    r, oks = jax.device_get(match_queries_batched(
                        dev, *q_args, head=hd, uview=uview,
                        u_steps=usteps, sparse=True,
                        rank_candidates=n_cand, expand_block=b,
                        expand_runs=self.config.expand_block_runs,
                        bounds=probe_bounds, **kw2))
                else:
                    r, oks = jax.device_get(match_queries_batched(
                        dev, *q_args, head=hd, uview=uview,
                        u_steps=usteps, sparse=use_sparse,
                        vote_rank=sort_rank, expand_block=b,
                        expand_runs=self.config.expand_block_runs,
                        bounds=probe_bounds, **kw2)), None
                sm = None
                cl = np.asarray(r.total_rows)[:n_real]
            return r, sm, oks, cl

        # big-index batched escalation policy (config.escalation_policy,
        # mirroring _match_prepared):
        #
        # decided-first (unpinned "decide"/"auto"): the whole batch
        # dispatches once at the match_capacity tier with NO probe —
        # clamped clips are margin-checked by the per-clip machinery
        # below (undecided() — each excluded run adds <= 1 vote to any
        # bin) and only undecided clips re-dispatch. Saves the probe's
        # device round trip per batch.
        #
        # bounds-first (explicit match_capacity — serving pins/warmup —
        # or policy "bounds"): a cheap vmapped search-only probe reads
        # every clip's EXACT total; an unpinned batch dispatches once at
        # the fitting tier, a pinned one keeps its tier but REUSES the
        # probe's bounds — so warmup's pinned-tier programs are exactly
        # the live path's (tested: test_warmup_pinned_tier_shares_...).
        base_cap = match_capacity or self.config.match_capacity
        tiers = self._match_tiers()
        pol = self.config.escalation_policy
        # decide policy applies to PINNED batches too (serving): neither
        # warmup nor the live path probes then, so both compile the same
        # bounds-free programs and a serving batch costs ONE match
        # dispatch (margins certify clamps; outliers retry per clip)
        decide_first = (pol == "decide"
                        or (pol == "auto"
                            and self.config.decision_escalation))
        big = (not self._is_spanned and use_sparse
               and self.config.bounds_probe_min_rows
               and self._index_rows(dev)
               >= self.config.bounds_probe_min_rows)
        if big and decide_first:
            if match_capacity is None:
                base_cap = self._decide_cap(tiers)
        elif big:
            # probe runs even when match_capacity is EXPLICIT (the tier
            # stays pinned then, only the bounds are reused): serving
            # warmup pins tiers via match_capacity, and the live path's
            # programs carry bounds — probing in both keeps warmup and
            # live traffic on the SAME compiled programs. When
            # prepare_batch already probed (stage 1, pipelined behind
            # the previous batch's match), its results are reused and
            # no probe dispatch happens here.
            if pb.probe_bounds is not None:
                probe_totals = pb.probe_totals[:n_real]
                probe_bounds = pb.probe_bounds
            else:
                from .match.batched import query_totals_batched
                hd = self._ensure_head(dev)
                totals_d, lb_b, ub_b = query_totals_batched(
                    dev, q_args[0], q_args[1], q_args[2], q_args[4],
                    head=hd, uview=uview, u_steps=usteps)
                probe_totals = np.asarray(
                    jax.device_get(totals_d))[:n_real]
                probe_bounds = (lb_b, ub_b)   # device-resident
            if match_capacity is None:
                need = int(probe_totals.max()) if n_real else 0
                # HBM guard: the batched expansion+rank stream is ~6
                # int32 arrays of (cap + run-budget overhead) per clip —
                # cap the tier so the batch stays under ~4 GB; clips
                # past the guarded tier clamp and the per-clip retry
                # machinery below re-runs them solo (exact either way)
                max_stream = (4 << 30) // (24 * max(n_real, 1))
                allowed = ([c for c in tiers if c <= max_stream]
                           or tiers[:1])
                base_cap = min(next((c for c in tiers if c >= need),
                                    tiers[-1]), allowed[-1])

        raw, span_maxes, oks, clamp = dispatch(base_cap)

        # per-clip escalation: the batch runs at the base tier; a clip
        # whose expansion clamped (largest per-span count when spanned,
        # exact total otherwise — BOTH exact even when clamped) re-runs
        # at the tier its known count fits, keeping results identical to
        # recognize_samples (hyper-common hashes can own 100K+ rows and
        # every row must vote). When MOST of the batch clamps (heavily
        # duplicated catalogs, such as the 95.3M tone corpus, where a
        # typical 5 s clip expands past the base tier), one whole-batch
        # re-dispatch at the fitting tier replaces the pile of solo
        # retries — serving latency stays ~one device program per batch.
        retried: Dict[int, Tuple] = {}
        decided_ids: set = set()
        batch_cap = base_cap

        # mass certificate failure (e.g. a batch of clips that are not
        # in the catalog): ONE whole-batch sort re-dispatch replaces a
        # pile of solo retries
        if oks is not None:
            failed = np.nonzero(~np.asarray(oks)[:n_real])[0]
            if len(failed) > max(n_real // 2, 1):
                raw, span_maxes, oks, clamp = dispatch(batch_cap,
                                                       pruned=False)

        def undecided(clamped_ids):
            # provably-exact early accept per clip (see _decided): a
            # clamped clip whose top-1 margin beats its excluded-run
            # count needs no re-dispatch.  A cert-failed pruned row is
            # NOT exact — its margins must never accept.
            if not self.config.decision_escalation:
                return clamped_ids
            margin_ok = (np.asarray(raw.top_votes)[:, 0]
                         - np.asarray(raw.runner_votes)
                         > np.asarray(raw.n_dropped))[:n_real]
            if oks is not None:
                margin_ok = margin_ok & np.asarray(oks)[:n_real]
            decided_ids.update(int(i) for i in clamped_ids if margin_ok[i])
            return clamped_ids[~margin_ok[clamped_ids]]

        run_drop = np.asarray(raw.n_dropped)[:n_real] > 0
        if tiers[-1] > batch_cap:
            over = undecided(np.nonzero((clamp > batch_cap)
                                        | run_drop)[0])
            if big and decide_first and match_capacity is None:
                # feed the self-tuning decide tier (see _decide_record)
                self._decide_record(n_real, len(over))
            if len(over) > max(n_real // 2, 1):
                need = int(clamp.max())
                cand_cap = next((c for c in tiers if c >= need),
                                tiers[-1])
                # HBM guard: under vmap every clip carries a hashed
                # candidate table (<= 2^24 int32 = 64 MB) plus ~6
                # expansion arrays of cap int32. Past ~4 GB estimated
                # footprint the batch falls through to solo retries.
                # The 4 GB bound was sized for a 16 GB device beside a
                # production index; it is kept as is until re-derived
                # for larger devices.
                m_bits = min(24, max(18, (cand_cap * 16 - 1).bit_length()))
                per_clip = (1 << m_bits) * 4 + 6 * cand_cap * 4
                if n_real * per_clip <= (4 << 30):
                    batch_cap = cand_cap
                    kw["match_capacity"] = batch_cap
                    raw, span_maxes, oks, clamp = dispatch(batch_cap)
                    decided_ids.clear()  # judged against the old dispatch
                    run_drop = np.asarray(raw.n_dropped)[:n_real] > 0
                    over = undecided(np.nonzero((clamp > batch_cap)
                                                | run_drop)[0])
            for i in over:
                retried[int(i)] = self._match_prepared(
                    queries[i], len(clips[i]), topn=topn,
                    min_capacity=int(clamp[i]))

        # solo re-dispatch for remaining cert-failed rows (their pruned
        # RawMatch is not exact); the solo path's in-program cond
        # fallback makes the retry exact in one dispatch
        if oks is not None:
            okarr = np.asarray(oks)[:n_real]
            for i in np.nonzero(~okarr)[0]:
                ii = int(i)
                if ii not in retried and ii not in peak_over:
                    retried[ii] = self._match_prepared(
                        queries[ii], len(clips[ii]), topn=topn,
                        min_capacity=max(int(clamp[ii]), 1))
        query_time = time.time() - t0

        out = []
        for i in range(n_real):
            if i in peak_over:
                # full single-clip re-run (escalating peak capacity);
                # same result schema, honest per-clip stage times
                out.append(self.recognize_samples([clips[i]], topn=topn))
                continue
            t0 = time.time()
            if i in retried:
                one, cap_i = retried[i]
            else:
                one = type(raw)(*(np.asarray(a)[i] for a in raw))
                # clamp signal: largest per-span count when spanned
                # (total legitimately sums past one tier), exact total
                # otherwise. A clip whose signal fits the dispatch
                # capacity dropped nothing — report a capacity that
                # keeps align_results' total>capacity check honest.
                sig = (int(span_maxes[i]) if span_maxes is not None
                       else int(one.total_rows))
                # decided clips are provably the full answer — report
                # them unaffected by capacity like fitting clips
                cap_i = (max(int(one.total_rows), batch_cap)
                         if sig <= batch_cap or i in decided_ids
                         else batch_cap)
            matched = align_results(
                one, queries[i].n_pairs, catalog=self.catalog,
                config=self.config, match_capacity=cap_i,
            )
            align_time = time.time() - t0  # measured per clip
            out.append({
                "results": matched.results,
                "total_matches": matched.total_matches,
                "overflowed": matched.overflowed,
                "partial_counts": matched.partial_counts,
                "input_hashes": queries[i].n_pairs,
                # clips are fingerprinted/matched in ONE device program,
                # so per-clip stage times are the measured batch times
                # amortized; the batch totals are reported alongside
                "fingerprint_time": fingerprint_time / n_real,
                "query_time": query_time / n_real,
                "align_time": align_time,
                "total_time": (fingerprint_time + query_time) / n_real
                + align_time,
                "batch_fingerprint_time": fingerprint_time,
                "batch_query_time": query_time,
                "batch_size": n_real,
            })
        return out

    def recognize_file(self, path: str, limit: Optional[float] = None,
                       topn: Optional[int] = None,
                       early_exit: bool = False) -> Dict:
        channels, fs, _sha = read(path, limit)
        if fs != self.config.sample_rate:
            if not self.resample:
                raise ValueError(
                    f"{path}: sample rate {fs} != {self.config.sample_rate}")
            from .audio.resample import resample_channels

            channels = resample_channels(channels, fs, self.config.sample_rate)
        return self.recognize_samples(channels, topn=topn, early_exit=early_exit)

    def get_metadata(self, track_id: int):
        return self.catalog.get_metadata(track_id)

    def delete_songs(self, song_ids: Sequence[int]) -> int:
        """Remove songs from the catalog AND the index.

        The reference's ``DELETE_SONGS`` + ON DELETE CASCADE
        (``mysql_database.py:52-58,136-138``): catalog rows go away and
        the fingerprint index is rebuilt without the songs' hash rows.
        Returns the number of hash rows removed.
        """
        ids = set(int(s) for s in song_ids)
        self.catalog.delete_songs(ids)
        return self._drop_song_rows(ids)

    def _drop_song_rows(self, ids) -> int:
        """Rebuild the host index without ``ids``' rows; returns rows
        dropped. Shared by ``delete_songs`` and the load-time orphan
        reconcile so the rebuild stays in one place."""
        ix = self.index
        keep = ~np.isin(ix.song_id, list(ids))
        removed = int((~keep).sum())
        if removed:
            offset = ix.offset[keep]
            self.index = FingerprintIndex(
                ix.key_hi[keep], ix.key_lo[keep], ix.key_ex[keep],
                ix.song_id[keep], offset,
                n_songs=ix.n_songs,
                max_offset=int(offset.max()) if len(offset) else 0,
            )
            self._device_index = None
        return removed

    def consolidate_index(self) -> None:
        """Stack a spanned device store into the serving layout.

        ``SpannedDeviceStore.consolidate``: the matcher then vmaps over
        the span axis — one batched search round instead of an unrolled
        per-span loop.  Terminal for ingest; no-op for
        non-spanned layouts (already one search round).
        """
        if not self._is_spanned:
            return
        self._ensure_dev_store().consolidate()

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #
    def save_index(self, path: str) -> None:
        """Persist the index.

        A live spanned device store writes the span-wise format — each
        span's valid prefix, no global host sort (at 436M hashes the
        flat path's ``to_host`` lexsort costs minutes and 2x peak RAM;
        see ``SpannedDeviceStore.save``).  Everything else writes the
        flat sorted npz.
        """
        from .index.devmerge import SpannedDeviceStore

        if isinstance(self._dev_store, SpannedDeviceStore):
            self._dev_store.save(path)
            return
        self.index.save(path)

    def load_index(self, path: str, stacked: bool = False) -> None:
        """Load either index format.

        Spanned files restore straight into a spanned device store when
        this SIA is spanned (upload-only, zero sorting) and flatten on
        the host otherwise; flat files go through ``FingerprintIndex``
        (a spanned SIA re-splits them lazily on first device use).
        ``stacked=True`` (spanned SIA + spanned file only) loads the
        consolidated serving layout directly — the only way to serve
        catalogs whose live-store ``consolidate()`` would not fit in
        device memory; the store is then terminal for ingest.
        """
        from .index.devmerge import SpannedDeviceStore, is_spanned_file

        if is_spanned_file(path):
            if self._is_spanned:
                # rows go straight to device; the host-side catalog
                # reconcile would force a full download, so gate it on
                # the cheap invariant instead: every fingerprinted
                # song's total_hashes summed must equal the store's
                # valid rows (fsck checks the same identity). Equal =>
                # neither tear direction exists; a mismatch (crash or
                # unpersisted online mutation) pays the one-time host
                # sync to drop orphan rows / purge flag-only songs.
                self._dev_store = SpannedDeviceStore.load(
                    path, span_rows=self.device_span_rows,
                    stacked=stacked)
                self._host_stale = True
                self._device_index = None
                if self.catalog.counts()["n_hashes"] != self._dev_store.n_valid:
                    self._reconcile_catalog()  # torn restart only
                return
            self.index = SpannedDeviceStore.load_flat(path)
            self._device_index = None
            self._reconcile_catalog()
            return
        self.index = FingerprintIndex.load(path)
        self._device_index = None
        self._reconcile_catalog()

    def _reconcile_catalog(self) -> None:
        """Restore the durability invariant after loading an index.

        The reference's hash rows and fingerprinted flag live in one
        durable DB, so flag => rows (``__init__.py:386,424``).  Here the
        flag commits to sqlite immediately but index rows persist only
        on ``save_index`` — a crash (or a serving daemon that ingested
        online without ``--persist``) leaves songs marked fingerprinted
        with zero rows, which the SHA-1 resume dedup would then skip
        FOREVER while recognition can't match them.  Purge such songs at
        load so they simply re-ingest — the same recovery shape as the
        unfingerprinted purge at open.
        """
        if self.index is None or self.index.n_hashes == 0:
            ids_present = set()
        else:
            ids_present = set(np.unique(self.index.song_id).tolist())
        catalog_ids = {d["song_id"] for d in self.catalog.get_songs()}
        missing = [sid for sid in catalog_ids if sid not in ids_present]
        if missing:
            self.catalog.delete_songs(missing)
        # the mirror-image tear: an online delete without --persist
        # removes the sqlite row immediately but the npz keeps the hash
        # rows, so after a reload the deleted song could still WIN a
        # match (surfacing under a bare numeric name). Drop orphan rows.
        orphans = ids_present - catalog_ids
        if orphans:
            self._drop_song_rows(orphans)
