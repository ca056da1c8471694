"""On-disk `ScheduleCache` — compile once, replay everywhere.  Counterpart
of src/repro/cache/store.py over the port's compiler copy.

Artifacts live one-per-file under a root directory; the filename *is* the
cache key: ``{kind}-{graph_fp}-p{P}-k{K}[-r{root}]-{compiler_fp}.json``.
Because the compiler fingerprint is part of the key, editing any compiler
module silently invalidates every stale entry (old files are ignored, and
`prune_stale()` deletes them).

Hit path: read + deserialize, no compilation.  Miss path: delegate to the
`repro_torch.core.schedule` compilers (resolved at call time through the
module so tests can monkeypatch/count them), attach the claimed exact
runtime, write atomically (tmp + rename), return.

An in-memory layer sits above the disk so repeated lookups inside one
process don't even touch the filesystem.

Cache schema v5 (artifact payloads stay at the v2 format):

* each artifact gets a ``{key}.stats`` sidecar with the compiler's
  per-stage `CompileStats` (loaded back onto hits);
* all mutations (store, evict, prune, clear) run under an ``flock`` on
  ``.lock`` and maintain an advisory ``.index`` JSON of resident entries,
  so concurrent writer processes never interleave an eviction scan with a
  write or corrupt the index.  Reads stay lock-free (renames are atomic).
* repaired artifacts (v5) get a ``repair-...`` sidecar keyed by the *base*
  graph fingerprint plus the transform text.  The sidecar records the
  `RepairReport` (``repair_time_s`` et al.) and points at the repaired
  artifact, which lives under its natural degraded-topology key — so a
  later cold compile of the degraded spec hits the byte-identical repaired
  entry, and a later repair of the same (base, transform) pair returns
  without touching the compiler.  Dangling sidecars (artifact evicted)
  degrade to a miss.
  Directories written by an older cache load fine — no sidecar means no
  stats / no repair metadata.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from fractions import Fraction
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

try:
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX fallback, advisory only
    fcntl = None

from repro_torch.core import schedule as schedule_mod
from repro_torch.core.graph import DiGraph
from repro_torch.core.schedule import AllReduceSchedule, PipelineSchedule

from .fingerprint import (compiler_fingerprint, repair_cache_key,
                          schedule_cache_key)
from .serialize import (CACHE_SCHEMA_VERSION, REPAIR_FORMAT,
                        allreduce_from_json, allreduce_to_json, attach_stats,
                        schedule_from_json, schedule_to_json,
                        stats_to_payload)

Artifact = Union[PipelineSchedule, AllReduceSchedule]

INDEX_FORMAT = "repro.schedule_cache_index"


def default_cache_dir() -> str:
    """$REPRO_TORCH_SCHEDULE_CACHE, else ~/.cache/repro_torch/schedules: a
    directory of its own, since `prune_stale` deletes every artifact of
    another compiler fingerprint, the reference's included."""
    env = os.environ.get("REPRO_TORCH_SCHEDULE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "schedules")


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0
    evictions: int = 0

    def describe(self) -> str:
        return (f"hits={self.hits} misses={self.misses} puts={self.puts} "
                f"evictions={self.evictions}")


class ScheduleCache:
    """Content-addressed on-disk store of compiled schedule artifacts.

    One artifact per file; the filename is the cache key (kind × graph
    fingerprint × chunk count × compiler fingerprint).  `max_bytes` turns on
    size-capped LRU eviction: every disk hit refreshes the artifact's mtime,
    and after each write the least-recently-used artifacts are deleted until
    the directory fits the cap (the just-written artifact is never evicted,
    so a single oversized schedule still caches)."""

    def __init__(self, root: Union[str, Path, None] = None,
                 compiler_fp: Optional[str] = None,
                 verify_on_compile: bool = False,
                 max_bytes: Optional[int] = None):
        self.root = Path(root if root is not None else default_cache_dir())
        self.root.mkdir(parents=True, exist_ok=True)
        self.compiler_fp = compiler_fp or compiler_fingerprint()
        self.verify_on_compile = verify_on_compile
        self.max_bytes = max_bytes
        self.stats = CacheStats()
        self._memory: Dict[str, Artifact] = {}

    # ------------------------------------------------------------------ #
    # key / path plumbing
    # ------------------------------------------------------------------ #

    def key(self, kind: str, topo: DiGraph, num_chunks: int,
            fixed_k: Optional[int] = None, root: Optional[int] = None) -> str:
        return schedule_cache_key(kind, topo, num_chunks, fixed_k=fixed_k,
                                  root=root, compiler_fp=self.compiler_fp)

    def path_for(self, key: str) -> Path:
        return self.root / f"{key}.json"

    def stats_path_for(self, key: str) -> Path:
        """The compile-stats sidecar (no .json suffix, so artifact globs
        and the LRU size accounting never see it)."""
        return self.root / f"{key}.stats"

    # ------------------------------------------------------------------ #
    # cross-process serialization: flock + advisory index
    # ------------------------------------------------------------------ #

    @contextlib.contextmanager
    def _locked(self):
        """Exclusive flock over the cache directory's mutations.  Advisory:
        readers never take it (atomic renames keep reads torn-write-free),
        and on platforms without fcntl it degrades to a no-op."""
        if fcntl is None:
            yield
            return
        with open(self.root / ".lock", "a+") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)

    def _index_path(self) -> Path:
        return self.root / ".index"

    def _read_index(self) -> Dict[str, Dict]:
        """The advisory entry index ({key: {bytes, kind}}).  Never trusted
        for correctness — a missing or corrupt index is just rebuilt."""
        try:
            doc = json.loads(self._index_path().read_text())
            if doc.get("format") == INDEX_FORMAT:
                return dict(doc.get("entries", {}))
        except (OSError, ValueError):
            pass
        return {}

    def _write_index(self, entries: Dict[str, Dict]) -> None:
        doc = {"format": INDEX_FORMAT, "version": CACHE_SCHEMA_VERSION,
               "compiler": self.compiler_fp, "entries": entries}
        self._atomic_write(self._index_path(), json.dumps(doc, sort_keys=True))

    def _index_update(self, add: Optional[Dict[str, Dict]] = None,
                      drop: Sequence[str] = ()) -> None:
        entries = self._read_index()
        for key in drop:
            entries.pop(key, None)
        for key, info in (add or {}).items():
            entries[key] = info
        self._write_index(entries)

    def index(self) -> Dict[str, Dict]:
        """Advisory {key: {bytes, kind}} of resident artifacts, maintained
        under the flock by every writer."""
        return self._read_index()

    def rebuild_index(self) -> Dict[str, Dict]:
        """Reconstruct the index from the directory contents (run under the
        lock so a concurrent writer can't interleave)."""
        with self._locked():
            entries = {}
            for p in self.root.glob("*.json"):
                try:
                    entries[p.stem] = {"bytes": p.stat().st_size,
                                       "kind": p.stem.split("-", 1)[0]}
                except OSError:
                    continue
            self._write_index(entries)
            return entries

    def _unlink_entry(self, key: str) -> None:
        """Delete an artifact and its stats sidecar (lock held by caller
        when racing writers matter)."""
        for path in (self.path_for(key), self.stats_path_for(key)):
            try:
                path.unlink()
            except OSError:
                pass

    def _load(self, key: str, allreduce: bool) -> Optional[Artifact]:
        if key in self._memory:
            self.stats.hits += 1
            self._touch(key)          # memory hits still count as LRU use
            return self._memory[key]
        path = self.path_for(key)
        if not path.exists():
            self.stats.misses += 1
            return None
        try:
            text = path.read_text()
            art: Artifact = (allreduce_from_json(text) if allreduce
                             else schedule_from_json(text))
        except Exception as e:  # noqa: BLE001 — any unreadable artifact
            # torn write / corrupt artifact: drop it and recompile rather
            # than brick every consumer of this cache directory
            import warnings
            warnings.warn(f"discarding unreadable schedule artifact "
                          f"{path.name}: {e}")
            with self._locked():
                self._unlink_entry(key)
                self._index_update(drop=[key])
            self.stats.misses += 1
            return None
        stats_path = self.stats_path_for(key)
        if stats_path.exists():
            try:
                attach_stats(art, json.loads(stats_path.read_text()))
            except (OSError, ValueError):
                pass                  # sidecar is diagnostics only
        self._touch(key)              # LRU recency = file mtime
        self._memory[key] = art
        self.stats.hits += 1
        return art

    def _touch(self, key: str) -> None:
        if self.max_bytes is None:
            return
        try:
            os.utime(self.path_for(key))
        except OSError:
            pass

    def _store(self, key: str, art: Artifact) -> None:
        text = (allreduce_to_json(art) if isinstance(art, AllReduceSchedule)
                else schedule_to_json(art))
        stats_payload = stats_to_payload(art)
        path = self.path_for(key)
        with self._locked():
            self._atomic_write(path, text)
            if stats_payload is not None:
                self._atomic_write(self.stats_path_for(key),
                                   json.dumps(stats_payload, sort_keys=True)
                                   + "\n")
            kind = ("allreduce" if isinstance(art, AllReduceSchedule)
                    else art.kind)
            self._index_update(add={key: {"bytes": len(text), "kind": kind}})
            if self.max_bytes is not None:
                self._evict_lru(keep=path)
        self._memory[key] = art
        self.stats.puts += 1

    def _atomic_write(self, path: Path, text: str) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def size_bytes(self) -> int:
        """Total bytes of artifacts currently on disk (concurrent deletions
        by other processes are skipped, like in `_evict_lru`)."""
        total = 0
        for p in self.root.glob("*.json"):
            try:
                total += p.stat().st_size
            except OSError:
                continue
        return total

    def _evict_lru(self, keep: Path) -> int:
        """Delete least-recently-used artifacts (and their stats sidecars)
        until the directory fits `max_bytes`.  `keep` (the artifact just
        written) is exempt.  Caller holds the flock."""
        files = []
        for p in self.root.glob("*.json"):
            try:
                st = p.stat()
            except OSError:
                continue
            files.append((st.st_mtime, st.st_size, p))
        total = sum(sz for _, sz, _ in files)
        removed = 0
        dropped: List[str] = []
        for _, sz, p in sorted(files):
            if total <= self.max_bytes:
                break
            if p == keep:
                continue
            try:
                p.unlink()
            except OSError:
                continue
            try:
                self.stats_path_for(p.stem).unlink()
            except OSError:
                pass
            self._memory.pop(p.stem, None)
            dropped.append(p.stem)
            total -= sz
            removed += 1
            self.stats.evictions += 1
        if dropped:
            self._index_update(drop=dropped)
        return removed

    # ------------------------------------------------------------------ #
    # cached compilers
    # ------------------------------------------------------------------ #

    def allgather(self, topo: DiGraph, num_chunks: int = 8,
                  fixed_k: Optional[int] = None) -> PipelineSchedule:
        key = self.key("allgather", topo, num_chunks, fixed_k)
        hit = self._load(key, allreduce=False)
        if hit is not None:
            return hit
        sched = schedule_mod.compile_allgather(
            topo, num_chunks=num_chunks, fixed_k=fixed_k,
            verify=self.verify_on_compile)
        self._store(key, sched)
        return sched

    def reduce_scatter(self, topo: DiGraph, num_chunks: int = 8,
                       fixed_k: Optional[int] = None) -> PipelineSchedule:
        key = self.key("reduce_scatter", topo, num_chunks, fixed_k)
        hit = self._load(key, allreduce=False)
        if hit is not None:
            return hit
        sched = schedule_mod.compile_reduce_scatter(
            topo, num_chunks=num_chunks, fixed_k=fixed_k,
            verify=self.verify_on_compile)
        self._store(key, sched)
        return sched

    def alltoall(self, topo: DiGraph, num_chunks: int = 8,
                 fixed_k: Optional[int] = None) -> PipelineSchedule:
        key = self.key("alltoall", topo, num_chunks, fixed_k)
        hit = self._load(key, allreduce=False)
        if hit is not None:
            return hit
        sched = schedule_mod.compile_alltoall(
            topo, num_chunks=num_chunks, fixed_k=fixed_k,
            verify=self.verify_on_compile)
        self._store(key, sched)
        return sched

    def allreduce(self, topo: DiGraph, num_chunks: int = 8,
                  fixed_k: Optional[int] = None) -> AllReduceSchedule:
        key = self.key("allreduce", topo, num_chunks, fixed_k)
        hit = self._load(key, allreduce=True)
        if hit is not None:
            return hit
        ar = schedule_mod.compile_allreduce(
            topo, num_chunks=num_chunks, fixed_k=fixed_k,
            verify=self.verify_on_compile)
        self._store(key, ar)
        return ar

    def broadcast(self, topo: DiGraph, root: int,
                  num_chunks: int = 8) -> PipelineSchedule:
        key = self.key("broadcast", topo, num_chunks, root=root)
        hit = self._load(key, allreduce=False)
        if hit is not None:
            return hit
        sched = schedule_mod.compile_broadcast(topo, root=root,
                                               num_chunks=num_chunks,
                                               verify=self.verify_on_compile)
        self._store(key, sched)
        return sched

    def reduce(self, topo: DiGraph, root: int,
               num_chunks: int = 8) -> PipelineSchedule:
        key = self.key("reduce", topo, num_chunks, root=root)
        hit = self._load(key, allreduce=False)
        if hit is not None:
            return hit
        sched = schedule_mod.compile_reduce(topo, root=root,
                                            num_chunks=num_chunks,
                                            verify=self.verify_on_compile)
        self._store(key, sched)
        return sched

    def family(self, topo: DiGraph, kinds: Sequence[str],
               num_chunks: int = 8, fixed_k: Optional[int] = None,
               root: Optional[int] = None,
               timings: Optional[Dict[str, float]] = None
               ) -> Dict[str, Artifact]:
        """Cached `plan.compile_family`: load every hit, then compile all
        remaining kinds **together** so the misses share solve/split/pack
        products instead of compiling independently.  Keys are identical to
        the per-kind methods', so family- and per-kind lookups share
        entries.  Rooted kinds need `root`; `fixed_k` applies to the
        allgather family only.  A `timings` dict receives per-kind wall
        seconds (load time for hits, marginal compile time for misses)."""
        import time as _time
        out: Dict[str, Artifact] = {}
        missing: List[tuple] = []
        for kind in kinds:
            rooted = kind in ("broadcast", "reduce")
            key = self.key(kind, topo, num_chunks,
                           fixed_k=None if rooted else fixed_k,
                           root=root if rooted else None)
            t0 = _time.perf_counter()
            hit = self._load(key, allreduce=kind == "allreduce")
            if hit is not None:
                out[kind] = hit
                if timings is not None:
                    timings[kind] = _time.perf_counter() - t0
            else:
                missing.append((kind, key))
        if missing:
            from repro_torch.core import plan as plan_mod
            compiled = plan_mod.compile_family(
                topo, kinds=[k for k, _ in missing], num_chunks=num_chunks,
                root=root, fixed_k=fixed_k, verify=self.verify_on_compile,
                timings=timings)
            for kind, key in missing:
                self._store(key, compiled[kind])
                out[kind] = compiled[kind]
        return out

    # ------------------------------------------------------------------ #
    # repaired artifacts (schema v5)
    # ------------------------------------------------------------------ #

    @staticmethod
    def artifact_meta(art: Artifact) -> tuple:
        """(kind, num_chunks, root) of an artifact — the key coordinates
        shared by the base schedule and any repair of it."""
        if isinstance(art, AllReduceSchedule):
            return "allreduce", art.rs.num_chunks, None
        return art.kind, art.num_chunks, art.root

    def repair_key(self, base_art: Artifact, transform) -> str:
        kind, num_chunks, root = self.artifact_meta(base_art)
        return repair_cache_key(kind, base_art.topo, transform, num_chunks,
                                root=root, compiler_fp=self.compiler_fp)

    def repair_path_for(self, key: str) -> Path:
        """The transform-keyed repair sidecar (no .json suffix, so artifact
        globs and the LRU size accounting never see it)."""
        return self.root / f"{key}.repair"

    def repaired(self, base_art: Artifact, transform):
        """Look up a cached repair of `base_art` under `transform`.

        Returns ``(artifact, meta)`` on a hit — `meta` is the sidecar dict
        whose ``report`` entry is the original `RepairReport.to_dict()` —
        or ``None`` when there is no sidecar or the artifact it points at
        has been evicted."""
        rkey = self.repair_key(base_art, transform)
        path = self.repair_path_for(rkey)
        try:
            meta = json.loads(path.read_text())
        except (OSError, ValueError):
            return None
        if meta.get("format") != REPAIR_FORMAT:
            return None
        kind = meta.get("kind")
        art = self._load(meta.get("artifact_key", ""),
                         allreduce=kind == "allreduce")
        if art is None:
            return None
        return art, meta

    def put_repaired(self, base_art: Artifact, transform,
                     repaired_art: Artifact, report) -> str:
        """Store a repaired artifact plus its transform-keyed sidecar.

        The artifact itself goes under its natural degraded-topology key
        (`_store`), so ordinary `schedule()` lookups of the degraded spec
        hit it too; the sidecar ties (base fingerprint, transform) to that
        key and carries the repair report.  Returns the sidecar key."""
        kind, num_chunks, root = self.artifact_meta(base_art)
        akey = self.key(kind, repaired_art.topo, num_chunks,
                        root=None if root is None else repaired_art.root)
        self._store(akey, repaired_art)
        rkey = self.repair_key(base_art, transform)
        doc = {"format": REPAIR_FORMAT, "version": CACHE_SCHEMA_VERSION,
               "kind": kind, "artifact_key": akey,
               "base_fingerprint": base_art.topo.fingerprint(),
               "transform": str(transform),
               "report": report.to_dict() if report is not None else None}
        with self._locked():
            self._atomic_write(self.repair_path_for(rkey),
                               json.dumps(doc, sort_keys=True) + "\n")
        return rkey

    # ------------------------------------------------------------------ #
    # maintenance
    # ------------------------------------------------------------------ #

    def entries(self) -> List[str]:
        return sorted(p.stem for p in self.root.glob("*.json"))

    def prune_stale(self) -> int:
        """Delete artifacts written by a different compiler fingerprint."""
        removed = 0
        with self._locked():
            dropped = []
            for p in self.root.glob("*.json"):
                if not p.stem.endswith(self.compiler_fp):
                    self._unlink_entry(p.stem)
                    dropped.append(p.stem)
                    removed += 1
            for p in self.root.glob("*.repair"):
                if not p.stem.endswith(self.compiler_fp):
                    try:
                        p.unlink()
                    except OSError:
                        pass
            if dropped:
                self._index_update(drop=dropped)
        return removed

    def clear(self) -> None:
        with self._locked():
            for p in list(self.root.glob("*.json")) + \
                    list(self.root.glob("*.stats")) + \
                    list(self.root.glob("*.repair")):
                try:
                    p.unlink()
                except OSError:
                    pass
            self._write_index({})
        self._memory.clear()

    def describe(self) -> str:
        return (f"ScheduleCache[{self.root}] compiler={self.compiler_fp} "
                f"entries={len(self.entries())} {self.stats.describe()}")
