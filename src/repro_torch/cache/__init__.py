"""Schedule artifacts of the port: content-addressed fingerprints over the
port's compiler copy, exact-Fraction JSON serialization byte-identical to the
reference's, the on-disk cache with compiler-versioned invalidation and
repair sidecars, and the topology-zoo sweep.  Counterpart of
src/repro/cache."""
from .fingerprint import (FORMAT_VERSION, compiler_fingerprint,  # noqa: F401
                          graph_fingerprint, repair_cache_key,
                          schedule_cache_key)
from .serialize import (CACHE_SCHEMA_VERSION, SCHEDULE_KINDS,  # noqa: F401
                        SerializationError, allreduce_from_json,
                        allreduce_to_json, attach_stats, dumps_canonical,
                        ensure_claimed, schedule_from_json, schedule_to_json,
                        stats_to_payload)
from .store import CacheStats, ScheduleCache, default_cache_dir  # noqa: F401
from .sweep import (ALLTOALL_CHUNKS, COLLECTIVES,  # noqa: F401
                    FIXED_K_COLLECTIVES, LARGE_NAMES, PERF_GATE_NAMES,
                    SMOKE_NAMES, claim_mismatches, default_out_path,
                    run_sweep, sweep_one, sweep_registry)
