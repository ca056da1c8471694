"""Schedule artifacts of the port: content-addressed fingerprints over the
port's compiler copy, exact-Fraction JSON serialization byte-identical to the
reference's, and the on-disk cache with compiler-versioned invalidation and
repair sidecars.  Counterpart of src/repro/cache without its zoo sweep."""
from .fingerprint import (FORMAT_VERSION, compiler_fingerprint,  # noqa: F401
                          graph_fingerprint, repair_cache_key,
                          schedule_cache_key)
from .serialize import (CACHE_SCHEMA_VERSION, SCHEDULE_KINDS,  # noqa: F401
                        SerializationError, allreduce_from_json,
                        allreduce_to_json, attach_stats, dumps_canonical,
                        ensure_claimed, schedule_from_json, schedule_to_json,
                        stats_to_payload)
from .store import CacheStats, ScheduleCache, default_cache_dir  # noqa: F401
