"""Transactional, chunked archive storage (Zarr + Icechunk analogue).

The reference package's store, kept as this package's own copy: the read
and commit paths, rebase, branches, tags, history, rollback, compaction
and gc, and the object-store backends.  Same chunk encoding, manifests,
stat sidecars and snapshot documents, so the same operations give the
same snapshot ids and archives interoperate.
"""

from .chunks import (ChunkGrid, chunk_stats_summary, content_hash,
                     decode_chunk, encode_chunk)
from .codecs import (
    Codec,
    UnknownCodecError,
    available_codecs,
    default_codec,
    get_codec,
    json_dumps,
    json_loads,
    register_codec,
    set_default_codec,
)
from .compaction import (
    PROFILES as COMPACTION_PROFILES,
    CompactionProfile,
    CompactionReport,
    compact,
    plan_compaction,
)
from .icechunk import (
    DEFAULT_CACHE_BYTES,
    GC_GRACE_SECONDS,
    MANIFEST_FORMAT,
    MANIFEST_SHARD_CHUNKS,
    CommitInfo,
    ConflictError,
    NotFound,
    PrefetchReport,
    Repository,
    Session,
    Transaction,
)
from .object_store import Backend, ObjectStore, SimulatedLatencyStore
from .zarrlite import Array, ArrayMeta

__all__ = [
    "Array",
    "ArrayMeta",
    "Backend",
    "COMPACTION_PROFILES",
    "ChunkGrid",
    "Codec",
    "CommitInfo",
    "CompactionProfile",
    "CompactionReport",
    "ConflictError",
    "DEFAULT_CACHE_BYTES",
    "GC_GRACE_SECONDS",
    "MANIFEST_FORMAT",
    "MANIFEST_SHARD_CHUNKS",
    "NotFound",
    "ObjectStore",
    "PrefetchReport",
    "Repository",
    "Session",
    "SimulatedLatencyStore",
    "Transaction",
    "UnknownCodecError",
    "available_codecs",
    "chunk_stats_summary",
    "compact",
    "content_hash",
    "plan_compaction",
    "decode_chunk",
    "default_codec",
    "encode_chunk",
    "get_codec",
    "json_dumps",
    "json_loads",
    "register_codec",
    "set_default_codec",
]
