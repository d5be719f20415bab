"""Transactional, chunked archive storage (Zarr + Icechunk analogue).

The write and read path of the reference package's store, kept as this
package's own copy: same chunk encoding, manifests, stat sidecars and
snapshot documents, so snapshot ids agree and archives interoperate.
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
from .icechunk import (
    DEFAULT_CACHE_BYTES,
    MANIFEST_SHARD_CHUNKS,
    ConflictError,
    NotFound,
    PrefetchReport,
    Repository,
    Session,
    Transaction,
)
from .object_store import ObjectStore
from .zarrlite import Array, ArrayMeta

__all__ = [
    "Array",
    "ArrayMeta",
    "ChunkGrid",
    "Codec",
    "ConflictError",
    "DEFAULT_CACHE_BYTES",
    "MANIFEST_SHARD_CHUNKS",
    "NotFound",
    "ObjectStore",
    "PrefetchReport",
    "Repository",
    "Session",
    "Transaction",
    "UnknownCodecError",
    "available_codecs",
    "chunk_stats_summary",
    "content_hash",
    "decode_chunk",
    "default_codec",
    "encode_chunk",
    "get_codec",
    "json_dumps",
    "json_loads",
    "register_codec",
    "set_default_codec",
]
