"""Pluggable chunk codecs + canonical JSON serialization.

The paper (§4) treats per-array compression as a first-class design axis:
Zarr v3 lets every array pick its own codec pipeline, and the archive
records the choice in array metadata so readers decode blobs with the
codec they were written with.  This module supplies that axis for the
store: a registry of named byte codecs with stdlib-backed defaults
(``raw``, ``zlib``, ``lzma``) and ``zstd`` when the optional
``zstandard`` wheel is importable.  Nothing outside this module imports
third-party compression libraries.

It also owns the *canonical JSON* encoding that content addressing
depends on.  Snapshot and manifest ids are sha256 hashes of their JSON
documents, so the byte encoding must be deterministic and identical in
every environment: stdlib :mod:`json` with sorted keys and compact
separators.  ``orjson``, when installed, is used only as a *parse* fast
path — never for hashing — so snapshot ids cannot depend on which JSON
library happens to be installed.
"""

from __future__ import annotations

import json
import lzma
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

try:  # optional speed path; everything works without it
    import zstandard as _zstandard
except ImportError:  # pragma: no cover - env dependent
    _zstandard = None

try:  # optional parse fast path; see json_loads
    import orjson as _orjson
except ImportError:  # pragma: no cover - env dependent
    _orjson = None


class UnknownCodecError(KeyError):
    """Requested codec name is not registered in this environment."""


@dataclass(frozen=True)
class Codec:
    """A named, symmetric bytes→bytes transform."""

    name: str
    encode: Callable[[bytes], bytes]
    decode: Callable[[bytes], bytes]


_REGISTRY: Dict[str, Codec] = {}
_DEFAULT: Optional[str] = None


def register_codec(codec: Codec, *, overwrite: bool = False) -> Codec:
    """Register a codec implementation under its name."""
    if codec.name in _REGISTRY and not overwrite:
        raise ValueError(f"codec {codec.name!r} already registered")
    _REGISTRY[codec.name] = codec
    return codec


def get_codec(name: Optional[str] = None) -> Codec:
    """Look up a codec by name (``None`` → the environment default)."""
    key = name or default_codec()
    try:
        return _REGISTRY[key]
    except KeyError:
        raise UnknownCodecError(
            f"unknown codec {key!r}; available: {', '.join(available_codecs())}"
        ) from None


def available_codecs() -> Tuple[str, ...]:
    """Names of every registered codec."""
    return tuple(sorted(_REGISTRY))


def default_codec() -> str:
    """The default per-array codec.

    Deliberately ``zlib`` even when zstd is installed: the resolved codec
    name is recorded in array metadata and hashed into snapshot ids, so
    an environment-dependent default would make the same ingest produce
    different content addresses in different environments.  Opt into
    zstd explicitly via ``set_default_codec("zstd")`` or per-array
    ``codec=``.
    """
    return _DEFAULT or "zlib"


def set_default_codec(name: str) -> None:
    """Set the codec new arrays default to."""
    global _DEFAULT
    get_codec(name)  # validate before committing
    _DEFAULT = name


# -- built-ins --------------------------------------------------------------

register_codec(Codec("raw", lambda b: b, lambda b: b))
# level 1: the chunk-store write path is compress-bound (every append is a
# read-modify-write of its time chunk), so trade ratio for speed; output is
# deterministic for a given level
register_codec(Codec("zlib", lambda b: zlib.compress(b, 1), zlib.decompress))
# preset 0: lzma's fastest point — still far denser than zlib on packed radar
register_codec(
    Codec("lzma", lambda b: lzma.compress(b, preset=0), lzma.decompress)
)

if _zstandard is not None:
    # ZstdCompressor/ZstdDecompressor objects are NOT safe to share across
    # threads, and both the commit-time encode fan-out and the parallel
    # read path call codecs concurrently — keep one (de)compressor per
    # thread per level instead of module-level singletons.
    _ZSTD_TLS = threading.local()

    def _zstd_compress(data: bytes, level: int) -> bytes:
        key = f"c{level}"
        c = getattr(_ZSTD_TLS, key, None)
        if c is None:
            c = _zstandard.ZstdCompressor(level=level)
            setattr(_ZSTD_TLS, key, c)
        return c.compress(data)

    def _zstd_decompress(blob: bytes) -> bytes:
        d = getattr(_ZSTD_TLS, "d", None)
        if d is None:
            d = _zstandard.ZstdDecompressor()
            _ZSTD_TLS.d = d
        return d.decompress(blob)

    register_codec(
        Codec("zstd", lambda b: _zstd_compress(b, 3), _zstd_decompress)
    )
    # level-1 variant for write-rate-bound paths (e.g. raw volume
    # encoding); decodes with the same decompressor.  NOTE: the name must
    # fit the level2 header's 8-byte codec field.
    register_codec(
        Codec("zstd1", lambda b: _zstd_compress(b, 1), _zstd_decompress)
    )


def fast_codec() -> str:
    """Best *write-throughput* codec available (raw archive encoding)."""
    return "zstd1" if "zstd1" in _REGISTRY else "zlib"


# -- canonical JSON ---------------------------------------------------------

def json_dumps(doc: Any) -> bytes:
    """Canonical JSON bytes: sorted keys, compact separators, UTF-8.

    Always the stdlib encoder — content addresses hash these bytes, and
    they must not vary with optional dependencies or library versions.
    """
    return json.dumps(
        doc, sort_keys=True, separators=(",", ":"), ensure_ascii=False
    ).encode("utf-8")


def json_loads(blob: bytes) -> Any:
    """Parse JSON; ``orjson`` fast path when present, stdlib fallback."""
    if _orjson is not None:
        try:
            return _orjson.loads(blob)
        except _orjson.JSONDecodeError:
            pass  # e.g. NaN literals, which stdlib accepts
    return json.loads(blob)
