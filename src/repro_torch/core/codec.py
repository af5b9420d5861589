"""Binary entry codec: compact framing + lazy decode for the bus data plane.

Every durable backend and the wire protocol historically carried entries as
JSON text (``Payload.to_json`` with ``sort_keys=True``) that every process
fully re-parsed on every read. This module replaces that with a compact
binary **entry frame** shared by SqliteBus blobs, KvBus segment files, and
the NetBus wire (negotiated at ``hello``; see ``docs/bus-protocol.md``):

``FRAME_VERSION`` = 1 frame layout (all integers big-endian)::

    offset  size  field
    0       1     frame version        (FRAME_VERSION)
    1       1     body codec           (BODY_JSON = 0 | BODY_MSGPACK = 1)
    2       1     payload type tag     (index into entries.ALL_TYPES)
    3       8     position             (uint64)
    11      8     realtime_ts          (float64)
    19      4     body length in bytes (uint32)
    23      ...   body                 (msgpack or UTF-8 JSON object)

The 23-byte header answers ``position``/``type``/"skip to next entry"
without touching the body, which is what makes **lazy decode** possible:
``decode_entries`` returns ``LazyEntry`` objects whose payload body is a
raw buffer slice (zero-copy over an ``mmap``'d segment file) that is only
deserialized on first ``.body`` access. A ``types=`` push-down filter or a
fold that only looks at positions therefore never pays body decode for
entries it does not consume.

Body codec selection: msgpack when importable (the compact default), JSON
otherwise — and ``LOGACT_CODEC=json`` in the environment forces the JSON
body codec everywhere (the CI matrix leg guarding the legacy fallback).
The codec byte travels **per entry**, so logs and wire streams may mix
bodies freely; every reader decodes what the byte says, not what its own
default is.

Type tags are the index into ``entries.ALL_TYPES`` — i.e. the declaration
order of ``PayloadType``. New payload types must therefore only ever be
APPENDED to the enum (the same append-only rule the wire protocol's
versioning section imposes).

``DECODES`` counts body deserializations process-wide; tests and the codec
micro-bench use it to prove that filtered-out / untouched entries are never
decoded.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Iterable, List, Optional, Sequence

from .entries import ALL_TYPES, Entry, Payload, PayloadType, _json_default

try:  # msgpack is optional: the codec falls back to JSON bodies without it
    import msgpack  # type: ignore

    HAVE_MSGPACK = True
except ModuleNotFoundError:  # pragma: no cover - exercised via LOGACT_CODEC
    msgpack = None  # type: ignore
    HAVE_MSGPACK = False

#: Frame layout version (the first header byte). Breaking layout changes
#: bump this; readers reject unknown versions instead of misparsing.
FRAME_VERSION = 1

#: Body codec ids (second header byte; travels per entry).
BODY_JSON = 0
BODY_MSGPACK = 1

_HEADER = struct.Struct(">BBBQdI")
HEADER_SIZE = _HEADER.size  # 23 bytes

#: PayloadType <-> one-byte tag. Tag = declaration order of the enum, so
#: the mapping is stable as long as new types are only appended.
TYPE_TAGS: Dict[PayloadType, int] = {t: i for i, t in enumerate(ALL_TYPES)}
TAG_TYPES: tuple = tuple(ALL_TYPES)


class CodecError(ValueError):
    """Corrupt or unsupported entry frame."""


class _DecodeStats:
    """Process-wide body-decode counter (test/bench instrumentation)."""

    __slots__ = ("bodies",)

    def __init__(self) -> None:
        self.bodies = 0

    def reset(self) -> None:
        self.bodies = 0


DECODES = _DecodeStats()


def legacy_json_mode() -> bool:
    """``LOGACT_CODEC=json`` forces the **legacy JSON formats end-to-end**:
    SqliteBus stores JSON text rows, KvBus writes whole-object ``.json``
    segments, and NetBus/BusServer neither offer nor accept the binary wire
    codec. This is the CI matrix leg's switch, guarding every fallback path
    a pre-codec peer or an old on-disk log still exercises."""
    return os.environ.get("LOGACT_CODEC", "").lower() == "json"


def default_body_codec() -> int:
    """The body codec new entries are written with: msgpack when available,
    unless ``LOGACT_CODEC=json`` forces the legacy-compatible JSON bodies."""
    if not HAVE_MSGPACK or os.environ.get("LOGACT_CODEC", "").lower() == "json":
        return BODY_JSON
    return BODY_MSGPACK


def encode_body(body: Dict[str, Any], body_codec: int) -> bytes:
    if body_codec == BODY_MSGPACK:
        return msgpack.packb(body, default=_json_default, use_bin_type=True)
    if body_codec == BODY_JSON:
        return json.dumps(body, separators=(",", ":"),
                          default=_json_default).encode()
    raise CodecError(f"unknown body codec {body_codec}")


def decode_body(raw: "bytes | memoryview", body_codec: int) -> Dict[str, Any]:
    """Deserialize one body (the single choke point ``DECODES`` counts)."""
    DECODES.bodies += 1
    if body_codec == BODY_MSGPACK:
        if not HAVE_MSGPACK:  # a msgpack log read by a json-only process
            raise CodecError("entry body is msgpack but msgpack is not "
                             "importable in this process")
        return msgpack.unpackb(raw, raw=False, strict_map_key=False)
    if body_codec == BODY_JSON:
        return json.loads(bytes(raw) if isinstance(raw, memoryview) else raw)
    raise CodecError(f"unknown body codec {body_codec}")


# ---------------------------------------------------------------------------
# Lazy payload / entry: body stays raw bytes until first field access
# ---------------------------------------------------------------------------

class LazyPayload:
    """Duck-types ``entries.Payload``: ``type`` is eager (it came from the
    frame header), ``body`` deserializes on first access and is memoized.
    The raw buffer is retained after decode so re-encoding to the same body
    codec (server pass-through, segment compaction) is a copy, not a
    serialize."""

    __slots__ = ("type", "_codec", "_raw", "_body")

    def __init__(self, type: PayloadType, body_codec: int,
                 raw: "bytes | memoryview") -> None:
        self.type = type
        self._codec = body_codec
        self._raw = raw
        self._body: Optional[Dict[str, Any]] = None

    @property
    def body(self) -> Dict[str, Any]:
        if self._body is None:
            self._body = decode_body(self._raw, self._codec)
        return self._body

    @property
    def decoded(self) -> bool:
        """True once the body has been deserialized (instrumentation)."""
        return self._body is not None

    def raw_body(self, body_codec: int) -> Optional[bytes]:
        """The encoded body bytes if already held in ``body_codec`` (the
        zero-recode fast path), else None."""
        if self._codec == body_codec:
            return (self._raw if isinstance(self._raw, bytes)
                    else bytes(self._raw))
        return None

    def to_json(self) -> str:
        return json.dumps({"type": self.type.value, "body": self.body},
                          sort_keys=True, default=_json_default)

    def __eq__(self, other: Any) -> bool:
        try:
            return self.type == other.type and self.body == other.body
        except AttributeError:
            return NotImplemented

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "decoded" if self.decoded else f"raw:{len(self._raw)}B"
        return f"LazyPayload({self.type.value}, {state})"


class LazyEntry(Entry):
    """An ``Entry`` whose payload is a ``LazyPayload``. Everything the hot
    paths touch — ``position``, ``type``, skipping — comes from the frame
    header; the body stays an undecoded buffer slice until ``.body`` (or
    ``to_dict``/``to_json``) is accessed. Compares equal to an eager
    ``Entry`` with the same fields."""

    __slots__ = ()

    def __eq__(self, other: Any) -> bool:
        try:
            return (self.position == other.position
                    and self.realtime_ts == other.realtime_ts
                    and self.payload == other.payload)
        except AttributeError:
            return NotImplemented

    __hash__ = None  # type: ignore[assignment]  # bodies are dicts


# ---------------------------------------------------------------------------
# Frame encode / decode
# ---------------------------------------------------------------------------

def encode_frame(position: int, realtime_ts: float, type: PayloadType,
                 payload: "Payload | LazyPayload",
                 body_codec: Optional[int] = None) -> bytes:
    """One entry frame. If ``payload`` is a ``LazyPayload`` still holding
    raw bytes in the requested codec, those bytes are reused verbatim (no
    decode/re-encode round-trip on pass-through paths)."""
    bc = default_body_codec() if body_codec is None else body_codec
    raw = payload.raw_body(bc) if isinstance(payload, LazyPayload) else None
    if raw is None:
        raw = encode_body(payload.body, bc)
    return _HEADER.pack(FRAME_VERSION, bc, TYPE_TAGS[type],
                        position, realtime_ts, len(raw)) + raw


def encode_entry(e: Entry, body_codec: Optional[int] = None) -> bytes:
    return encode_frame(e.position, e.realtime_ts, e.payload.type,
                        e.payload, body_codec)


def encode_entries(entries: Iterable[Entry],
                   body_codec: Optional[int] = None) -> bytes:
    """Concatenated entry frames (a KvBus segment / a wire entries blob)."""
    bc = default_body_codec() if body_codec is None else body_codec
    return b"".join(encode_entry(e, bc) for e in entries)


def encode_payloads(payloads: Sequence["Payload | LazyPayload"],
                    body_codec: Optional[int] = None) -> bytes:
    """Payload frames for the wire's binary ``append``: positions are not
    assigned yet, so each frame carries its batch index as the position
    (and ts 0.0) — the server assigns the real values at append time."""
    bc = default_body_codec() if body_codec is None else body_codec
    return b"".join(encode_frame(i, 0.0, p.type, p, bc)
                    for i, p in enumerate(payloads))


def decode_entries(buf: "bytes | bytearray | memoryview",
                   start: Optional[int] = None, end: Optional[int] = None,
                   types: Optional[frozenset] = None,
                   lazy: bool = True) -> List[Entry]:
    """Parse concatenated entry frames. ``start``/``end``/``types`` filter
    on the header alone — the bodies of filtered-out entries are never
    touched (and with ``lazy=True``, surviving bodies stay undecoded buffer
    slices until first access: zero-copy over an mmap)."""
    mv = memoryview(buf)
    out: List[Entry] = []
    off, n = 0, len(mv)
    # Hot loop: this is every read on every backend. Locals for the
    # per-frame lookups, and object construction bypasses __init__ —
    # Entry is a frozen dataclass, so its generated __init__ routes each
    # field through object.__setattr__ anyway; doing that directly (and
    # filling LazyPayload's slots in place) is ~35% faster end-to-end.
    unpack, hsize, tag_types = _HEADER.unpack_from, HEADER_SIZE, TAG_TYPES
    n_tags = len(tag_types)
    new_lp, new_le = LazyPayload.__new__, LazyEntry.__new__
    setattr_ = object.__setattr__
    append = out.append
    while off < n:
        if off + hsize > n:
            raise CodecError(f"truncated entry header at offset {off}")
        version, bc, tag, pos, ts, blen = unpack(mv, off)
        if version != FRAME_VERSION:
            raise CodecError(f"unknown frame version {version} at {off}")
        if tag >= n_tags:
            raise CodecError(f"unknown payload type tag {tag} at {off}")
        body_off = off + hsize
        off = body_off + blen
        if off > n:
            raise CodecError(f"truncated entry body at offset {body_off}")
        if start is not None and pos < start:
            continue
        if end is not None and pos >= end:
            continue
        ptype = tag_types[tag]
        if types is not None and ptype not in types:
            continue
        if lazy:
            lp = new_lp(LazyPayload)
            lp.type = ptype
            lp._codec = bc
            lp._raw = mv[body_off:off]
            lp._body = None
            le = new_le(LazyEntry)
            setattr_(le, "position", pos)
            setattr_(le, "realtime_ts", ts)
            setattr_(le, "payload", lp)
            append(le)
        else:
            append(Entry(pos, ts,
                         Payload(ptype, decode_body(mv[body_off:off], bc))))
    return out


def decode_payloads(buf: "bytes | memoryview") -> List[LazyPayload]:
    """The wire's binary ``append``: payload frames back to (lazy) payloads,
    in frame order. Type checks (ACL) need only the headers."""
    return [e.payload for e in decode_entries(buf, lazy=True)]


# ---------------------------------------------------------------------------
# Payload blobs (SqliteBus column format): 1 codec byte + body bytes
# ---------------------------------------------------------------------------

def payload_blob(payload: "Payload | LazyPayload",
                 body_codec: Optional[int] = None) -> bytes:
    """SqliteBus's stored payload: the type lives in its own indexed column,
    so the blob is just ``codec byte + body bytes``."""
    bc = default_body_codec() if body_codec is None else body_codec
    raw = (payload.raw_body(bc) if isinstance(payload, LazyPayload)
           else None)
    if raw is None:
        raw = encode_body(payload.body, bc)
    return bytes((bc,)) + raw


def payload_from_blob(type: PayloadType,
                      blob: "bytes | memoryview") -> LazyPayload:
    if len(blob) < 1:
        raise CodecError("empty payload blob")
    mv = memoryview(blob)
    return LazyPayload(type, mv[0], mv[1:])
