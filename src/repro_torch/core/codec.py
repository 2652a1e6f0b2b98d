"""Key/value codec for the public store API.

The FUSEE protocol machinery (client.py / sim.py) works on 64-bit integer
keys and word-list values — the granularity at which RDMA verbs, RACE
fingerprints, and the embedded log operate.  This module is the boundary
between user-facing **bytes/str keys and variable-length byte values** and
that word-level substrate:

* keys: arbitrary ``bytes``/``str`` are hashed to a 64-bit key with a
  SplitMix64-based byte hash (the same avalanche core as
  ``layout.hash64``, which then derives RACE bucket pair + fingerprint).
  Integer keys pass through unchanged so protocol-level tests and
  benchmarks can still address slots deterministically.
* values: ``bytes``/``str`` are packed into 8-byte little-endian words
  behind a tagged header word carrying the byte length, so decode can
  recover the exact byte string (including lengths not divisible by 8).
  Plain word lists (``list[int]``) pass through untagged — the legacy
  representation used by the protocol benchmarks.

The header tag occupies the top 16 bits of word 0; a value that round-trips
through ``encode_value`` always starts with it, and ``decode_value`` falls
back to returning the raw word list when the tag is absent.
"""
from __future__ import annotations

from typing import List, Optional, Union

from . import layout as L

Key = Union[bytes, str, int]
Value = Union[bytes, str, List[int]]

_MASK64 = (1 << 64) - 1
VALUE_TAG = 0xB5EE            # 16-bit magic in the header word's top bits
_TAG_SHIFT = 48
_LEN_MASK = (1 << 40) - 1     # byte length field (plenty for slab objects)


class CodecError(TypeError, ValueError):
    """Typed error for anything the codec boundary rejects: non-key types,
    ambiguous raw word lists that masquerade as tagged byte payloads, and
    (in strict decode) malformed tags.  Subclasses both TypeError and
    ValueError so legacy ``except`` clauses keep working."""


def encode_key(key: Key) -> int:
    """Map a user key to the 64-bit protocol key space."""
    if isinstance(key, int):
        return key & _MASK64
    if isinstance(key, str):
        key = key.encode("utf-8")
    if not isinstance(key, (bytes, bytearray)):
        raise CodecError(f"key must be bytes/str/int, got {type(key)!r}")
    # SplitMix64 absorption over 8-byte chunks; avalanche via layout.hash64.
    h = 0x9E3779B97F4A7C15 ^ (len(key) << 1)
    for i in range(0, len(key), 8):
        chunk = int.from_bytes(bytes(key[i:i + 8]), "little")
        h = L.hash64((h ^ chunk) & _MASK64, seed=11)
    return h & _MASK64


def encode_value(value: Optional[Value]) -> List[int]:
    """Pack a user value into protocol words (tagged for byte payloads)."""
    if value is None:
        return []
    if isinstance(value, str):
        value = value.encode("utf-8")
    if isinstance(value, (bytes, bytearray)):
        b = bytes(value)
        header = (VALUE_TAG << _TAG_SHIFT) | (len(b) & _LEN_MASK)
        words = [header]
        for i in range(0, len(b), 8):
            words.append(int.from_bytes(b[i:i + 8], "little"))
        return words
    # raw word list (legacy / protocol-level callers)
    words = [int(v) & _MASK64 for v in value]
    if _looks_tagged(words):
        raise CodecError(
            "raw word list is ambiguous: word 0 carries the byte-payload "
            "tag and a consistent length; pass the payload as bytes instead")
    return words


def _looks_tagged(words: List[int]) -> bool:
    """True iff ``words`` is exactly what ``encode_value(bytes)`` emits:
    tag in the header, a length field matching the word count, and zeroed
    padding in the final word.  Anything else is a raw word list."""
    if not words or (words[0] >> _TAG_SHIFT) & 0xFFFF != VALUE_TAG:
        return False
    nbytes = words[0] & _LEN_MASK
    if len(words) - 1 != (nbytes + 7) // 8:
        return False
    pad = len(words[1:]) * 8 - nbytes
    if pad and words[-1] >> (64 - pad * 8):
        return False              # nonzero bytes beyond the stated length
    return True


def decode_value(words, *, strict: bool = False) -> Optional[Value]:
    """Inverse of ``encode_value``; untagged word lists return unchanged.

    ``strict=True`` turns a *malformed* tag — the header word carries the
    byte-payload magic but the length field disagrees with the word count,
    or padding bytes beyond the stated length are nonzero — into a typed
    ``CodecError`` instead of the lenient raw-word-list fallback.  Use it
    wherever the words are known to come from ``encode_value`` (store
    round trips), keep the default for legacy protocol-word callers."""
    if words is None:
        return None
    words = [int(w) for w in words]
    if not _looks_tagged(words):
        if (strict and words
                and (words[0] >> _TAG_SHIFT) & 0xFFFF == VALUE_TAG):
            raise CodecError(
                f"malformed value tag: header declares a "
                f"{words[0] & _LEN_MASK}-byte payload but "
                f"{len(words) - 1} data word(s) follow (or padding beyond "
                f"the stated length is nonzero)")
        return words
    nbytes = words[0] & _LEN_MASK
    raw = b"".join(int(w).to_bytes(8, "little") for w in words[1:])
    return raw[:nbytes]
