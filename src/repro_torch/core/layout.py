"""Bit-level layouts for FUSEE metadata (slots, pointers, log entries).

Everything in the disaggregated heap is word-addressed (8-byte words), the
granularity at which RDMA_CAS / RDMA_FAA are atomic.  All packing helpers work
on Python ints / numpy uint64, exactly as in the JAX package's layout module
(tests/test_torch_store.py holds the two bit-identical).

Slot (one 8-byte RACE hash-index slot)::

    | fp : 8 | size_class : 8 | pointer : 48 |

Pointer (48 bits, region-relative so that one pointer names all r replicas)::

    | region_id : 20 | word_offset : 28 |

Embedded log entry (3 words = 24 B, stored at the *end* of each object so the
``used`` bit in the final word is written last — RDMA_WRITEs are
order-preserving within a QP, giving the paper's §4.5 integrity property)::

    w[-3]  old_value   (64-bit: former primary-slot content; 0 = uncommitted)
    w[-2]  | next_ptr : 48 | opcode : 8 | old_crc : 8 |
    w[-1]  | prev_ptr : 48 | unused : 14 | invalid : 1 | used : 1 |

Object layout (size class = power-of-two word count, min 8)::

    w[0]      key (64-bit)
    w[1]      | kv_crc : 8 | reserved : 24 | value_len_words : 32 |
    w[2:...]  value words
    ...free...
    w[-3:]    embedded log entry
"""
from __future__ import annotations

import numpy as np

WORD = 8  # bytes per word

# --- field widths -----------------------------------------------------------
FP_BITS = 8
SIZE_CLASS_BITS = 8
PTR_BITS = 48
REGION_BITS = 20
OFFSET_BITS = 28

OPCODE_INSERT = 1
OPCODE_UPDATE = 2
OPCODE_DELETE = 3

USED_BIT = 1 << 0
INVALID_BIT = 1 << 1

MIN_OBJ_WORDS = 8
LOG_WORDS = 3
HDR_WORDS = 2  # key + len/crc word

NULL = np.uint64(0)
# Sentinel returned by verbs targeting a crashed MN.  Chosen so it can never be
# a legal slot value (region_id of all-ones is reserved).
FAIL = np.uint64(0xFFFF_FFFF_FFFF_FFFF)

_MASK48 = (1 << 48) - 1
_MASK28 = (1 << 28) - 1
_MASK20 = (1 << 20) - 1
_MASK8 = (1 << 8) - 1


def _u64(x: int) -> np.uint64:
    return np.uint64(x & 0xFFFF_FFFF_FFFF_FFFF)


# --- pointer ----------------------------------------------------------------
def pack_ptr(region_id: int, offset: int) -> int:
    assert 0 <= region_id < (1 << REGION_BITS) - 1, region_id  # lint: allow-assert (hot packing path; all-ones reserved)
    assert 0 <= offset < (1 << OFFSET_BITS), offset  # lint: allow-assert (hot packing path)
    return (region_id << OFFSET_BITS) | offset


def ptr_region(ptr: int) -> int:
    return (int(ptr) >> OFFSET_BITS) & _MASK20


def ptr_offset(ptr: int) -> int:
    return int(ptr) & _MASK28


# --- slot -------------------------------------------------------------------
def pack_slot(fp: int, size_class: int, ptr: int) -> np.uint64:
    return _u64(((fp & _MASK8) << 56) | ((size_class & _MASK8) << 48) | (ptr & _MASK48))


def slot_fp(slot) -> int:
    return (int(slot) >> 56) & _MASK8


def slot_size_class(slot) -> int:
    return (int(slot) >> 48) & _MASK8


def slot_ptr(slot) -> int:
    return int(slot) & _MASK48


def is_empty(slot) -> bool:
    return int(slot) == 0


# --- key hashing ------------------------------------------------------------
# SplitMix64: cheap, good avalanche.
def hash64(key: int, seed: int = 0) -> int:
    z = (int(key) + 0x9E3779B97F4A7C15 * (seed + 1)) & 0xFFFF_FFFF_FFFF_FFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFF_FFFF_FFFF_FFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFF_FFFF_FFFF_FFFF
    return z ^ (z >> 31)


def fingerprint(key: int) -> int:
    fp = hash64(key, seed=7) & _MASK8
    return fp if fp != 0 else 1  # fp 0 reserved for "empty"


# GF(2^8) tables for crc8's shift register: ``acc << 1 ^ (0x1D if acc &
# 0x80)`` is multiplication by x modulo the primitive polynomial 0x11D, so
# after N bytes acc = x^N * 0xAB  XOR  sum_i x^(N-1-i) * byte_i.  Long word
# lists (1 KiB objects) are folded with one vectorized pass over their bytes
# instead of 8 Python iterations per word; short lists keep the scalar loop.
_GF_EXP = np.zeros(255, np.int64)
_GF_LOG = np.zeros(256, np.int64)
_v = 1
for _i in range(255):
    _GF_EXP[_i] = _v
    _GF_LOG[_v] = _i
    _v <<= 1
    if _v & 0x100:
        _v ^= 0x11D
del _v, _i
_CRC8_VECTOR_MIN = 8     # words; below this the scalar loop is faster


def _crc8_scalar(words) -> int:
    acc = 0xAB
    for w in words:
        x = int(w)
        for sh in (0, 8, 16, 24, 32, 40, 48, 56):
            acc = ((acc << 1) ^ ((x >> sh) & 0xFF) ^ (0x1D if acc & 0x80 else 0)) & 0xFF
    return acc


def crc8(words) -> int:
    """Toy 8-bit checksum over a sequence of ints (stands in for CRC)."""
    if len(words) < _CRC8_VECTOR_MIN:
        acc = _crc8_scalar(words)
        return acc if acc != 0 else 1
    try:
        arr = np.array(words, dtype="<u8")
    except (OverflowError, TypeError, ValueError):
        arr = np.array([int(w) & 0xFFFF_FFFF_FFFF_FFFF for w in words],
                       dtype="<u8")
    b = arr.view(np.uint8).astype(np.int64)          # byte i = word i//8, lsb first
    n = b.size
    nz = np.nonzero(b)[0]
    terms = _GF_EXP[(_GF_LOG[b[nz]] + (n - 1 - nz)) % 255]
    acc = int(np.bitwise_xor.reduce(terms)) if terms.size else 0
    acc ^= int(_GF_EXP[(_GF_LOG[0xAB] + n) % 255])
    return acc if acc != 0 else 1


# --- log entry --------------------------------------------------------------
def pack_log_mid(next_ptr: int, opcode: int, old_crc: int) -> np.uint64:
    return _u64(((next_ptr & _MASK48) << 16) | ((opcode & _MASK8) << 8) | (old_crc & _MASK8))


def log_mid_next(w) -> int:
    return (int(w) >> 16) & _MASK48


def log_mid_opcode(w) -> int:
    return (int(w) >> 8) & _MASK8


def log_mid_crc(w) -> int:
    return int(w) & _MASK8


def pack_log_tail(prev_ptr: int, used: bool, invalid: bool = False) -> np.uint64:
    return _u64(((prev_ptr & _MASK48) << 16)
                | (INVALID_BIT if invalid else 0)
                | (USED_BIT if used else 0))


def log_tail_prev(w) -> int:
    return (int(w) >> 16) & _MASK48


def log_tail_used(w) -> bool:
    return bool(int(w) & USED_BIT)


def log_tail_invalid(w) -> bool:
    return bool(int(w) & INVALID_BIT)


# --- object -----------------------------------------------------------------
def pack_len_word(value_len_words: int, kv_crc: int) -> np.uint64:
    return _u64(((kv_crc & _MASK8) << 56) | (value_len_words & 0xFFFF_FFFF))


def len_word_vlen(w) -> int:
    return int(w) & 0xFFFF_FFFF


def len_word_crc(w) -> int:
    return (int(w) >> 56) & _MASK8


def obj_words_needed(value_len_words: int) -> int:
    need = HDR_WORDS + value_len_words + LOG_WORDS
    return max(MIN_OBJ_WORDS, need)


def size_class_for(words: int) -> int:
    """Size classes are powers of two starting at MIN_OBJ_WORDS."""
    sc = 0
    cap = MIN_OBJ_WORDS
    while cap < words:
        cap <<= 1
        sc += 1
    return sc


def size_class_words(sc: int) -> int:
    return MIN_OBJ_WORDS << sc


def build_object(key: int, value, next_ptr: int, prev_ptr: int, opcode: int):
    """Return the full word list for an object (old_value left uncommitted)."""
    value = [int(v) for v in value]
    vlen = len(value)
    sc = size_class_for(obj_words_needed(vlen))
    n = size_class_words(sc)
    kv_crc = crc8([key, vlen] + value)
    words = [0] * n
    words[0] = int(key)
    words[1] = int(pack_len_word(vlen, kv_crc))
    for i, v in enumerate(value):
        words[2 + i] = v & 0xFFFF_FFFF_FFFF_FFFF
    words[n - 3] = 0  # old_value: uncommitted
    words[n - 2] = int(pack_log_mid(next_ptr, opcode, 0))
    words[n - 1] = int(pack_log_tail(prev_ptr, used=True))
    return words, sc


def parse_object(words):
    """Parse an object's word list -> dict (no integrity decisions here)."""
    n = len(words)
    key = int(words[0])
    vlen = len_word_vlen(words[1])
    kv_crc = len_word_crc(words[1])
    value = [int(w) for w in words[2:2 + vlen]]
    return dict(
        key=key,
        value=value,
        vlen=vlen,
        kv_crc=kv_crc,
        crc_ok=(crc8([key, vlen] + value) == kv_crc),
        old_value=np.uint64(int(words[n - 3]) & 0xFFFF_FFFF_FFFF_FFFF),
        next_ptr=log_mid_next(words[n - 2]),
        opcode=log_mid_opcode(words[n - 2]),
        old_crc=log_mid_crc(words[n - 2]),
        prev_ptr=log_tail_prev(words[n - 1]),
        used=log_tail_used(words[n - 1]),
        invalid=log_tail_invalid(words[n - 1]),
    )
