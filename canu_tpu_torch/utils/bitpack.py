"""2-bit DNA packing utilities (host side, numpy).

The port's own copy of canu_tpu.utils.bitpack, with the same layout and
results.  Replaces the blob sequence encoding of the reference gkStore
(Canu src/stores/gkStore.H:305-313, gkStoreEncode.C) with a
single flat layout chosen for device friendliness: base ``b`` at position
``p`` of a read occupies bits ``[2*(p%16), 2*(p%16)+1]`` of uint32 word
``p//16`` (LSB-first within a word), so a padded block of reads uploads to
the device as a dense ``uint32[B, W]`` array and unpacks with shifts and
masks.

Base codes: A=0 C=1 G=2 T=3.  Complement is ``3 - code``.  Ambiguity codes
(N etc.) are not representable; callers split reads at them the way
gatekeeperCreate does (Canu src/stores/gatekeeperCreate.C:336).
"""

from __future__ import annotations

import numpy as np

BASES = "ACGT"
BASES_PER_WORD = 16

# ASCII -> 2-bit code; 255 marks non-ACGT.
_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    _CODE[ord(_b)] = _i
    _CODE[ord(_b.lower())] = _i

_CHAR = np.frombuffer(BASES.encode(), dtype=np.uint8)

_SHIFTS = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32)).astype(np.uint32)


def seq_to_codes(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes; non-ACGT become 255."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _CODE[np.frombuffer(seq, dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string (codes must be 0..3)."""
    return _CHAR[codes].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a 2-bit code array (A<->T, C<->G == 3-x)."""
    return (3 - codes[::-1]).astype(codes.dtype)


def n_words(n_bases: int) -> int:
    """Number of uint32 words needed for n_bases."""
    return (n_bases + BASES_PER_WORD - 1) // BASES_PER_WORD


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack uint8 base codes (0..3) into uint32 words, 16 bases/word.

    The tail word is zero-padded (i.e. padded with 'A'); consumers mask by
    length.
    """
    n = len(codes)
    w = n_words(n)
    padded = np.zeros(w * BASES_PER_WORD, dtype=np.uint32)
    padded[:n] = codes
    return np.bitwise_or.reduce(
        padded.reshape(w, BASES_PER_WORD) << _SHIFTS, axis=1
    ).astype(np.uint32)


def unpack_words(words: np.ndarray, n_bases: int) -> np.ndarray:
    """Unpack uint32 words back to uint8 base codes of length n_bases."""
    codes = (words[:, None] >> _SHIFTS[None, :]) & np.uint32(3)
    return codes.reshape(-1)[:n_bases].astype(np.uint8)
