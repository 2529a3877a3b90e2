"""Alphabets, quality-character classes and default thresholds.

Behavioral contract mirrors the reference implementation's constants
(reference: src/constants.py:1-15): the PHRED33 character *class* defines
which quality characters are legal in FASTQ input; quality scores are the
raw ``ord()`` of the character (no +33 offset is ever subtracted --
reference src/kmer.py:394-408).
"""

from __future__ import annotations

import numpy as np

# --- nucleotide alphabets -------------------------------------------------
NULL_NUCLEOTIDE = "N"
REAL_NUCLEOTIDES = "ACGT"
NUCLEOTIDES = REAL_NUCLEOTIDES + NULL_NUCLEOTIDE

# 2-bit base codes for the numeric core. N gets code 4 and is
# handled with validity masks (k-mers containing N never enter the DB;
# FASTQ reads cannot contain N at all -- the parser rejects them).
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4
CODE_INVALID = 255

# 256-entry ASCII -> base-code lookup table (host-side packing).
BASE_CODE_LUT = np.full(256, CODE_INVALID, dtype=np.uint8)
for _ch, _code in (("A", BASE_A), ("C", BASE_C), ("G", BASE_G), ("T", BASE_T),
                   ("N", BASE_N)):
    BASE_CODE_LUT[ord(_ch)] = _code
CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# --- quality characters ---------------------------------------------------
# The exact set of legal FASTQ quality characters, as in the reference
# (a keyboard-walk of 94 printable ASCII chars; reference src/constants.py:8-11).
PHRED33_CHARS = (
    r"`1234567890-=qwertyuiop[]\asdfghjkl;'zxcvbnm,./"
    r'~!@#$%^&*()_+QWERTYUIOP{}|ASDFGHJKL:"ZXCVBNM<>?'
)
PHRED33_SCORES = {char: ord(char) for char in PHRED33_CHARS}

# Boolean mask over ASCII for fast validation.
QUALITY_CHAR_MASK = np.zeros(256, dtype=bool)
for _ch in PHRED33_CHARS:
    QUALITY_CHAR_MASK[ord(_ch)] = True

# --- default thresholds (reference src/constants.py:13-15) ----------------
DEFAULT_UNIQUE_THRESHOLD = 1      # m
DEFAULT_AMBIGUOUS_THRESHOLD = 1   # p
DEFAULT_SIMILARITY_THRESHOLD = 0.95

# p < 0 disables the unique-mapping validation pass
# (reference src/kmer.py:16,469).
IGNORE_AMBIGUOUS_THRESHOLD = 0
M_THRESHOLD = 0

# Maximum k the 2-word (lo, hi) fast paths -- notably the bucketized hash
# probe -- support.  The index itself packs keys into ceil(k/16) uint32
# words, so ANY k works end-to-end via the sort-merge probe (matching the
# reference's plain-string keys, kmer.py:84-94, and its RUN_LOG k=75/150
# demos); this constant only gates the 2-word structures.
MAX_K_2WORD = 31
MAX_K = MAX_K_2WORD  # back-compat alias
