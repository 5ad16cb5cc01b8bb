"""Kaldi-format data pipeline: cegs/ark parsing, FSTs, sparse formats, batching.

Redesign of the reference's pure-Go data layer
(ref: internal/parser, internal/sparse, internal/batch, internal/loader).
"""

from kaldi_fp16_tpu.io.kaldi_io import BinaryReader, BinaryWriter
from kaldi_fp16_tpu.io.matrix import (
    read_compressed_matrix_cm,
    read_compressed_matrix_cm2,
    read_compressed_matrix_cm3,
    read_full_matrix,
    write_compressed_matrix_cm,
    write_compressed_matrix_cm2,
    write_compressed_matrix_cm3,
    write_full_matrix,
)
from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState, read_fst, write_fst_compact_acceptor, write_fst_vector
from kaldi_fp16_tpu.io.egs import Example, IoBlock, Index, Supervision, EgsReader, read_examples, write_example, example_to_text
from kaldi_fp16_tpu.io.sparse import CSR, COO, fst_to_csr, fst_to_coo, coo_to_csr, merge_coo
