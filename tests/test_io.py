"""I/O tests ported from /root/reference/src/io.rs:257-369 and
align.rs:1203-1231 (placeholder GAF formatting)."""

import pytest

from vgaligner_tpu.io.fastx import QuerySequence, read_seqs_from_file
from vgaligner_tpu.io.gaf import GAFAlignment
from vgaligner_tpu.models.mapper import Chain

from conftest import DATA_DIR


def test_read_fasta_single_read():
    seqs = read_seqs_from_file(f"{DATA_DIR}/single-read-test.fa")
    assert len(seqs) == 1
    assert seqs[0].name == "seq0"
    assert seqs[0].seq == "AAAAACGTTAAATTTGGCATCGTAGCAAAAA"


def test_read_fasta_headers():
    seqs = read_seqs_from_file(f"{DATA_DIR}/multiple-read-test.fa")
    assert len(seqs) == 2
    assert seqs[0].name == "seq0"
    assert seqs[1].name == "seq1"
    assert seqs[1].seq == "TTTCGTTAAATTTGGCATCGTAGCTTT"


def test_read_fastq():
    seqs = read_seqs_from_file(f"{DATA_DIR}/test.fq")
    assert len(seqs) == 1
    assert seqs[0].name.startswith("ERR059938.60")


def test_duplicate_fasta_names(tmp_path):
    # io.rs:108-119: repeated seq lines under one header get numeric suffixes
    p = tmp_path / "dup.fa"
    p.write_text(">a\nACGT\nTTTT\n>b\nGGGG\n")
    seqs = read_seqs_from_file(str(p))
    assert [s.name for s in seqs] == ["a", "a1", "b"]


def test_unknown_extension(tmp_path):
    p = tmp_path / "reads.txt"
    p.write_text(">a\nACGT\n")
    with pytest.raises(ValueError):
        read_seqs_from_file(str(p))


def test_split_into_kmers():
    # io.rs:313-335
    assert QuerySequence.from_string("AAACTG").split_into_kmers(3) == [
        "AAA", "AAC", "ACT", "CTG",
    ]
    assert QuerySequence.from_string("AAA").split_into_kmers(4) == []
    assert QuerySequence.from_string("AA").split_into_kmers(3) == []


def test_placeholder_gaf_to_string():
    # align.rs:1203-1231
    read = QuerySequence.from_name_and_string("Read1", "AAACTA")
    c = Chain(query=read, is_placeholder=True)
    aln = GAFAlignment.from_placeholder_chain(c)
    assert aln.to_string() == "Read1\t6\t*\t*\t*\t*\t*\t*\t*\t*\t*\t0\t*\n"
