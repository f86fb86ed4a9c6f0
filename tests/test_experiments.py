"""Experiment harness: gafcompare semantics + a mini suite run."""

import os

import pytest

from vgaligner_tpu.experiments.gafcompare import (
    compare_paths,
    parse_gaf_paths,
    path_jaccard,
    signed_ids,
)

from conftest import DATA_DIR


def test_signed_ids():
    assert signed_ids(">1>3<5>12") == [1, 3, -5, 12]
    assert signed_ids("*") == []
    # the chains-GAF tuple format also parses (node ids only)
    assert signed_ids("(>1:0,>6:2),(>3:1,>8:0),") == [1, 6, 3, 8]


def test_path_jaccard_exact_and_range():
    assert path_jaccard([1, 2, 3], [1, 2, 3]) == 1.0
    # range semantics (gafcompare.py:57-67): [min,max) intersections
    assert path_jaccard([1, 4], [2, 5]) == pytest.approx(2 / 4)
    assert path_jaccard([1, 2], [5, 9]) == 0.0
    assert path_jaccard([], [1]) == 0.0
    # reverse orientation flips sign, shifting the range
    assert path_jaccard([-3, -1], [1, 3]) == 0.0


def test_compare_paths_counts():
    q = {"a": [1, 2], "b": [5, 6]}
    r = {"a": [1, 2], "b": [1, 2], "c": [9]}
    res = compare_paths(q, r)
    assert res.total_ref_reads == 3
    assert res.reads_found == 2
    assert res.jaccards[0] == 1.0
    assert res.exact_rate == 0.5


def test_parse_gaf_first_record_wins(tmp_path):
    p = tmp_path / "x.gaf"
    p.write_text(
        "r1\t10\t0\t10\t+\t>1>2\t5\t0\t5\t0\t5\t255\tnote\n"
        "r1\t10\t0\t10\t+\t>7>8\t5\t0\t5\t0\t5\t255\tnote\n"
    )
    assert parse_gaf_paths(str(p)) == {"r1": [1, 2]}


@pytest.mark.parametrize("graph", ["fixture", "synth"])
def test_mini_suite_simple_graph(graph, tmp_path):
    from vgaligner_tpu.experiments.run_suite import run_dataset
    from vgaligner_tpu.experiments.synth import synth_graph, write_gfa

    gfa = os.path.join(DATA_DIR, "test.gfa")
    if graph == "synth":
        gfa = str(tmp_path / "graph.gfa")
        write_gfa(synth_graph(seed=5, n_sites=200, backbone_len=2000), gfa)
    r = run_dataset(
        gfa, graph, n_reads=16, read_len=40, k=11, precision="exact",
    )
    assert r.n_reads == 16
    assert r.reads_found == 16
    assert r.avg_jaccard == 1.0
