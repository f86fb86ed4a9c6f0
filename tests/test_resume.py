"""--resume: interrupted streaming map runs restart at the last
complete batch and reproduce the uninterrupted output byte-for-byte."""

import json
import os

import pytest

from vgaligner_tpu.cli import main
from vgaligner_tpu.io.resume import ResumableGafWriter

from conftest import DATA_DIR


class _Rec:
    def __init__(self, s):
        self.s = s

    def to_string(self):
        return self.s + "\n"


def test_writer_commit_and_resume(tmp_path):
    prefix = str(tmp_path / "out")
    cf, af = prefix + "-c.gaf", prefix + "-a.gaf"

    w = ResumableGafWriter(prefix, cf, af)
    w.write_chains(2, [_Rec("c1"), _Rec("c1b"), _Rec("c2")])
    w.write_chains(2, [_Rec("c3"), _Rec("c4")])  # batch 2 chains run ahead
    w.write_alignments([_Rec("a1"), _Rec("a2")])  # commits batch 1 only
    # crash here: batch 2 chains are on disk but uncommitted
    del w

    w2 = ResumableGafWriter(prefix, cf, af, resume=True)
    assert w2.skip_reads == 2
    # batch 2's chains were truncated away; rewrite them
    w2.write_chains(2, [_Rec("c3"), _Rec("c4")])
    w2.write_alignments([_Rec("a3"), _Rec("a4")])
    w2.close(done=True)

    assert open(cf).read().splitlines() == ["c1", "c1b", "c2", "c3", "c4"]
    assert open(af).read().splitlines() == ["a1", "a2", "a3", "a4"]
    assert not os.path.exists(prefix + ".progress.json")


def test_cli_resume_after_interrupt(tmp_path, monkeypatch):
    import vgaligner_tpu.models.stream as stream_mod
    from vgaligner_tpu.models.poa_aligner import PoaAligner

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(stream_mod, "DEFAULT_BATCH", 2)
    prefix = str(tmp_path / "tg")
    main(["index", "-i", f"{DATA_DIR}/test.gfa", "-k", "11", "-o", prefix])

    # 5 reads: windows of path x's sequence
    from vgaligner_tpu.graph import graph_from_gfa

    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    seq = "".join(g.sequence(h) for h in g.get_path(0).nodes)
    reads = str(tmp_path / "reads.fa")
    with open(reads, "w") as fh:
        for i in range(5):
            fh.write(f">r{i}\n{seq[i * 3 : i * 3 + 30]}\n")

    clean = str(tmp_path / "clean")
    args = ["map", "-i", prefix, "-f", reads, "-p", "abpoa", "-D",
            "-G", f"{DATA_DIR}/test.gfa", "-t", "1"]
    main(args + ["-o", clean])

    # interrupted run: the POA drain dies on its second batch
    out = str(tmp_path / "out")
    real_finish = PoaAligner.finish_alignments
    calls = {"n": 0}

    def flaky(self, state):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        return real_finish(self, state)

    monkeypatch.setattr(PoaAligner, "finish_alignments", flaky)
    with pytest.raises(RuntimeError):
        main(args + ["-o", out])
    monkeypatch.setattr(PoaAligner, "finish_alignments", real_finish)

    progress = json.load(open(out + ".progress.json"))
    assert 0 < progress["reads_done"] < 5

    main(args + ["-o", out, "--resume"])
    assert open(out + "-chains.gaf").read() == open(clean + "-chains.gaf").read()
    assert (
        open(out + "-alignments.gaf").read()
        == open(clean + "-alignments.gaf").read()
    )
    assert not os.path.exists(out + ".progress.json")
