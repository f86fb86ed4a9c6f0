"""CLI end-to-end tests: `vgaligner index` + `vgaligner map` over the
reference fixtures (the map.rs / index_main.rs dispatch surface)."""

import os

import pytest

from vgaligner_tpu.cli import main

from conftest import DATA_DIR


def test_cli_index_and_map(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    prefix = str(tmp_path / "tg")
    main(["index", "-i", f"{DATA_DIR}/test.gfa", "-k", "11", "-o", prefix])
    assert os.path.exists(prefix + ".idx.npz")

    out = str(tmp_path / "reads")
    main([
        "map", "-i", prefix, "-f", f"{DATA_DIR}/single-read-test.fa",
        "-o", out, "-p", "abpoa", "-t", "1",
    ])
    gaf = open(out + "-chains.gaf").read()
    assert gaf.count("\n") == gaf.count("seq0")  # one row per chain, all seq0
    for line in gaf.splitlines():
        assert len(line.split("\t")) == 13


def test_cli_map_also_align(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    prefix = str(tmp_path / "tg")
    main(["index", "-i", f"{DATA_DIR}/test.gfa", "-k", "11", "-o", prefix])

    # a read that follows path x of the graph
    from vgaligner_tpu.graph import graph_from_gfa

    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    seq = "".join(g.sequence(h) for h in g.get_path(0).nodes)
    reads = tmp_path / "px.fa"
    reads.write_text(f">px\n{seq}\n")

    out = str(tmp_path / "out")
    val = str(tmp_path / "val.txt")
    main([
        "map", "-i", prefix, "-f", str(reads), "-o", out, "-p", "abpoa",
        "-D", "-G", f"{DATA_DIR}/test.gfa", "-v", "-P", val, "-t", "1",
    ])
    chains = open(out + "-chains.gaf").read()
    aligns = open(out + "-alignments.gaf").read()
    assert chains.startswith("px\t50\t0\t50\t+")
    assert aligns.startswith("px\t50\t0\t50\t+\t>1>3>5>6>8>9>11>12>13>15>16>18>19")
    assert "cg:Z:50M" in aligns
    # validation records written
    val_text = open(val).read()
    assert val_text.startswith("px\ncg:Z:50M\n")
    # subgraph export side effect
    assert (tmp_path / "subgraphs").exists()


def test_cli_missing_graph_for_align(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    prefix = str(tmp_path / "tg")
    main(["index", "-i", f"{DATA_DIR}/test.gfa", "-k", "11", "-o", prefix])
    with pytest.raises(SystemExit):
        main([
            "map", "-i", prefix, "-f", f"{DATA_DIR}/single-read-test.fa",
            "-o", str(tmp_path / "o"), "-p", "abpoa", "-D", "-t", "1",
        ])


def test_cli_gaf_out_path_with_also_align(tmp_path, monkeypatch):
    """A literal .gaf out path with --also-align produces ONE file
    holding only the base-level alignments (pre-streaming behavior:
    the alignments write replaced the chains write)."""
    monkeypatch.chdir(tmp_path)
    prefix = str(tmp_path / "tg")
    main(["index", "-i", f"{DATA_DIR}/test.gfa", "-k", "11", "-o", prefix])

    out = str(tmp_path / "final.gaf")
    main([
        "map", "-i", prefix, "-f", f"{DATA_DIR}/multiple-read-test.fa",
        "-o", out, "-p", "abpoa", "-D", "-G", f"{DATA_DIR}/test.gfa",
        "-t", "1",
    ])
    lines = open(out).read().splitlines()
    # one alignment row per read, no interleaved chain rows
    import re

    names = [ln.split("\t")[0] for ln in lines]
    assert names == sorted(set(names), key=names.index)
    assert len(names) == len(set(names))
    assert not os.path.exists(out + ".progress.json")


def _cache_dir_in_fresh_process(env):
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import vgaligner_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip(), repo


def test_compile_cache_honours_env_dir(tmp_path):
    """JAX_COMPILATION_CACHE_DIR is left as the cache, unchanged."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    got, _repo = _cache_dir_in_fresh_process(env)
    assert got == str(tmp_path / "cc")


def test_compile_cache_defaults_inside_checkout():
    """Without the variable the cache is one fixed in-checkout path."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    got, repo = _cache_dir_in_fresh_process(env)
    assert got == os.path.join(repo, ".jax_cache")


def test_cli_write_console(tmp_path, monkeypatch, capsys):
    """-C/--write-console prints GAF rows to stdout in addition to the
    file outputs (map.rs:123-133 console branch)."""
    monkeypatch.chdir(tmp_path)
    prefix = str(tmp_path / "tg")
    main(["index", "-i", f"{DATA_DIR}/test.gfa", "-k", "11", "-o", prefix])
    out = str(tmp_path / "reads")
    main([
        "map", "-i", prefix, "-f", f"{DATA_DIR}/single-read-test.fa",
        "-o", out, "-p", "abpoa", "-t", "1", "-C",
    ])
    printed = capsys.readouterr().out
    file_rows = open(out + "-chains.gaf").read().splitlines()
    assert file_rows
    for row in file_rows:
        assert row in printed


def test_cli_precision_flag(tmp_path, monkeypatch):
    """--precision exact|fast is a framework knob (the reference has no
    analog); both modes must run end-to-end and the default is auto
    (backend-resolved: exact on CPU, fast on accelerators — see
    MIGRATING.md for the r5 measurement and decision)."""
    monkeypatch.chdir(tmp_path)
    prefix = str(tmp_path / "tg")
    main(["index", "-i", f"{DATA_DIR}/test.gfa", "-k", "11", "-o", prefix])
    outs = {}
    for mode in ("exact", "fast"):
        out = str(tmp_path / f"reads-{mode}")
        main([
            "map", "-i", prefix, "-f", f"{DATA_DIR}/single-read-test.fa",
            "-o", out, "-p", "abpoa", "-t", "1", "--precision", mode,
        ])
        outs[mode] = open(out + "-chains.gaf").read()
    # this fixture has no score ties, so the two modes agree exactly
    assert outs["exact"] == outs["fast"]
    from vgaligner_tpu.cli import _build_parser

    args = _build_parser().parse_args(
        ["map", "-i", "x", "-f", "y", "-p", "abpoa"])
    assert args.precision == "auto"


def test_cli_precision_auto_resolution(tmp_path, monkeypatch, caplog):
    """--precision auto resolves by backend: exact on CPU (native f64,
    parity free), fast on accelerators (r5 measurement in MIGRATING.md).
    The test backend is CPU; the accelerator side is pinned by faking
    the backend probe on the resolver alone."""
    import logging

    import vgaligner_tpu.cli as cli

    monkeypatch.chdir(tmp_path)
    prefix = str(tmp_path / "tg")
    cli.main(["index", "-i", f"{DATA_DIR}/test.gfa", "-k", "11",
              "-o", prefix])
    with caplog.at_level(logging.INFO, logger="vgaligner"):
        cli.main([
            "map", "-i", prefix,
            "-f", f"{DATA_DIR}/single-read-test.fa",
            "-o", str(tmp_path / "auto"), "-p", "abpoa",
        ])
    assert "precision auto -> exact (backend cpu)" in caplog.text

    assert cli._resolve_precision("exact") == "exact"
    assert cli._resolve_precision("fast") == "fast"
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert cli._resolve_precision("auto") == "fast"
