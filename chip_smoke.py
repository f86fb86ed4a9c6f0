#!/usr/bin/env python3
"""Bring-up check on NVIDIA GPUs: index -> map -> align through the CLI.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # only the multi-device paths, 4 GPUs

One card, in one process that holds it:
  1. device: JAX must see GPUs; prints device_kind, the count, and the
     card's name and power limit from nvidia-smi (run in a child).
  2. kernel parity at real widths: the POA DP kernel (CUDA, the one
     hand-written kernel of the path) against poa_dp_xla on every POA
     chunk shape the CLI runs dispatch, with their own data — exact
     equality — and compiled.memory_analysis(); then the tests marked
     `gpu`.  Every other device op (lookup, chain DP, traceback) is
     XLA's own code, checked end to end in phase 4.
  3. kernel vs XLA timing, in turns (XLA, kernel, kernel, XLA).
  4. end to end through vgaligner_tpu.cli.main on a seeded
     DRB1-3123-shaped graph (vgaligner_tpu/experiments/synth.py):
     `index -k 11`; `map` of 4,096 x 100 bp reads (seed 77); the same
     reads with `-D -G`; 256 x 1 kb reads with `-D -G` (seed 79); and
     `map --precision exact` once.  Every GAF must equal, byte for byte,
     the same CLI run in a child process pinned to the CPU (the plain
     XLA path) on the first 1,024 short and 64 long reads, and the same
     run on the GPU with the POA DP routed to XLA on all reads.  The
     align runs alternate kernel and XLA routing run by run.
The last line of output is one JSON object; any failure exits non-zero
before it is printed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")  # listed in .gitignore
N_SHORT, N_LONG = 4096, 256
N_SHORT_CPU, N_LONG_CPU = 1024, 64  # prefix the CPU oracle re-runs
K = 11


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power() -> list:
    """nvidia-smi's name and power limit per card, from a child process
    that does not import JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def device_phase(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs}")
    if len(devs) < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, JAX found {len(devs)}")
    cards = card_name_and_power()
    log(f"[device] {len(devs)} x {devs[0].device_kind} "
        f"(platform {devs[0].platform}, jax {jax.__version__})")
    for i, c in enumerate(cards):
        log(f"[device] nvidia-smi card {i}: {c}")
    return devs, cards[0]


def make_inputs():
    from vgaligner_tpu.experiments.synth import (
        sample_reads, synth_graph, to_hash_graph, write_fasta, write_gfa,
    )

    sg = synth_graph(seed=1)
    gfa = os.path.join(WORK, "drb1.gfa")
    write_gfa(sg, gfa)
    graph = to_hash_graph(sg)
    short = sample_reads(graph, N_SHORT, 100, seed=77)
    long_ = sample_reads(graph, N_LONG, 1000, seed=79)
    files = {
        "short": (short, "r"), "short_cpu": (short[:N_SHORT_CPU], "r"),
        "long": (long_, "l"), "long_cpu": (long_[:N_LONG_CPU], "l"),
    }
    paths = {}
    for key, (reads, prefix) in files.items():
        paths[key] = os.path.join(WORK, f"{key}.fa")
        write_fasta(paths[key], reads, prefix)
    log(f"[inputs] graph: {len(sg.segments)} nodes, "
        f"{sum(len(s) for _, s in sg.segments)} bp, {len(sg.paths)} paths; "
        f"{N_SHORT} x 100 bp and {N_LONG} x 1 kb reads")
    return gfa, paths


def cli_runs(gfa: str, paths: dict, short_key: str, long_key: str,
             tag: str = ""):
    """(name, argv) of the CLI runs; outputs are named `name` + tag."""
    base = ["-i", "idx", "-p", "abpoa"]
    return [
        ("map", ["map", *base, "-f", paths[short_key], "-o", "map" + tag]),
        ("aln", ["map", *base, "-f", paths[short_key], "-o", "aln" + tag,
                 "-D", "-G", gfa]),
        ("long", ["map", *base, "-f", paths[long_key], "-o", "long" + tag,
                  "-D", "-G", gfa]),
    ]


def route_poa(xla: bool) -> None:
    """Routes the POA DP to poa_dp_xla (xla=True) or back to the GPU
    kernel, and drops the executables traced under the other routing."""
    import jax

    import vgaligner_tpu.ops.poa_device as pd

    if not hasattr(route_poa, "kernel"):
        route_poa.kernel = pd._poa_dp
    pd._poa_dp = pd.poa_dp_xla if xla else route_poa.kernel
    pd._FUSED_CACHE.clear()
    jax.clear_caches()


def start_cpu_oracle(gfa: str, paths: dict):
    """The same CLI runs on the CPU prefix, in a child pinned to the CPU
    (it opens no card).  --precision fast: the same integer DP as the
    GPU's default."""
    cwd = os.path.join(WORK, "cpu")
    os.makedirs(cwd)
    runs = [["index", "-i", gfa, "-k", str(K), "-o", "idx"]] + [
        argv + ["--precision", "fast"]
        for _, argv in cli_runs(gfa, paths, "short_cpu", "long_cpu")
    ]
    code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
            "from vgaligner_tpu.cli import main\n"
            f"for argv in {runs!r}:\n    main(argv)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = open(os.path.join(WORK, "cpu_oracle.log"), "w")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=cwd, env=env,
                            stdout=out, stderr=subprocess.STDOUT)
    return proc, out, cwd


def median_ms(xs):
    return statistics.median(xs) * 1e3


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def in_turns(name: str, xla_fn, kern_fn, args, rounds: int = 3):
    """XLA, kernel, kernel, XLA, `rounds` times, after one warm-up."""
    timed(xla_fn, *args)
    timed(kern_fn, *args)
    tx, tk = [], []
    for _ in range(rounds):
        tx.append(timed(xla_fn, *args))
        tk.append(timed(kern_fn, *args))
        tk.append(timed(kern_fn, *args))
        tx.append(timed(xla_fn, *args))
    mx, mk = median_ms(tx), median_ms(tk)
    log(f"[timing] {name}: XLA {mx:.3f} ms, kernel {mk:.3f} ms "
        f"(median of {len(tx)}; XLA/kernel {mx / mk:.2f}x)")


def memory_line(name: str, compiled) -> None:
    ma = compiled.memory_analysis()
    log(f"[memory] {name}: args {ma.argument_size_in_bytes} B, "
        f"outputs {ma.output_size_in_bytes} B, "
        f"temp {ma.temp_size_in_bytes} B")


class PoaCapture:
    """Records the first POA chunk of every (B, V, W) shape the CLI
    dispatches, by wrapping ops/poa_device.kernel_prepare."""

    def __init__(self):
        import vgaligner_tpu.ops.poa_device as pd

        self.pd = pd
        self.real = pd.kernel_prepare
        self.chunks = {}

    def __enter__(self):
        def spy(built, qs, v_pad, l_pad):
            key = (built[0].shape[0], built[0].shape[1], l_pad + 1)
            if key not in self.chunks:
                self.chunks[key] = (
                    tuple(a.copy() for a in built[:4]), list(qs), l_pad)
            return self.real(built, qs, v_pad, l_pad)

        self.pd.kernel_prepare = spy
        return self

    def __exit__(self, *exc):
        self.pd.kernel_prepare = self.real


def poa_phase(chunks: dict, card):
    """POA DP kernel vs poa_dp_xla on every captured chunk shape."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vgaligner_tpu.ops.poa_cuda import poa_dp_cuda
    from vgaligner_tpu.ops.poa_device import (
        _pad_queries, _slice_preds, make_init_row, poa_dp_xla,
    )

    kern = jax.jit(poa_dp_cuda)
    for (b, v, w), ((vcodes, vpred, is_sink, nv), qs, l_pad) in sorted(
            chunks.items()):
        q_pad, nq = _pad_queries(qs, b, l_pad)
        with jax.enable_x64(False):
            args = tuple(jnp.asarray(a) for a in (
                vcodes, _slice_preds(vpred, len(qs)).astype(np.int32),
                is_sink != 0, nv.astype(np.int32), q_pad, nq,
                make_init_row(l_pad)))
            s_k, b_k, t_k = jax.block_until_ready(kern(*args))
            s_x, b_x, t_x = jax.block_until_ready(poa_dp_xla(*args))
            live = (np.arange(v)[None, :, None]
                    < np.asarray(nv)[:, None, None])
            if not (np.array_equal(np.asarray(s_k), np.asarray(s_x))
                    and np.array_equal(np.asarray(b_k), np.asarray(b_x))
                    and np.array_equal(np.where(live, np.asarray(t_x), 0),
                                       np.asarray(t_k))):
                raise AssertionError(f"POA DP differs at B,V,W={b},{v},{w}")
            p = args[1].shape[-1]
            log(f"[parity] POA DP B,V,P,W = {b},{v},{p},{w} "
                f"(max nv {int(np.max(nv))}): score, best_sink, tbits "
                f"equal (kernel == poa_dp_xla; tbits on rows < nv)")
            memory_line(f"POA kernel {b},{v},{w}",
                        kern.lower(*args).compile())
            memory_line(f"POA XLA {b},{v},{w}",
                        poa_dp_xla.lower(*args).compile())
            in_turns(f"POA DP B,V,W={b},{v},{w} [{card}]", poa_dp_xla,
                     kern, args)


def run_cli(argv, cwd):
    from vgaligner_tpu.cli import main

    here = os.getcwd()
    os.chdir(cwd)
    try:
        t0 = time.perf_counter()
        main(argv)
        return time.perf_counter() - t0
    finally:
        os.chdir(here)


def gaf_lines(path: str, names=None) -> list:
    with open(path) as fh:
        lines = fh.read().splitlines()
    if names is None:
        return lines
    return [ln for ln in lines if ln.split("\t", 1)[0] in names]


def one_card() -> None:
    devs, card = device_phase(1)
    gfa, paths = make_inputs()
    proc, proc_log, cpu_dir = start_cpu_oracle(gfa, paths)
    gpu_dir = os.path.join(WORK, "gpu")
    os.makedirs(gpu_dir)

    t = run_cli(["index", "-i", gfa, "-k", str(K), "-o", "idx"], gpu_dir)
    log(f"[e2e] index -k {K}: {t:.2f} s")
    runs = cli_runs(gfa, paths, "short", "long")
    exact = ("exact", ["map", "-i", "idx", "-p", "abpoa", "-f",
                       paths["short"], "-o", "exact", "--precision",
                       "exact"])
    # first (compiling) pass: records the POA chunks for phase 2
    with PoaCapture() as cap:
        for name, argv in runs + [exact]:
            t = run_cli(argv, gpu_dir)
            log(f"[e2e] {name} first run (compiles): {t:.2f} s")

    poa_phase(cap.chunks, card)

    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    if rc != 0:
        raise SystemExit(f"gpu-marked tests failed (pytest rc {rc})")
    log("[parity] gpu-marked tests passed")

    # timed runs after the CPU oracle is done, so it does not compete
    # for the host's cores; each timed run follows an untimed one of the
    # same routing, and the align runs alternate kernel / XLA routing
    rc = proc.wait(timeout=1500)
    proc_log.close()
    if rc != 0:
        with open(os.path.join(WORK, "cpu_oracle.log")) as fh:
            sys.stderr.write(fh.read()[-4000:])
        raise SystemExit(f"CPU oracle failed (rc {rc})")
    rates = {}

    def timed(name, argv, variant):
        run_cli(argv, gpu_dir)
        gc.collect()
        t = run_cli(argv, gpu_dir)
        n = N_LONG if name == "long" else N_SHORT
        rates.setdefault((name, variant), []).append(n / t)

    runs_x = dict(cli_runs(gfa, paths, "short", "long", "_xla"))
    for name, argv in runs:
        if name == "map":  # no POA: the routing does not reach it
            for _ in range(3):
                timed(name, argv, "kernels")
            continue
        for r in range(2 if name == "aln" else 3):
            for xla in ((False, True) if r % 2 == 0 else (True, False)):
                route_poa(xla)
                timed(name, runs_x[name] if xla else argv,
                      "XLA" if xla else "kernels")
    route_poa(False)
    timed("exact", exact[1], "kernels")
    med = {key: statistics.median(v) for key, v in rates.items()}
    log(f"[e2e] map: {med[('map', 'kernels')]:.1f} reads/s (median of 3) "
        f"[{card}]")
    for name in ("aln", "long"):
        ks, xs = rates[(name, "kernels")], rates[(name, "XLA")]
        k, x = med[(name, "kernels")], med[(name, "XLA")]
        log(f"[e2e] {name}: POA kernel {k:.1f} vs XLA {x:.1f} reads/s "
            f"({k / x:.3f}x; runs alternated, kernel "
            f"{' '.join(f'{r:.1f}' for r in ks)}; XLA "
            f"{' '.join(f'{r:.1f}' for r in xs)}) [{card}]")

    prefixes = {"short": {f"r{i}" for i in range(N_SHORT_CPU)},
                "long": {f"l{i}" for i in range(N_LONG_CPU)}}
    for name, outs in (("map", ["chains"]), ("aln", ["chains", "alignments"]),
                       ("long", ["chains", "alignments"])):
        names = prefixes["long" if name == "long" else "short"]
        for kind in outs:
            gpu = os.path.join(gpu_dir, f"{name}-{kind}.gaf")
            xla = os.path.join(gpu_dir, f"{name}_xla-{kind}.gaf")
            same_xla = ""
            if name != "map":
                if gaf_lines(gpu) != gaf_lines(xla):
                    raise AssertionError(f"{name}-{kind}.gaf: kernel != XLA")
                same_xla = "== GPU with XLA POA on all reads; "
            g = gaf_lines(gpu, names)
            c = gaf_lines(os.path.join(cpu_dir, f"{name}-{kind}.gaf"))
            if g != c or not c:
                raise AssertionError(f"{name}-{kind}.gaf: GPU != CPU")
            log(f"[e2e] {name}-{kind}.gaf: GPU {same_xla}== CPU byte for "
                f"byte on {len(names)} reads ({len(c)} rows)")
    fast = gaf_lines(os.path.join(gpu_dir, "map-chains.gaf"))
    ex = gaf_lines(os.path.join(gpu_dir, "exact-chains.gaf"))
    n_diff = sum(a != b for a, b in zip(fast, ex)) + abs(len(fast) - len(ex))
    log(f"[e2e] --precision exact vs fast chains GAF: {n_diff} of "
        f"{len(ex)} rows differ; exact {med[('exact', 'kernels')]:.1f} vs "
        f"fast {med[('map', 'kernels')]:.1f} reads/s [{card}]")


def four_cards() -> None:
    devs, _card = device_phase(4)
    from vgaligner_tpu.experiments.synth import synth_graph, to_hash_graph
    from vgaligner_tpu.index import Index
    from vgaligner_tpu.parallel.mesh_check import (
        check_mesh_matches_single, sample_mixed_strand_reads,
    )

    index = Index.build(to_hash_graph(synth_graph(seed=1)), K, 100, 100)
    reads = sample_mixed_strand_reads(index, 4096)
    t0 = time.perf_counter()
    log("[four-cards] " + check_mesh_matches_single(index, reads, devs[:4]))
    log(f"[four-cards] {time.perf_counter() - t0:.1f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on 4 GPUs")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(REPO, "vgaligner_tpu")):
        raise SystemExit("chip_smoke.py must run from a checkout of the repo")
    sys.path.insert(0, REPO)
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    if args.four_cards:
        four_cards()
    else:
        one_card()
    shutil.rmtree(WORK, ignore_errors=True)

    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))


if __name__ == "__main__":
    main()
