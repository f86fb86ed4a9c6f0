"""Chaining DP tests: reference golden cases + device-vs-host property tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from vgaligner_tpu.graph import graph_from_gfa
from vgaligner_tpu.index import Index
from vgaligner_tpu.io.fastx import QuerySequence
from vgaligner_tpu.models.mapper import Mapper
from vgaligner_tpu.ops.chain import chain_scores, make_gap_cost_table

from conftest import DATA_DIR
from vgaligner_tpu.models.host_pipeline import HAnchor, chain_anchors_host, score_anchor, NEG


def test_score_anchor_golden():
    # chain.rs:1000-1035 — overlapping anchors score -f64::MAX
    a = HAnchor(id=36, qb=35, qe=46, tb=3907, te=3918, f=31.397)
    b = HAnchor(id=51, qb=49, qe=60, tb=3906, te=3918, f=49.0)
    assert score_anchor(a, b, 11, 100) == NEG


def test_score_anchor_formula():
    # hand-computed: ql = min(14, 14) = 14, tl = min(10, 12) = 10 wait —
    # construct a clean case: a=(0,11,t 0,11), b=(5,16, t 5,16): ql=5 tl=5
    # gap=0 -> prop = round((11 + 5 - 0)*1000)/1000 = 16.0
    a = HAnchor(id=0, qb=0, qe=11, tb=0, te=11, f=11.0)
    b = HAnchor(id=1, qb=5, qe=16, tb=5, te=16)
    assert score_anchor(a, b, 11, 1000) == 16.0
    # gap case: target shifted by 2 -> gap 2, cost 0.01*11*2 + 0.5*1 = 0.72
    b2 = HAnchor(id=2, qb=5, qe=16, tb=7, te=18)
    assert score_anchor(a, b2, 11, 1000) == pytest.approx(11 + 5 - 0.72, abs=1e-9)


def _device_chain(anchors, k, bandwidth, max_gap):
    A = len(anchors)
    qb = jnp.asarray([[a.qb for a in anchors]], dtype=jnp.int32)
    tb = jnp.asarray([[a.tb for a in anchors]], dtype=jnp.int64)
    te = jnp.asarray([[a.te for a in anchors]], dtype=jnp.int64)
    valid = jnp.ones((1, A), dtype=bool)
    gap_table = jnp.asarray(make_gap_cost_table(k, max_gap))
    return chain_scores(qb, tb, te, valid, gap_table, seed_length=k, bandwidth=bandwidth)


@pytest.mark.parametrize("seed", range(8))
def test_device_dp_matches_host_reference(seed):
    """Random anchor sets: device f/pred/curr_max must equal the scalar
    host restatement of chain.rs exactly (f64)."""
    rng = np.random.default_rng(seed)
    k = 11
    n = int(rng.integers(2, 60))
    anchors = []
    for i in range(n):
        qb = int(rng.integers(0, 80))
        tshift = int(rng.integers(-3, 4))
        tb = max(0, qb + int(rng.integers(0, 30)) + tshift)
        anchors.append(HAnchor(id=i, qb=qb, qe=qb + k, tb=tb, te=tb + k))

    bandwidth, max_gap = 50, 1000
    host_chains, host_curr_max, host_sorted = chain_anchors_host(
        [HAnchor(a.id, a.qb, a.qe, a.tb, a.te) for a in anchors],
        k, bandwidth, max_gap, 1,
    )

    # device expects generation order; sort happens inside
    res = _device_chain(anchors, k, bandwidth, max_gap)
    f = np.asarray(res.f)[0][: n]
    order = np.asarray(res.order)[0][: n]
    curr_max = float(np.asarray(res.curr_max)[0])

    assert curr_max == host_curr_max
    # sorted order must match the host stable sort
    host_order = [a.id for a in host_sorted]
    assert order.tolist() == host_order
    host_f = [a.f for a in host_sorted]
    assert f.tolist() == host_f


def test_mapper_chains_on_test_gfa():
    """test_chains_2 analog (chain.rs:945-976): the forward linearization
    mapped against its own graph must produce non-empty chains."""
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    mapper = Mapper(index, chain_min_n_anchors=2)
    q = QuerySequence.from_string(index.seq_fwd)
    chains = mapper.map_reads([q])[0]
    assert len(chains) > 0
    assert not chains[0].is_placeholder
    # anchors ascend in query and target
    a = chains[0].anchors
    assert all(a[i].qb < a[i + 1].qb for i in range(len(a) - 1))
    assert all(a[i].te < a[i + 1].te for i in range(len(a) - 1))


def test_mapper_no_anchors_placeholder():
    g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
    index = Index.build(g, 11, 100, 100)
    mapper = Mapper(index)
    chains = mapper.map_reads([QuerySequence.from_name_and_string("r", "GGGGGGGGGGGGGG")])[0]
    assert len(chains) == 1 and chains[0].is_placeholder
    # short read -> placeholder too
    chains = mapper.map_reads([QuerySequence.from_name_and_string("s", "ACGT")])[0]
    assert chains[0].is_placeholder


class TestMapqExtension:
    """Opt-in --mapq extension (assign_mapq): working restatement of the
    reference's commented-out primary/secondary logic (chain.rs:582-640)."""

    @staticmethod
    def _chain(qb_list, k=11):
        import numpy as np

        from vgaligner_tpu.io.fastx import QuerySequence
        from vgaligner_tpu.models.mapper import Chain

        q = QuerySequence.from_name_and_string("r", "A" * 64)
        qb = np.asarray(qb_list, dtype=np.int64)
        return Chain(query=q, aqb=qb, atb=qb.copy(), ate=qb + k, k=k)

    def test_unique_chain_gets_max_mapq(self):
        from vgaligner_tpu.models.mapper import assign_mapq

        c = self._chain([0, 5, 10])
        assign_mapq([c])
        assert c.mapping_quality == 60.0
        assert not c.is_secondary

    def test_overlapping_chains_are_ambiguous(self):
        from vgaligner_tpu.models.mapper import assign_mapq

        a = self._chain([0, 5, 10])   # query span [0, 21)
        b = self._chain([2, 6, 9])    # query span [2, 20) — inside a's
        assign_mapq([a, b])
        assert a.mapping_quality == 0.0
        assert b.mapping_quality == 0.0
        # heavy MUTUAL overlap between score-tied chains flags both
        # (the reference's marking is not rank-gated for ties)
        assert a.is_secondary and b.is_secondary

    def test_disjoint_chains_both_primary(self):
        from vgaligner_tpu.models.mapper import assign_mapq

        a = self._chain([0, 5])       # [0, 16)
        b = self._chain([30, 40])     # [30, 51)
        assign_mapq([a, b])
        assert a.mapping_quality == 60.0 and b.mapping_quality == 60.0
        assert not a.is_secondary and not b.is_secondary

    def test_placeholder_untouched_and_gaf_plumbing(self):
        from vgaligner_tpu.io.fastx import QuerySequence
        from vgaligner_tpu.models.mapper import F64_MIN, Chain, assign_mapq

        p = Chain(query=QuerySequence.from_name_and_string("r", "A" * 20),
                  is_placeholder=True)
        assign_mapq([p])
        assert p.mapping_quality == F64_MIN  # sentinel -> GAF mapq 0

    def test_mapq_flag_changes_gaf_column(self, tmp_path):
        """End to end: default run emits mapq 0 (reference parity);
        --mapq emits 60 for a uniquely-mapping read."""
        from vgaligner_tpu.graph import graph_from_gfa
        from vgaligner_tpu.index import Index
        from vgaligner_tpu.io.fastx import QuerySequence
        from vgaligner_tpu.models.mapper import Mapper

        g = graph_from_gfa(f"{DATA_DIR}/test.gfa")
        index = Index.build(g, 11, 100, 100)
        seq = "".join(g.sequence(h) for h in g.get_path(0).nodes)
        reads = [QuerySequence.from_name_and_string("r0", seq[:40])]

        for flag, want in ((False, 0), (True, 60)):
            mapper = Mapper(index, chain_min_n_anchors=2, mapq=flag)
            chains = mapper.map_reads(reads)
            recs = mapper.chains_to_gaf(chains)
            assert recs, "expected at least one chain row"
            got = int(recs[0].to_string().split("\t")[11])
            assert got == want, (flag, recs[0].to_string())

    def test_asymmetric_containment_penalizes_both(self):
        """Regression: a tiny chain contained in a long one must NOT
        keep mapq 60 — the reference zeroes the overlapped chain's mapq
        when flagging it secondary (chain.rs:613-617), and the long
        chain's best_secondary tracking is not threshold-gated
        (chain.rs:619-625)."""
        from vgaligner_tpu.models.mapper import assign_mapq

        a = self._chain(list(range(0, 90, 5)))  # query span [0, 96)
        b = self._chain([40])                   # [40, 51), contained
        assign_mapq([a, b])
        assert a.mapping_quality == 0.0
        assert b.mapping_quality == 0.0
        assert b.is_secondary and not a.is_secondary


def test_gap_cost_poly_matches_f64_table():
    """The fast mode's poly-rounded integer gap cost equals the exact
    f64 table's rounded milli-units for EVERY gap the default max_gap
    admits (verified exhaustively) — so fast-mode scores are exact-mode
    scores times 1000 except at (unobserved) rounding-boundary gaps."""
    import jax

    from vgaligner_tpu.ops.chain import gap_cost_scaled_i32

    k = 11
    table = make_gap_cost_table(k, 1000)
    want = np.floor(table * 1000.0 + 0.5).astype(np.int64)  # g>=0: half-up
    g = jnp.asarray(np.arange(0, 1001, dtype=np.int32))
    with jax.enable_x64(False):
        got = np.asarray(jax.jit(lambda x: gap_cost_scaled_i32(x, k))(g))
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_wide_bandwidth_routes_to_scan():
    """The fast DP takes a band wider than the default 50."""
    rng = np.random.default_rng(5)
    B, A, k = 4, 64, 11
    qb = rng.integers(0, 90, (B, A)).astype(np.int32)
    tb = rng.integers(0, 20000, (B, A)).astype(np.int64)
    wide = chain_scores.__wrapped__(
        jnp.asarray(qb), jnp.asarray(tb), jnp.asarray(tb + k),
        jnp.asarray(rng.random((B, A)) < 0.85),
        jnp.asarray(make_gap_cost_table(k, 1000)), seed_length=k,
        bandwidth=100, precision="fast",
    )
    assert wide.f.shape == (B, A)
