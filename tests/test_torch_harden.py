"""The port's TMR/ECC hardening (`pim.harden` and the compiler's harden
pass) held against the JAX reference.

The rewrites must be node-identical to the reference's, protected sets
included, and the hardened lowerings must fuse to the same AAP streams
(25 -> 62 -> 101 AAPs per tile for bare -> ecc -> tmr on the K=4
carry-save dot).  Under faults every port engine must give the
reference's words and the reference's `EccReport`.  Tolerance: exact
equality everywhere."""
import dataclasses

import numpy as np
import pytest
import torch

import drim
from repro.core import DrimGeometry as RefGeometry
from repro.pim import graph_ref_results as ref_graph_results
from repro.pim.bnn import bnn_dot_graph_carrysave as ref_carrysave
from repro.pim.harden import ECC_OUTPUT as REF_ECC_OUTPUT
from repro.pim.harden import HARDEN_SCHEMES as REF_SCHEMES
from repro.pim.harden import harden_graph as ref_harden
from repro_torch.core import DrimGeometry, FaultModel
from repro_torch.pim import (ECC_OUTPUT, HARDEN_SCHEMES, BulkGraph,
                             EccReport, compile as tcompile,
                             graph_ref_results, harden_graph)
from repro_torch.pim.bnn import bnn_dot_graph_carrysave

SCHEMES = (None, "ecc", "tmr", "tmr+ecc")
N_WORDS = 32
SHAPE = dict(chips=2, banks=4, subarrays_per_bank=8, row_bits=64)
GEOM, REF_GEOM = DrimGeometry(**SHAPE), RefGeometry(**SHAPE)
HOT = dict(p_dra=0.25, p_tra=0.35, seed=3)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def structure(graph):
    return (tuple(graph.input_names), tuple(graph.nodes),
            tuple(graph.outputs.items()))


@pytest.fixture(scope="module")
def corner():
    """The calibrated +-15% corner (source="sim"), the reference's and
    the port's, which must give the same rates."""
    ref = drim.FaultModel.from_corner(0.15, source="sim", seed=0)
    port = FaultModel.from_corner(0.15, source="sim", seed=0, device="cpu")
    assert (port.p_dra, port.p_tra) == (ref.p_dra, ref.p_tra)
    return ref, port


@pytest.fixture(scope="module")
def bnn_case(corner):
    """K=4 carry-save dot feeds, and the reference's resident outputs and
    EccReports per scheme, clean and at the corner."""
    graph, nbits = ref_carrysave(4)
    rng = np.random.default_rng(1)
    feeds = {n: (np.zeros(N_WORDS, np.uint32) if n == "zero"
                 else rng.integers(0, 1 << 32, N_WORDS, dtype=np.uint32))
             for n in graph.input_names}
    want = {}
    for scheme in SCHEMES:
        low = drim.compile(graph, geom=REF_GEOM).lower("resident",
                                                       harden=scheme)
        out = {k: np.asarray(v)
               for k, v in low.run(feeds, faults=corner[0]).items()}
        want[scheme] = (out, low.last_ecc, low.aaps,
                        low._resolve_faults(corner[0]).protected_ops)
    return feeds, ref_graph_results(graph, feeds), want


@pytest.mark.parametrize("k_bits", [2, 3, 4])
@pytest.mark.parametrize("scheme", ["tmr", "ecc", "tmr+ecc"])
def test_rewrites_are_node_identical(scheme, k_bits):
    g2, prot = harden_graph(bnn_dot_graph_carrysave(k_bits)[0], scheme)
    r2, rprot = ref_harden(ref_carrysave(k_bits)[0], scheme)
    assert structure(g2) == structure(r2)
    assert prot == rprot and prot


def test_constants_and_guard_rails():
    assert (HARDEN_SCHEMES, ECC_OUTPUT) == (REF_SCHEMES, REF_ECC_OUTPUT)
    graph, _ = bnn_dot_graph_carrysave(2)
    with pytest.raises(ValueError, match="unknown harden scheme"):
        harden_graph(graph, "dmr")
    g = BulkGraph()
    a = g.input("a")
    g.output(ECC_OUTPUT, g.op("not", a))
    with pytest.raises(ValueError, match="reserved"):
        harden_graph(g, "ecc")
    with pytest.raises(ValueError, match="graph source"):
        tcompile("xnor2").lower("resident", harden="tmr")


def test_ecc_rewrite_semantics():
    """Clean semantics: primary outputs equal the oracle's, the parity row
    their xor."""
    graph, _ = bnn_dot_graph_carrysave(3)
    g2, _ = harden_graph(graph, "ecc")
    rng = np.random.default_rng(9)
    feeds = {n: (np.zeros(8, np.uint32) if n == "zero"
                 else rng.integers(0, 1 << 32, 8, dtype=np.uint32))
             for n in g2.input_names}
    ref = graph_ref_results(graph, feeds)
    got = graph_ref_results(g2, feeds)
    acc = np.zeros(8, np.uint32)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name])
        acc = acc ^ got[name]
    np.testing.assert_array_equal(got[ECC_OUTPUT], acc)


def test_hardened_streams_and_pricing_match_reference(bnn_case):
    _, _, want = bnn_case
    graph, _ = bnn_dot_graph_carrysave(4)
    rgraph, _ = ref_carrysave(4)
    aaps = {}
    for scheme in SCHEMES:
        low = tcompile(graph, geom=GEOM).lower("resident", harden=scheme)
        ref = drim.compile(rgraph, geom=REF_GEOM).lower("resident",
                                                        harden=scheme)
        assert [(i.op, i.args) for i in low.program] == \
            [(i.op, i.args) for i in ref.program]
        assert low.fp.node_spans == ref.fp.node_spans
        assert low.protected_nodes == ref.protected_nodes
        aaps[scheme] = low.aaps
        assert low.aaps == want[scheme][2]
        assert low.cost(4096).aaps_per_tile == ref.cost(4096).aaps_per_tile
    assert (aaps[None], aaps["ecc"], aaps["tmr"]) == (25, 62, 101)


@pytest.mark.parametrize("engine", ["resident", "baseline", "cuda"])
def test_corner_outputs_and_ecc_reports_equal_reference(bnn_case, corner,
                                                        engine):
    feeds, ref, want = bnn_case
    graph, _ = bnn_dot_graph_carrysave(4)
    for scheme in SCHEMES:
        low = tcompile(graph, geom=GEOM).lower(engine, harden=scheme,
                                               faults=corner[1])
        got = low.run(feeds, device="cpu")
        outs, ecc, _, protected = want[scheme]
        assert set(got) == set(outs)
        for name, w in outs.items():
            np.testing.assert_array_equal(u32(got[name]), w,
                                          err_msg=f"{scheme} {name}")
        assert low._resolve_faults(None).protected_ops == protected
        if ecc is None:
            assert low.last_ecc is None
        else:
            assert dataclasses.astuple(low.last_ecc) == \
                dataclasses.astuple(ecc)
            assert isinstance(low.last_ecc, EccReport)
        if scheme == "tmr":
            for name in ref:
                np.testing.assert_array_equal(u32(got[name]), ref[name])


def test_bare_corrupts_and_ecc_detects_when_hot():
    graph, _ = bnn_dot_graph_carrysave(4)
    rng = np.random.default_rng(2)
    feeds = {n: (np.zeros(N_WORDS, np.uint32) if n == "zero"
                 else rng.integers(0, 1 << 32, N_WORDS, dtype=np.uint32))
             for n in graph.input_names}
    ref = graph_ref_results(graph, feeds)
    hot = FaultModel(**HOT)
    bare = tcompile(graph, geom=GEOM).lower("resident").run(
        feeds, device="cpu", faults=hot)
    assert any((u32(bare[n]) != ref[n]).any() for n in ref)
    low = tcompile(graph, geom=GEOM).lower("resident", harden="ecc")
    low.run(feeds, device="cpu", faults=hot)
    assert low.last_ecc.corrupted and low.last_ecc.words == N_WORDS


@pytest.mark.parametrize("scheme", ["ecc", "tmr+ecc"])
def test_clean_runs_leave_a_clean_ecc_report(bnn_case, scheme):
    feeds, ref, _ = bnn_case
    graph, _ = bnn_dot_graph_carrysave(4)
    for engine in ("resident", "baseline", "cuda"):
        low = tcompile(graph, geom=GEOM).lower(engine, harden=scheme)
        got = low.run(feeds, device="cpu")
        assert low.last_ecc == EccReport(mismatch_bits=0, words=N_WORDS)
        assert not low.last_ecc.corrupted
        assert ECC_OUTPUT not in got
        for name in ref:
            np.testing.assert_array_equal(u32(got[name]), ref[name])


def test_lower_cached_keys_harden_and_faults():
    from repro_torch.pim import compiler
    graph, _ = bnn_dot_graph_carrysave(2)
    hot = FaultModel(**HOT)
    a = compiler.lower_cached(graph, key=("harden-test", 2), geom=GEOM,
                              harden="tmr")
    b = compiler.lower_cached(graph, key=("harden-test", 2), geom=GEOM,
                              harden="tmr", faults=hot)
    c = compiler.lower_cached(graph, key=("harden-test", 2), geom=GEOM,
                              harden="tmr", faults=hot)
    assert a is not b and b is c
    assert a.harden == "tmr" and b.default_faults == hot
