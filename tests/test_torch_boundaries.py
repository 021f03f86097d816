"""Guards on the port's rules: `src/repro_torch`, `src/drim_torch` and the
examples' torch twins import neither JAX nor the reference packages, the
entry points run on the card unless the caller asks for the CPU, the
kernel wrappers refuse what their kernels do not take instead of quietly
running the plain version, and the lowering arguments of earlier slices
(`mesh=`, `partition=`, `verify=`, `n_queues=`) lower and run."""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import DRIM_R, FaultModel, analog, prng
from repro_torch.kernels import aap_interpreter, packbits, xnor_popcount
from repro_torch.models import layers
from repro_torch.pim import bnn, compiler

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = (sorted(PORT.rglob("*.py"))
              + sorted((ROOT / "src" / "drim_torch").rglob("*.py"))
              + sorted((ROOT / "examples").glob("*_torch.py"))
              + [ROOT / "chip_smoke.py"])
FORBIDDEN = {"jax", "jaxlib", "repro", "drim"}


def imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_core_imports_no_higher_layer():
    """`repro_torch.core` (the device model, and the mesh its sharded runner
    cuts) sits at the bottom: it imports the port's `device` module and
    itself, never `launch`, `pim` or another layer above it."""
    for path in sorted((PORT / "core").glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            else:
                continue
            for name in names:
                if name.split(".")[0] == "repro_torch":
                    assert name in ("repro_torch.device",) or \
                        name.startswith("repro_torch.core"), (path, name)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.pim.bnn, drim_torch, "
            "repro_torch.models.layers, repro_torch.kernels.aap_interpreter; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'drim')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(no_cuda):
    a = np.ones((2, 4), np.uint8)
    w = np.ones(4, np.uint32)
    calls = [
        lambda: bnn.bnn_dot_drim(a, a),
        lambda: bnn.bnn_dot_partitioned(a, a, engine="cuda"),
        lambda: bnn.serve_bnn_matmul(a, a, engine="cuda"),
        lambda: compiler.compile("xnor2").lower(engine="cuda").run(w, w),
        lambda: layers.bitlinear_from_jax({"bkernel": np.ones((4, 2))}),
        lambda: layers.packed_from_jax({"w_packed": np.ones((2, 1), np.uint32),
                                        "alpha": np.ones(2), "k_bits": 4}),
        lambda: analog.monte_carlo_error_rates(trials=4),
        lambda: FaultModel.from_corner(0.15, source="sim", trials=4),
        lambda: prng.PRNGKey(0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _no_plain(monkeypatch):
    """Make every plain version fail loudly if a wrapper reaches it."""
    def boom(*a, **k):
        raise AssertionError("wrapper fell back to the plain version")
    monkeypatch.setattr(packbits, "pack_signs_plain", boom)
    monkeypatch.setattr(xnor_popcount, "xnor_gemm_plain", boom)
    monkeypatch.setattr(aap_interpreter, "aap_interp_plain", boom)


def test_wrappers_refuse_what_their_kernels_do_not_take(monkeypatch):
    _no_plain(monkeypatch)
    x = torch.zeros(8, 64)
    with pytest.raises(TypeError):
        packbits.pack_signs(x.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        packbits.pack_signs(torch.zeros(64, 8).T)
    with pytest.raises(ValueError):
        packbits.pack_signs(torch.zeros(2, 8, 64))
    with pytest.raises(ValueError):
        packbits.pack_signs(torch.zeros(8, 64, device="meta"))

    a = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(TypeError):
        xnor_popcount.xnor_gemm_packed(a.float(), a, 64)
    with pytest.raises(ValueError, match="contiguous"):
        xnor_popcount.xnor_gemm_packed(torch.zeros(2, 4, dtype=torch.int32).T,
                                       a, 64)
    with pytest.raises(ValueError):
        xnor_popcount.xnor_gemm_packed(a, torch.zeros(4, 3, dtype=torch.int32),
                                       64)
    with pytest.raises(ValueError):
        xnor_popcount.xnor_gemm_packed(a, a, 65)
    with pytest.raises(ValueError):
        xnor_popcount.xnor_gemm_packed(a.to("meta"), a.to("meta"), 64)

    stream = torch.zeros(3, 19, dtype=torch.int32)
    tiles = torch.zeros(1, 2, 40, dtype=torch.int32)
    slots = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(TypeError):
        aap_interpreter.aap_interp(stream, tiles.to(torch.int64), slots, 5)
    with pytest.raises(ValueError, match="contiguous"):
        aap_interpreter.aap_interp(stream, tiles.transpose(1, 2), slots, 5)
    with pytest.raises(ValueError):
        aap_interpreter.aap_interp(stream[:, :18].contiguous(), tiles,
                                   slots, 5)
    with pytest.raises(ValueError):
        aap_interpreter.aap_interp(stream, tiles, slots, 1)
    with pytest.raises(ValueError):
        aap_interpreter.aap_interp(stream.to("meta"), tiles.to("meta"),
                                   slots.to("meta"), 5)


@pytest.mark.parametrize("kwargs", [
    {"partition": True}, {"mesh": object()}, {"verify": True},
    {"n_queues": 2}])
def test_later_slice_arguments_raise(kwargs, monkeypatch):
    """`mesh=` (Queue 1 item 12) lowers with any hashable mesh object and
    runs only with a fleet mesh: a mesh that is not one raises
    AttributeError where a run would cut its blocks (as the reference's
    run does), and a real 2x4 mesh gives the oracle's words;
    `verify=True` (Queue 1 item 10) lowers through the verify pass and
    carries a clean report; `partition=` and `n_queues=` (Queue 1 item 9)
    lower and run: the K=3 carry-save dot split over two bank queues, or
    on the "queued" engine's two queues, gives the oracle's words."""
    if "mesh" in kwargs:
        from repro_torch.pim import fleet_mesh
        w = np.arange(64, dtype=np.uint32)
        for low in (compiler.compile("xnor2").lower(**kwargs),
                    compiler.lower_cached("xnor2", **kwargs)):
            assert low.mesh is kwargs["mesh"]
            with pytest.raises(AttributeError):
                low.run(w, w, device="cpu")
        geom = dataclasses.replace(DRIM_R, chips=2, banks=4,
                                   subarrays_per_bank=2, row_bits=64)
        mesh = fleet_mesh(geom, devices=[torch.device("cpu")] * 8)
        for low in (compiler.compile("xnor2", geom=geom).lower(mesh=mesh),
                    compiler.lower_cached("xnor2", geom=geom, mesh=mesh)):
            (got,) = low.run(w, w, device="cpu")
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          ~(w ^ w))
        return
    if "verify" in kwargs:
        monkeypatch.setenv("DRIM_VERIFY", "0")      # explicit True wins
        for low in (compiler.compile("xnor2").lower(**kwargs),
                    compiler.lower_cached("xnor2", **kwargs)):
            rep = low.verify_report
            assert rep is not None and rep.ok and rep.layers == ("aap",)
            assert (rep.aaps_checked, rep.nodes_checked) == (low.aaps, 1)
        return
    from repro_torch.pim import graph_ref_results
    geom = dataclasses.replace(DRIM_R, subarrays_per_bank=2, row_bits=64)
    g, _ = bnn.bnn_dot_graph_carrysave(3)
    rng = np.random.default_rng(5)
    feeds = {n: rng.integers(0, 1 << 32, 40, dtype=np.uint32)
             for n in g.input_names}
    engine = None if "partition" in kwargs else "queued"
    lows = (compiler.compile(g, geom=geom).lower(engine, **kwargs),
            compiler.lower_cached(g, key=("k3", geom), geom=geom,
                                  engine=engine, **kwargs))
    for low in lows:
        assert low.engine.name == "queued"
        assert low.kind == ("partition" if "partition" in kwargs
                            else "graph")
        out = low.run(feeds, device="cpu")
        for name, want in graph_ref_results(g, feeds).items():
            np.testing.assert_array_equal(out[name].numpy().view(np.uint32),
                                          want)


def test_only_the_ported_engines_are_registered():
    """The four DRIM engines (the reference's order, "cuda" in the place
    of "pallas") and the comparator "gpu" (the reference's "tpu", renamed
    for the card) are registered; the reference's "pallas" and "tpu"
    names are not taken."""
    assert compiler.engines() == ("resident", "baseline", "queued", "cuda",
                                  "gpu")
    assert [compiler.get_engine(e).device for e in compiler.engines()] \
        == [True, True, True, True, False]
    for name in ("pallas", "tpu"):
        with pytest.raises(ValueError, match="unknown engine"):
            compiler.compile("xnor2").lower(engine=name)
    with pytest.raises(ValueError, match="unknown engine"):
        with layers.serving_engine("pallas", geom=DRIM_R):
            pass
