"""The port's sharding rules (`repro_torch.runtime.sharding`) and train-
state specs (`repro_torch.runtime.steps`) held against the reference's,
spec for spec.

Every arch at full size: the port's specs are computed over meta tensors
(`models.abstract_params`, `abstract_caches`, `steps.abstract_train_state`:
no storage, no draw), the reference's over `jax.eval_shape`.  The meshes
are abstract on both sides: the reference's `AbstractMesh(shape, names)`
(the jax 0.9 form; it needs no devices, so the test does not depend on
how many host devices jax sees) and the port's `core.mesh.abstract_mesh`
over meta devices.  Shapes: a 1x1 host mesh, the 16x16 production mesh
and the 2x16x16 multi-pod one.  Specs are compared as tuples of entries,
with jax's normalisation (a one-axis tuple is the axis): exact.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, models
from repro_torch.configs.registry import ARCHS
from repro_torch.core.mesh import PartitionSpec, abstract_mesh
from repro_torch.optim import get_optimizer
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps
from repro_torch.tree import tree_map_with_path

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# decode batches and cache lengths: dividing the 16-way axes and not
CACHE_SHAPES = ((32, 64), (6, 40))


@pytest.fixture(scope="module")
def jref():
    import jax
    from jax.sharding import AbstractMesh, PartitionSpec as P

    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro.optim import get_optimizer as jget_optimizer
    from repro.runtime import sharding as jshd
    from repro.runtime import steps as jsteps
    return types.SimpleNamespace(jax=jax, AbstractMesh=AbstractMesh, P=P,
                                 configs=jconfigs, models=jmodels,
                                 get_optimizer=jget_optimizer, shd=jshd,
                                 steps=jsteps)


def meshes(jref, name):
    shape, names = MESHES[name]
    return jref.AbstractMesh(shape, names), abstract_mesh(shape, names)


def ref_specs(jref, tree):
    """{keystr path: spec tuple} of a reference spec tree."""
    P = jref.P
    flat = jref.jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jref.jax.tree_util.keystr(k): tuple(v) for k, v in flat}


def port_specs(tree):
    out = {}
    tree_map_with_path(lambda path, s: out.__setitem__(path, tuple(s)), tree)
    assert all(isinstance(s, PartitionSpec) for s in _leaves(tree))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [] if tree is None else [tree]


def ref_abstract_params(jref, cfg):
    return jref.jax.eval_shape(
        lambda k: jref.models.init_params(k, cfg),
        jref.jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_specs_equal_the_reference_at_full_size(arch, mesh, jref):
    """param_pspecs (the ssm family replicated), param_shardings,
    opt_state_pspecs, cache_pspecs over the decode caches at two batch and
    length shapes, and batch_specs, each spec equal to the reference's;
    the meta params cost no storage."""
    cj, ct = jref.configs.get_config(arch), configs.get_config(arch)
    mj, mt = meshes(jref, mesh)
    pj, pt = ref_abstract_params(jref, cj), models.abstract_params(ct)
    assert all(t.is_meta for t in _leaves(pt))
    want = ref_specs(jref, jref.shd.param_pspecs(pj, mj, cj.family))
    got = port_specs(shd.param_pspecs(pt, mt, ct.family))
    assert got == want
    if ct.family == "ssm":
        assert set(got.values()) == {()}
    shardings = shd.param_shardings(mt, pt, ct.family)
    assert {k: tuple(s.spec) for k, s in _flat(shardings).items()} == got
    assert all(s.mesh is mt for s in _flat(shardings).values())
    assert port_specs(shd.opt_state_pspecs(pt, mt, family=ct.family)) \
        == ref_specs(jref, jref.shd.opt_state_pspecs(pj, mj,
                                                     family=cj.family))
    for batch, s_max in CACHE_SHAPES:
        cache_j = jref.jax.eval_shape(
            lambda: jref.models.empty_caches(cj, batch, s_max))
        cache_t = models.abstract_caches(ct, batch, s_max)
        assert port_specs(shd.cache_pspecs(mt, cache_t)) \
            == ref_specs(jref, jref.shd.cache_pspecs(mj, cache_j)), batch
        tokens = jref.jax.ShapeDtypeStruct((batch, s_max), np.int32)
        frames = jref.jax.ShapeDtypeStruct((batch, 7, ct.d_model),
                                           np.float32)
        bj = {"tokens": tokens, "labels": tokens, "frames": frames}
        bt = {"tokens": torch.empty(batch, s_max, device="meta"),
              "labels": torch.empty(batch, s_max, device="meta"),
              "frames": torch.empty(batch, 7, ct.d_model, device="meta")}
        assert port_specs(shd.batch_specs(mt, bt)) \
            == ref_specs(jref, jref.shd.batch_specs(mj, bj))
    assert tuple(shd.activation_spec(mt)) \
        == tuple(jref.shd.activation_spec(mj))
    assert shd.dp_axes(mt) == jref.shd.dp_axes(mj)


def _flat(tree):
    out = {}
    tree_map_with_path(lambda path, s: out.__setitem__(path, s), tree)
    return out


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "adam8bit"])
@pytest.mark.parametrize("arch", ["drim-bnn", "deepseek-v3-671b"])
def test_abstract_train_state_and_its_specs(arch, optimizer, jref):
    """Leaf for leaf the reference's `abstract_train_state` (shapes and
    dtypes), and `train_state_pspecs` with and without ZeRO-1 equal on
    the three meshes; `state_shardings` carries those specs."""
    cj, ct = jref.configs.get_config(arch), configs.get_config(arch)
    sj = jref.steps.abstract_train_state(cj, jref.get_optimizer(optimizer))
    st = steps.abstract_train_state(ct, get_optimizer(optimizer))
    flat_j = {jref.jax.tree_util.keystr(k): v for k, v in
              jref.jax.tree_util.tree_flatten_with_path(sj)[0]}
    flat_t = _flat(st)
    assert sorted(flat_t) == sorted(flat_j)
    for path, t in flat_t.items():
        assert t.is_meta, path
        assert tuple(t.shape) == tuple(flat_j[path].shape), path
        assert str(t.dtype).split(".")[-1] == str(flat_j[path].dtype), path
    for mesh in MESHES:
        mj, mt = meshes(jref, mesh)
        for zero1 in (True, False):
            want = ref_specs(jref, jref.steps.train_state_pspecs(
                sj, mj, zero1, family=cj.family))
            got = port_specs(steps.train_state_pspecs(
                st, mt, zero1, family=ct.family))
            assert got == want, (mesh, zero1)
        sh = steps.state_shardings(st, mt, family=ct.family)
        assert {k: tuple(s.spec) for k, s in _flat(sh).items()} == port_specs(
            steps.train_state_pspecs(st, mt, family=ct.family))
    if optimizer == "adamw":          # ZeRO-1 puts "data" on the moments
        _, mt = meshes(jref, "1x1")
        specs = steps.train_state_pspecs(st, mt, family=ct.family)
        for path, spec in _flat(specs["opt"]).items():
            if path.startswith(("['m']", "['v']")):
                assert "data" in tuple(spec), path


SPEC_CASES = [
    # (spec, shape, mesh shape, mesh axes): the reference test's cases,
    # then dims the axes do not divide
    (("data", "model"), (7, 6), (1, 1), ("data", "model")),
    ((None, "model"), (8, 4), (2, 1), ("data", "model")),
    (("data", "model"), (7, 6), (2, 3), ("data", "model")),
    (("data", "model"), (8, 5), (2, 3), ("data", "model")),
    ((None, "model"), (7, 4), (2, 2), ("data", "model")),
    ((None, None, "model"), (3, 5, 32), (4, 16), ("data", "model")),
    ((("pod", "data"), None), (64, 3), (2, 16, 16), ("pod", "data",
                                                     "model")),
    ((("pod", "data"), "model"), (16, 48), (2, 16, 16), ("pod", "data",
                                                         "model")),
    (("model",), (24,), (16, 16), ("data", "model")),
    ((), (1, 7, 16), (16, 16), ("data", "model")),
    ((None, "model"), (51865, 1024), (16, 16), ("data", "model")),
]


@pytest.mark.parametrize("spec, shape, mshape, axes", SPEC_CASES)
def test_sanitize_and_zero1_equal_the_reference(spec, shape, mshape, axes,
                                                jref):
    mj = jref.AbstractMesh(mshape, axes)
    mt = abstract_mesh(mshape, axes)
    pj, pt = jref.P(*spec), PartitionSpec(*spec)
    assert tuple(shd.sanitize_spec(pt, shape, mt)) \
        == tuple(jref.shd.sanitize_spec(pj, shape, mj))
    assert tuple(shd.zero1_spec(pt, shape, mt)) \
        == tuple(jref.shd.zero1_spec(pj, shape, mj))


def test_path_strings_are_the_references():
    assert shd._path_str("['layers']['moe']['gate']") == "layers/moe/gate"
    assert shd._path_str("") == ""
    assert shd._path_str(("m", "layers", "attn")) == "m/layers/attn"
    # an expert bank is read by its shape alone
    bank = models.moe.ExpertBank((1, 2, 3, 4), 8, 16, torch.float32)
    mt = abstract_mesh((1, 4), ("data", "model"))
    assert tuple(shd.param_spec("['layers']['moe']['gate']", bank, mt)) \
        == ("model", None, None)
