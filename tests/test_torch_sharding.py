"""The port's sharding rules, dry-run cells and analytic FLOPs against the
reference's, decided on device-free meshes: ``spec_for`` of every
parameter, cache and input of the ten full configs on the production
meshes (16x16, 2x16x16) and the test meshes (4x2, 2x2x2), the long_500k
sequence-parallel case, ``cell_supported`` / ``all_cells`` /
``input_specs``, ``analytic_model_flops`` and ``opt_state_axes``."""

import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import registry as rreg
from repro.configs.base import SHAPES as RSHAPES
from repro.models import model as rmodel
from repro.optim import adamw as radamw
from repro.parallel import sharding as rsh
from repro.roofline import analysis as rroof
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as tsh
from repro_torch.roofline import analysis as troof

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}


def _meshes(name):
    shape, axes = MESHES[name]
    return JaxAbstractMesh(shape, axes), tsh.AbstractMesh(shape, axes)


def _leaves(tree, prefix=""):
    """(path, leaf) of nested dicts (axes tuples / arrays are leaves)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x[0])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", rreg.ARCHS)
def test_param_specs_match_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    r_axes = dict(_leaves(rmodel.params_logical_axes(rreg.get_config(arch))))
    r_abs = dict(_leaves(rmodel.abstract_params(rreg.get_config(arch))))
    t_axes = dict(_leaves(tmodel.params_logical_axes(treg.get_config(arch))))
    t_abs = dict(_leaves(tmodel.abstract_params(treg.get_config(arch))))
    assert sorted(r_axes) == sorted(t_axes)
    for key, axes in r_axes.items():
        assert t_axes[key] == axes, key
        assert tuple(t_abs[key].shape) == tuple(r_abs[key].shape), key
        assert t_abs[key].device.type == "meta"
        want = tuple(rsh.spec_for(jm, axes, r_abs[key].shape))
        got = tsh.spec_for(tm, t_axes[key], tuple(t_abs[key].shape))
        assert got == want, (key, got, want)
        # and without shapes (no divisibility fallback)
        assert tsh.spec_for(tm, axes) == tuple(rsh.spec_for(jm, axes)), key


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", rreg.ARCHS)
def test_cache_and_input_specs_match_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
    for sname in RSHAPES:
        rshape, tshape = RSHAPES[sname], TSHAPES[sname]
        r_in = rreg.input_specs(rcfg, rshape)
        t_in = treg.input_specs(tcfg, tshape)
        r_cache_axes = t_cache_axes = None
        if "cache" in r_in:
            _, r_cache_axes = rmodel.cache_shapes(
                rcfg, rshape.global_batch, rshape.seq_len, rcfg.dtype)
            t_cache_axes = tmodel.cache_axes(tcfg)
            assert t_cache_axes == r_cache_axes
        r_sh = rsh.input_shardings(jm, r_in, r_cache_axes)
        t_sp = tsh.input_specs_for(tm, t_in, t_cache_axes)
        r_flat = dict(_leaves(r_sh))
        t_flat = dict(_leaves(t_sp))
        assert sorted(r_flat) == sorted(t_flat), sname
        for key, ns in r_flat.items():
            assert t_flat[key] == tuple(ns.spec), (sname, key)


@pytest.mark.parametrize("arch", rreg.ARCHS)
def test_cells_and_input_specs_match_reference(arch):
    rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
    assert [c for c in treg.all_cells() if c[0] == arch] == \
        [c for c in rreg.all_cells() if c[0] == arch]
    for sname in RSHAPES:
        assert treg.cell_supported(tcfg, TSHAPES[sname]) == \
            rreg.cell_supported(rcfg, RSHAPES[sname])
        r = dict(_leaves(rreg.input_specs(rcfg, RSHAPES[sname])))
        t = dict(_leaves(treg.input_specs(tcfg, TSHAPES[sname])))
        assert sorted(r) == sorted(t)
        for key, spec in r.items():
            assert tuple(t[key].shape) == tuple(spec.shape), (sname, key)
            assert str(t[key].dtype).split(".")[-1] == str(spec.dtype), key
            assert t[key].device.type == "meta"


def test_long500k_sequence_parallel_spec():
    """tests/test_parallel.py's case: batch=1 -> kv_seq claims
    ("pod", "data")."""
    tm = tsh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    spec = tsh.spec_for(tm, ("batch", "kv_seq", "kv_heads", None),
                        (1, 1024, 8, 64))
    assert spec == (None, ("pod", "data"), "model")
    jm = JaxAbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert spec == tuple(rsh.spec_for(
        jm, ("batch", "kv_seq", "kv_heads", None), (1, 1024, 8, 64)))


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    tm = tsh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert tsh.placements(tm, (None, ("pod", "data"), "model")) == (
        Shard(1), Shard(1), Shard(2))
    assert tsh.placements(tm, ()) == (Replicate(),) * 3
    assert tsh.placements(tm, ("data",)) == (Replicate(), Shard(0),
                                             Replicate())


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", rreg.ARCHS)
def test_analytic_model_flops_match_reference(arch, multi_pod):
    n = 512 if multi_pod else 256
    for sname in RSHAPES:
        want = rroof.analytic_model_flops(rreg.get_config(arch),
                                          RSHAPES[sname], n)
        got = troof.analytic_model_flops(treg.get_config(arch),
                                         TSHAPES[sname], n)
        assert got == pytest.approx(want, rel=1e-12), sname


def test_opt_state_axes_match_reference():
    cfg = "deepseek_v3_671b"
    r = radamw.opt_state_axes(rmodel.params_logical_axes(
        rreg.get_config(cfg)))
    t = tadamw.opt_state_axes(tmodel.params_logical_axes(
        treg.get_config(cfg)))
    assert t.step == r.step == ()
    assert t.m == r.m and t.v == r.v
    o = tadamw.abstract_opt_state(tmodel.abstract_params(
        treg.get_config("olmoe_1b_7b")))
    assert o.step.device.type == "meta" and o.step.dtype == torch.int32
    assert all(x.dtype == torch.float32 for x in tadamw.tree_leaves(o.m))


def test_meshes_have_the_reference_shapes():
    from repro_torch.launch.mesh import production_shape
    assert production_shape(False) == tsh.AbstractMesh((16, 16),
                                                       ("data", "model"))
    assert production_shape(True).mesh_dim_names == ("pod", "data", "model")
    assert production_shape(True).size() == 512
