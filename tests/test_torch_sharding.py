"""repro_torch's sharding rules against the JAX package's, entry for entry:
``param_specs_tree`` (FSDP on and off) for every architecture of the
registry on the meshes (1, 1), (2, 2), (16, 16) and (2, 16, 16);
``batch_specs`` and ``cache_specs_tree`` for every runnable cell at 16x16
and 2x16x16; ``state_shardings`` for mamba2-780m and a q8 architecture;
``input_specs``/``param_specs``/``cache_specs`` in shape and dtype for every
runnable cell. The reference's rules run over ``jax.sharding.AbstractMesh``
(no devices), the port's over a plain ``{name: size}`` mapping (no process
group): both at production sizes. Also the case of
``tests/test_system.py:260`` on the port, and the placements a spec turns
into on a mesh."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.distributed import sharding as RS
from repro.models import model as RM
from repro.models import transformer as RT
from repro.optim.adamw import AdamWConfig as RAdamWConfig
from repro.train import state as RState
from repro_torch.configs import REGISTRY, runnable_cells
from repro_torch.distributed import sharding as S
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES
from repro_torch.models.transformer import abstract_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import make_abstract_state, state_shardings
from repro_torch.tree import leaves_with_paths

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELL_MESHES = ("16x16", "2x16x16")
Q8_ARCH = "mixtral-8x22b"  # > 50 B parameters: the dry-run gives it q8 moments


def ref_mesh(name: str) -> AbstractMesh:
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def port_mesh(name: str) -> dict:
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


def _ref_paths(tree) -> dict:
    """``{path: leaf}`` of a JAX tree, the path ``/``-joined keys (the
    port's ``leaves_with_paths``); ``PartitionSpec`` and ``NamedSharding``
    count as leaves."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, jax.sharding.NamedSharding)))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def _spec(x) -> tuple:
    return tuple(x.spec if isinstance(x, jax.sharding.NamedSharding) else x)


def assert_same_specs(got, want, what: str) -> None:
    """Port specs (tuples or NamedSharding) == the reference's, by path."""
    g = {k: (v.spec if isinstance(v, S.NamedSharding) else v)
         for k, v in leaves_with_paths(got)}
    w = {k: _spec(v) for k, v in _ref_paths(want).items()}
    assert g.keys() == w.keys(), what
    bad = {k: (g[k], w[k]) for k in w if g[k] != w[k]}
    assert not bad, f"{what}: {len(bad)} specs differ, e.g. {list(bad.items())[:3]}"


@functools.lru_cache(maxsize=None)
def ref_abstract_params(arch: str):
    return RT.abstract_params(ref_configs.REGISTRY[arch])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_specs_are_the_reference(arch, mesh):
    cfg = REGISTRY[arch]
    ap = abstract_params(cfg)
    for fsdp in (False, True):
        want = RS.param_specs_tree(ref_abstract_params(arch), ref_mesh(mesh),
                                   ref_configs.REGISTRY[arch], fsdp=fsdp)
        got = S.param_specs_tree(ap, port_mesh(mesh), cfg, fsdp=fsdp)
        assert_same_specs(got, want, f"{arch} {mesh} fsdp={fsdp}")
        shard = S.param_shardings(ap, port_mesh(mesh), cfg, fsdp=fsdp)
        assert_same_specs(shard, want, f"{arch} {mesh} fsdp={fsdp} shardings")


@pytest.mark.parametrize("cell", runnable_cells(), ids="/".join)
def test_batch_and_cache_specs_are_the_reference(cell):
    arch, shape_name = cell
    cfg, rcfg = REGISTRY[arch], ref_configs.REGISTRY[arch]
    shape = SHAPES[shape_name]
    inputs = M.input_specs(cfg, shape_name)
    r_inputs = RM.input_specs(rcfg, shape_name)
    for mesh in CELL_MESHES:
        assert_same_specs(S.batch_specs(inputs, port_mesh(mesh)),
                          RS.batch_specs(r_inputs, ref_mesh(mesh)),
                          f"{cell} {mesh} batch")
        if shape.kind == "decode":
            assert_same_specs(
                S.cache_specs_tree(M.cache_specs(cfg, shape_name), port_mesh(mesh),
                                   cfg, shape),
                RS.cache_specs_tree(RM.cache_specs(rcfg, shape_name), ref_mesh(mesh),
                                    rcfg, shape),
                f"{cell} {mesh} cache")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["mamba2-780m", Q8_ARCH])
def test_state_shardings_are_the_reference(arch, mesh):
    cfg, rcfg = REGISTRY[arch], ref_configs.REGISTRY[arch]
    q8 = cfg.n_params() > 50e9
    assert q8 == (arch == Q8_ARCH)
    abstract = make_abstract_state(cfg, AdamWConfig(quantized_moments=q8))
    r_abstract = RState.make_abstract_state(rcfg, RAdamWConfig(quantized_moments=q8))
    for fsdp in (False, True):
        assert_same_specs(state_shardings(abstract, port_mesh(mesh), cfg, fsdp),
                          RState.state_shardings(r_abstract, ref_mesh(mesh), rcfg,
                                                 fsdp),
                          f"{arch} {mesh} fsdp={fsdp}")


def _shapes_dtypes(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in leaves_with_paths(tree)}


def _ref_shapes_dtypes(tree) -> dict:
    return {k: (tuple(v.shape), str(np.dtype(v.dtype)))
            for k, v in _ref_paths(tree).items()}


@pytest.mark.parametrize("cell", runnable_cells(), ids="/".join)
def test_input_param_and_cache_specs_match_in_shape_and_dtype(cell):
    arch, shape_name = cell
    cfg, rcfg = REGISTRY[arch], ref_configs.REGISTRY[arch]
    got = M.input_specs(cfg, shape_name)
    assert all(t.device.type == "meta" for t in got.values())
    assert _shapes_dtypes(got) == _ref_shapes_dtypes(RM.input_specs(rcfg, shape_name))
    if SHAPES[shape_name].kind == "train":  # once an architecture
        assert _shapes_dtypes(M.param_specs(cfg)) == \
            _ref_shapes_dtypes(ref_abstract_params(arch))
    if SHAPES[shape_name].kind == "decode":
        assert _shapes_dtypes(M.cache_specs(cfg, shape_name)) == \
            _ref_shapes_dtypes(RM.cache_specs(rcfg, shape_name))
    else:
        with pytest.raises(ValueError):
            M.cache_specs(cfg, shape_name)


def test_param_specs_shapes_match():
    """The case of tests/test_system.py:260 on the port."""
    cfg = REGISTRY["yi-9b"]
    ap = abstract_params(cfg)
    specs = S.param_specs_tree(ap, {"data": 1, "model": 1}, cfg, fsdp=True)
    flat_p, flat_s = leaves_with_paths(ap), leaves_with_paths(specs)
    assert len(flat_p) == len(flat_s)
    for (kp, p), (ks, s) in zip(flat_p, flat_s):
        assert kp == ks and len(s) <= len(p.shape)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = port_mesh("2x16x16")
    ns = S.NamedSharding(mesh, (("pod", "data"), None, "model"))
    assert ns.placements() == (Shard(0), Shard(0), Shard(2))
    assert ns.local_shape((64, 3, 32)) == (2, 3, 2)
    assert S.replicated(mesh).placements() == (Replicate(),) * 3
    assert S.NamedSharding(mesh, (None, "data")).placements() == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):  # against the mesh's order
        S.NamedSharding(mesh, (("data", "pod"),)).placements()
    with pytest.raises(ValueError):  # 3 does not divide over 16
        ns.local_shape((64, 3, 3))
    # the rules read the mesh's axis names and sizes, nothing else
    assert S.dp_axes(mesh) == ("pod", "data") and S.dp_size(mesh) == 32
    assert S.axis_size({"data": 4}, "model") == 1


def test_layers_read_the_active_mesh():
    from repro.models import layers as RL
    from repro_torch.models import layers as L

    x = torch.zeros(4, 2)
    for mesh in ("2x2", "2x16x16"):
        with S.use_mesh(port_mesh(mesh)):
            RL.set_mesh_context(ref_mesh(mesh))
            try:
                assert L.batch_axes() == RL.batch_axes()
                assert L._mesh_axis_size("model") == RL._mesh_axis_size("model")
                assert L._mesh_axis_size("pod") == RL._mesh_axis_size("pod")
                assert L.constrain(x, "data", None) is x  # local tensors
            finally:
                RL.set_mesh_context(None)
    assert L.batch_axes() == (None,) and L._mesh_axis_size("model") == 1
