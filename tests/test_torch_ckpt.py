"""repro_torch.checkpoint.ckpt: the reference's checkpoint cases of
``tests/test_system.py:78-131`` on the port (atomic commit and roundtrip,
restore onto a device, tree mismatch, gc, ``.tmp`` ignored), the async
writer's snapshot taken before it returns, and checkpoints across packages:
a bf16 state with q8 moments that the port saves restores through
``repro.checkpoint.ckpt.restore`` to equal leaves, one the reference saves
restores in the port to equal leaves, and both write the same keys, shapes,
manifest dtypes and array bytes. Exact: no tolerance."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RC
from repro.models import model as RM
from repro.optim import adamw as RA
from repro_torch.checkpoint import ckpt
from repro_torch.configs import REGISTRY
from repro_torch.convert import state_from_reference
from repro_torch.models.model import build_params
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train.state import make_abstract_state, make_state
from repro_torch.tree import leaves, leaves_with_paths, tree_map

CPU = "cpu"


def _meta(tree):
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _equal_trees(a, b) -> None:
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=k)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with
    XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = REGISTRY["h2o-danube-1.8b"].smoke()
    return cfg, build_params(cfg, seed=0, device=CPU)


def test_checkpoint_atomic_roundtrip(tiny, tmp_path):
    cfg, params = tiny
    opt = AdamWConfig()
    state = {"params": params, "opt": init_state(params, opt),
             "step": torch.tensor(7, dtype=torch.int32)}
    d = str(tmp_path / "ck")
    path = ckpt.save(state, 7, d)
    assert path == os.path.join(d, "step_00000007")
    assert sorted(os.listdir(path)) == ["MANIFEST.json", "shard_0.npz"]
    assert ckpt.latest_step(d) == 7
    restored, step = ckpt.restore(d, _meta(state), device=CPU)
    assert step == 7
    _equal_trees(restored, state)
    # the abstract state of the config is the same tree
    restored, _ = ckpt.restore(d, make_abstract_state(cfg, opt), device=CPU)
    _equal_trees(restored, state)


def test_checkpoint_restores_onto_the_device_asked_for(tiny, tmp_path):
    """The port's form of the reference's elastic restore: leaves are
    placed on ``device``, whatever device the tree given holds; the card
    is the default and is refused without one."""
    cfg, params = tiny
    state = {"params": params, "step": torch.tensor(3, dtype=torch.int32)}
    d = str(tmp_path / "ck2")
    ckpt.save(state, 3, d)
    restored, _ = ckpt.restore(d, _meta(state), device=torch.device("cpu"))
    assert {t.device.type for t in leaves(restored)} == {"cpu"}
    _equal_trees(restored, state)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ckpt.restore(d, _meta(state))


def test_checkpoint_detects_tree_mismatch(tmp_path):
    d = str(tmp_path / "ckm")
    ckpt.save({"x": torch.tensor(1, dtype=torch.int32)}, 1, d)
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(d, {"y": torch.empty((), dtype=torch.int32)}, device=CPU)
    with pytest.raises(ValueError, match="mismatch: x has shape"):
        ckpt.restore(d, {"x": torch.empty((2,), dtype=torch.int32)}, device=CPU)


def test_checkpoint_gc(tmp_path):
    d = str(tmp_path / "ck3")
    for s in (1, 2, 3, 4):
        ckpt.save({"x": torch.tensor(s, dtype=torch.int32)}, s, d)
    removed = ckpt.gc(d, keep=2)
    assert len(removed) == 2
    assert ckpt.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]


def test_checkpoint_tmp_dir_ignored(tmp_path):
    d = str(tmp_path / "ck4")
    ckpt.save({"x": torch.tensor(1, dtype=torch.int32)}, 1, d)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # simulated dead writer
    assert ckpt.latest_step(d) == 1
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {}, device=CPU)


def test_async_checkpointer_snapshots_before_it_returns(tiny, tmp_path):
    """The train step writes the state in place: what the writer saves is
    the state as it was when ``save`` returned."""
    cfg, params = tiny
    state = make_state(cfg, AdamWConfig(), seed=1, device=CPU)
    want = tree_map(torch.clone, state)
    writer = ckpt.AsyncCheckpointer(str(tmp_path / "async"))
    writer.save(state, 5)
    for t in leaves(state):
        t.add_(1)  # the next step, before the write has finished
    writer.wait()
    assert writer.last_path.endswith("step_00000005")
    restored, step = ckpt.restore(str(tmp_path / "async"), _meta(state), device=CPU)
    assert step == 5
    _equal_trees(restored, want)


@pytest.fixture(scope="module")
def ref_state():
    """The reference's bf16 state with q8 moments after one update, so that
    every leaf holds data."""
    cfg = REGISTRY["jamba-1.5-large-398b"].smoke()
    opt = RA.AdamWConfig(quantized_moments=True)
    params = RM.build_params(cfg, seed=0)
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, opt_state = jax.jit(lambda p, g, s: RA.apply_updates(p, g, s, opt))(
        params, grads, RA.init_state(params, opt))
    return {"params": params, "opt": opt_state, "step": jnp.int32(11)}


def _ref_leaves(tree) -> dict:
    return dict(leaves_with_paths(jax.tree_util.tree_map(np.asarray, tree)))


def test_a_port_checkpoint_restores_in_the_reference(ref_state, tmp_path):
    port = state_from_reference(jax.tree_util.tree_map(np.asarray, ref_state),
                                device=CPU)
    d = str(tmp_path / "port")
    ckpt.save(port, 11, d)
    got, step = RC.restore(d, jax.eval_shape(lambda: ref_state))
    assert step == 11
    want, have = _ref_leaves(ref_state), _ref_leaves(got)
    assert want.keys() == have.keys()
    for k, w in want.items():
        assert have[k].dtype == w.dtype, k
        np.testing.assert_array_equal(have[k].reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8), err_msg=k)


def test_a_reference_checkpoint_restores_in_the_port(ref_state, tmp_path):
    d = str(tmp_path / "ref")
    RC.save(ref_state, 11, d)
    want = state_from_reference(jax.tree_util.tree_map(np.asarray, ref_state),
                                device=CPU)
    got, step = ckpt.restore(d, _meta(want), device=CPU)
    assert step == 11
    _equal_trees(got, want)
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["opt"]["m"]["embed"]["q"].dtype == torch.int8


def test_both_packages_write_the_same_files(ref_state, tmp_path):
    port = state_from_reference(jax.tree_util.tree_map(np.asarray, ref_state),
                                device=CPU)
    RC.save(ref_state, 11, str(tmp_path / "ref"))
    ckpt.save(port, 11, str(tmp_path / "port"))
    files = {}
    for who in ("ref", "port"):
        path = tmp_path / who / "step_00000011"
        manifest = json.loads((path / "MANIFEST.json").read_text())
        with np.load(path / "shard_0.npz") as z:
            files[who] = (manifest, {k: z[k] for k in z.files})
    (m_ref, a_ref), (m_port, a_port) = files["ref"], files["port"]
    assert m_port["step"] == m_ref["step"] == 11
    for key in ("keys", "shapes", "dtypes"):
        assert m_port[key] == m_ref[key], key
    assert "bfloat16" in m_port["dtypes"].values()
    assert a_port.keys() == a_ref.keys()
    for k in a_ref:
        assert a_port[k].dtype == a_ref[k].dtype, k
        np.testing.assert_array_equal(a_port[k], a_ref[k], err_msg=k)
