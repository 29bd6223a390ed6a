"""Checkpoints across meshes and packages, and the launcher on a mesh.

A state trained one step at mesh (2, 2) on spawned gloo ranks is saved
(every rank gathers, rank 0 writes whole leaves) and restored with
``restore(..., shardings=)`` at (1, 1) and (2, 1), without a mesh, and by
the JAX package's ``restore``; a checkpoint the reference wrote restores
onto (2, 2). Every restore equals the saved state exactly. Then
``repro_torch.launch.train --smoke --device cpu --mesh 2,1`` under
``python -m torch.distributed.run`` (two processes, a free port) gives the
losses of the launcher without a mesh, and its checkpoint holds the same
keys; ``--mesh`` whose ``d * m`` is not the number of processes is refused.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_dist import initial_state, run_ranks, smoke_cfg, train_then_restore
from _torch_dist import restore_worker
from repro.checkpoint import ckpt as ref_ckpt
from repro_torch.checkpoint import ckpt
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import make_abstract_state
from repro_torch.tree import leaves_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = smoke_cfg("qwen3-moe-30b-a3b", 16384)
RUN_S = 300


def assert_same(got, want, what: str) -> None:
    g, w = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
    assert g.keys() == w.keys(), what
    for k in w:
        a, b = torch.as_tensor(np.asarray(g[k])), torch.as_tensor(np.asarray(w[k]))
        assert a.dtype == b.dtype and torch.equal(a, b), (what, k)


def test_checkpoints_restore_exactly_across_meshes_and_packages(tmp_path):
    opt = AdamWConfig()
    # a checkpoint written by the reference, of the port's initial state
    start = initial_state(CFG, opt)
    ref_dir = str(tmp_path / "ref")
    ref_ckpt.save(jax.tree.map(np.asarray, {k: v for k, v in _np_tree(start).items()}),
                  7, ref_dir)
    out = run_ranks(4, train_then_restore, (
        CFG, [("trained", (2, 2), True, False, False, 1, False)],
        [("from-ref", (2, 2), ref_dir, False)]), tmp_path)
    saved = torch.load(os.path.join(out, "trained.pt"), weights_only=False)["states"][0]
    mesh_dir = os.path.join(out, "ckpt-trained")
    assert ckpt.latest_step(mesh_dir) == 1
    # the reference's checkpoint onto (2, 2): exact, and sharded on the ranks
    from_ref = torch.load(os.path.join(out, "from-ref.pt"), weights_only=False)
    assert from_ref["step"] == 7
    assert_same(from_ref["state"], start, "reference checkpoint at (2, 2)")
    assert from_ref["local_numel"] < sum(t.numel() for _, t in leaves_with_paths(start))
    # the (2, 2) checkpoint at (2, 1) and (1, 1)
    for world, shape in ((2, (2, 1)), (1, (1, 1))):
        got = run_ranks(world, restore_worker, (CFG, [("back", shape, mesh_dir, False)]),
                        tmp_path / f"w{world}")
        back = torch.load(os.path.join(got, "back.pt"), weights_only=False)
        assert back["step"] == 1
        assert_same(back["state"], saved, f"(2, 2) checkpoint at {shape}")
    # without a mesh, and in the reference
    plain, step = ckpt.restore(mesh_dir, make_abstract_state(CFG, opt), device="cpu")
    assert step == 1
    assert_same(plain, saved, "(2, 2) checkpoint without a mesh")
    abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            _np_tree(saved))
    ref_state, ref_step = ref_ckpt.restore(mesh_dir, abstract)
    assert ref_step == 1
    assert_same(jax.tree.map(np.asarray, ref_state), saved, "(2, 2) checkpoint in repro")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _train(args, env_extra=None, torchrun: int = 0):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    env.pop("WORLD_SIZE", None)
    env.update(env_extra or {})
    head = [sys.executable, "-m"]
    if torchrun:
        head += ["torch.distributed.run", "--standalone", "--nproc-per-node",
                 str(torchrun), "-m"]
    return subprocess.run(head + ["repro_torch.launch.train", *args], capture_output=True,
                          text=True, env=env, timeout=RUN_S)


def test_launcher_on_a_mesh_gives_the_unsharded_losses(tmp_path):
    common = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4", "--seq",
              "32", "--data-mib", "1", "--ckpt-every", "3"]
    runs = {}
    for name, extra, nproc in (("plain", [], 0), ("mesh", ["--mesh", "2,1"], 2)):
        stats = tmp_path / f"{name}.json"
        proc = _train(common + extra + ["--ckpt-dir", str(tmp_path / name),
                                        "--stats-json", str(stats)], torchrun=nproc)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs[name] = json.loads(stats.read_text())
    assert runs["mesh"]["mesh"] == "2,1" and runs["mesh"]["steps_run"] == 3
    np.testing.assert_allclose(runs["mesh"]["losses"], runs["plain"]["losses"],
                               rtol=1e-4, atol=0)
    # rank 0 alone printed and saved; the checkpoint has the one-device keys
    assert proc.stdout.count("done: 3 steps") == 1
    keys = [sorted(json.load(open(tmp_path / n / "step_00000003" / "MANIFEST.json"))["keys"])
            for n in ("plain", "mesh")]
    assert keys[0] == keys[1]


@pytest.mark.parametrize("mesh,nproc", [("2,1", 0), ("1,1", 2)])
def test_launcher_refuses_a_mesh_of_another_size(mesh, nproc):
    """d * m must be the number of processes: no padding, no fallback."""
    env = {"WORLD_SIZE": str(max(nproc, 1))} if nproc else None
    proc = _train(["--smoke", "--device", "cpu", "--mesh", mesh], env_extra=env)
    assert proc.returncode == 2
    assert f"--mesh {mesh} needs" in proc.stderr and proc.stdout == ""
