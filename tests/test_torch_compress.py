"""repro_torch.distributed.compress (int8-wire mean all-reduce with error
feedback, on ``torch.distributed``) against the JAX package's
``compressed_pmean``, on spawned gloo ranks (``tests/_torch_dist.py``).

* World 1: the case of ``tests/test_system.py:217`` (the mean within the
  quantisation bound, the feedback == the input minus the mean), and the
  reference's output and feedback.
* Worlds 2 and 4, the same tree on every rank: the reference, jitted, over
  2 and 4 forced host devices in a subprocess (``shard_map`` replicates its
  input over the axis, so it can only take the same tree everywhere). Gate:
  one int8 step of the second scale, elementwise; the elements of the mean
  that differ are counted (0 in the runs so far: the same fp32 operations,
  rounding half to even on both sides). The error feedback is within one
  fp32 ulp of the leaf's largest input (XLA contracts ``g - q * scale``
  into one FMA under jit).
* Worlds 2 and 4, a different tree on each rank: a numpy model of the same
  algorithm, with the same gate.
* Two calls in a row (the feedback carried) and the bytes on the wire: two
  4-byte all-reduces, an int8 all-to-all and an int8 all-gather of the
  padded leaf a leaf, about 2 B an element.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import compress_worker, run_ranks
from repro.distributed.compress import compressed_pmean as ref_pmean
from repro.distributed.compress import init_error_feedback as ref_init_ef
from repro.distributed.sharding import use_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"a": (64, 64), "b": (1001,), "c": (3, 5, 7)}  # b and c pad


def tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) * (1 + i)
            for i, (k, s) in enumerate(SHAPES.items())}


def np_model(trees: list, efs: list):
    """The algorithm on rank trees in numpy fp32: (mean, [feedback a rank],
    second scale) by leaf."""
    n = len(trees)
    mean, new_ef, scale2s = {}, [{} for _ in trees], {}
    for k in trees[0]:
        g = [t[k].astype(np.float32) + e[k] for t, e in zip(trees, efs)]
        scale = np.float32(max(np.abs(x).max() for x in g)) / np.float32(127.0)
        scale = max(scale, np.float32(1e-12))
        q = [np.clip(np.round(x / scale), -127, 127).astype(np.int8) for x in g]
        for i in range(n):
            new_ef[i][k] = g[i] - q[i].astype(np.float32) * scale
        size = g[0].size
        pad = (-size) % n
        chunks = [np.pad(x.reshape(-1), (0, pad)).reshape(n, -1) for x in q]
        parts = [sum(c[j].astype(np.int32) for c in chunks) for j in range(n)]
        psum = [p.astype(np.float32) * scale for p in parts]
        scale2 = np.float32(max(np.abs(p).max() for p in psum)) / np.float32(127.0)
        scale2 = max(scale2, np.float32(1e-12))
        q2 = [np.clip(np.round(p / scale2), -127, 127).astype(np.int8) for p in psum]
        total = np.concatenate(q2).astype(np.float32) * scale2
        mean[k] = (total[:size] / np.float32(n)).reshape(g[0].shape)
        scale2s[k] = float(scale2)
    return mean, new_ef, scale2s


def expected_bytes(n: int) -> dict:
    padded = sum(-(-int(np.prod(s)) // n) * n for s in SHAPES.values())
    return {"all-reduce": 2 * 4 * len(SHAPES), "all-to-all": padded,
            "all-gather": padded}


def within_a_step(got: dict, want: dict, scale2: dict, what: str) -> int:
    """Every element within one int8 step of the second scale; returns the
    count of elements that differ at all."""
    differ = 0
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, (what, k)
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        assert d.max() <= scale2[k] * (1 + 1e-6), (what, k, d.max(), scale2[k])
        differ += int((d > 0).sum())
    return differ


@pytest.fixture(scope="module")
def ref_same():
    """The reference over 2 and 4 forced host devices, the same tree (seed
    0) on every device, two calls: {n: (mean, ef, mean2, ef2)}."""
    code = f"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.distributed.compress import compressed_pmean, init_error_feedback
from repro.distributed.sharding import use_mesh
SHAPES = {SHAPES!r}
rng = np.random.default_rng(0)
t = {{k: jnp.asarray(rng.normal(size=s).astype(np.float32) * (1 + i))
      for i, (k, s) in enumerate(SHAPES.items())}}
out = {{}}
for n in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))
    run = jax.jit(lambda a, e: compressed_pmean(a, e, mesh, axis="pod"))
    with use_mesh(mesh):
        m1, e1 = run(t, init_error_feedback(t))
        m2, e2 = run(t, e1)
    out[n] = [{{k: np.asarray(v).tolist() for k, v in x.items()}} for x in (m1, e1, m2, e2)]
print(json.dumps(out))
"""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    raw = json.loads(proc.stdout.strip().splitlines()[-1])
    return {int(n): [{k: np.asarray(v, np.float32) for k, v in x.items()} for x in vals]
            for n, vals in raw.items()}


def _load(out, name, rank):
    return torch.load(os.path.join(out, f"{name}-rank{rank}.pt"), weights_only=False)


def _np(t: dict) -> dict:
    return {k: v.numpy() for k, v in t.items()}


def test_world_one_is_the_reference_and_the_system_case(tmp_path):
    t = tree(0)
    out = run_ranks(1, compress_worker, ([("same", [t])],), tmp_path)
    got = _load(out, "same", 0)
    # the case of tests/test_system.py:217 on the port
    err = np.abs(got["mean"]["a"].numpy() - t["a"]).max()
    assert err <= np.abs(t["a"]).max() / 127.0 * 1.01
    np.testing.assert_allclose(got["ef"]["a"].numpy(), t["a"] - got["mean"]["a"].numpy(),
                               atol=1e-6)
    # the reference on one device, two calls
    mesh = jax.make_mesh((1,), ("pod",))
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    with use_mesh(mesh):
        m1, e1 = ref_pmean(jt, ref_init_ef(jt), mesh, axis="pod")
        m2, e2 = ref_pmean(jt, e1, mesh, axis="pod")
    for key, ref in (("mean", m1), ("ef", e1), ("mean2", m2), ("ef2", e2)):
        for k in SHAPES:
            np.testing.assert_array_equal(got[key][k].numpy(), np.asarray(ref[k]),
                                          err_msg=f"{key} {k}")
    assert got["bytes"] == expected_bytes(1)
    assert got["calls"] == {"all-reduce": 6, "all-to-all": 3, "all-gather": 3}


@pytest.mark.parametrize("world", [2, 4])
def test_worlds_two_and_four(world, tmp_path, ref_same):
    same = [tree(0)] * world
    different = [tree(10 + r) for r in range(world)]
    out = run_ranks(world, compress_worker,
                    ([("same", same), ("different", different)],), tmp_path)
    zero = [{k: np.zeros(s, np.float32) for k, s in SHAPES.items()}] * world
    differ = {}
    for name, trees in (("same", same), ("different", different)):
        want, want_ef, scale2 = np_model(trees, zero)
        ranks = [_load(out, name, r) for r in range(world)]
        for r, got in enumerate(ranks):
            differ[(name, r)] = within_a_step(_np(got["mean"]), want, scale2,
                                              f"{name} rank {r} vs numpy")
            for k in SHAPES:  # the feedback is the rank's own: exact
                np.testing.assert_array_equal(got["ef"][k].numpy(), want_ef[r][k])
            assert got["bytes"] == expected_bytes(world), got["bytes"]
        # the second call, its feedback carried, against the model too
        want2, _, scale2b = np_model(trees, [_np(g["ef"]) for g in ranks])
        for r, got in enumerate(ranks):
            within_a_step(_np(got["mean2"]), want2, scale2b, f"{name} call 2 rank {r}")
        if name == "same":  # the reference can only take the same tree everywhere
            m1, e1, m2, e2 = ref_same[world]
            for r, got in enumerate(ranks):
                differ[("reference", r)] = within_a_step(_np(got["mean"]), m1, scale2,
                                                         f"rank {r} vs the reference")
                within_a_step(_np(got["mean2"]), m2, scale2b, f"rank {r} call 2 vs ref")
                for k in SHAPES:  # XLA fuses g - q * scale into an FMA under
                    # jit: one fp32 ulp of the leaf's largest input apart
                    ulp = np.spacing(np.abs(trees[0][k]).max())
                    np.testing.assert_allclose(got["ef"][k].numpy(), e1[k], rtol=0,
                                               atol=ulp)
    # the elements that differ at all (documented in the module's docstring)
    assert differ == {k: 0 for k in differ}, differ
