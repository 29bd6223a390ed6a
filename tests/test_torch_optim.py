"""repro_torch.optim.adamw against the JAX package's ``repro.optim.adamw``
on the same inputs: ``quantize_q8`` (``q`` exact, ``scale`` within 1e-7
relative), ``dequantize_q8``, ``global_norm``, ``init_state`` and
``abstract_state``'s layout, two ``apply_updates`` steps (plain moments,
q8 moments, and with the clip by the global norm active) and
``cosine_schedule``; then the reference's optimizer cases of
``tests/test_system.py`` on the port. Tolerances: fp32 parameters and
moments within 1e-6 of each leaf's largest absolute value, bf16 ones
within one bf16 rounding (2^-8 relative)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as R
from repro_torch.configs import REGISTRY
from repro_torch.models.model import build_params, demo_batch, loss_fn
from repro_torch.optim import adamw as A
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import leaves, leaves_with_paths, tree_map

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with
    XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("n,scale", [(1000, 0.01), (256, 1.0), (257, 3e-5),
                                     (3 * 256, 100.0), (1, 1.0), (4096, 1e-14)])
def test_quantize_q8_is_the_reference(n, scale):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(n,)) * scale).astype(np.float32)
    x[: n // 3] *= 1e-3  # blocks of very different magnitudes
    want = R.quantize_q8(jnp.asarray(x))
    got = A.quantize_q8(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]),
                               rtol=1e-7, atol=0)
    np.testing.assert_array_equal(
        A.dequantize_q8(got, (n,)).numpy(),
        np.asarray(R.dequantize_q8({"q": jnp.asarray(got["q"].numpy()),
                                    "scale": jnp.asarray(got["scale"].numpy())},
                                   (n,))))


def test_quantize_zeros_keeps_the_scale_floor():
    got = A.quantize_q8(torch.zeros(300))
    assert torch.all(got["q"] == 0)
    assert torch.all(got["scale"] == torch.tensor(1e-12, dtype=torch.float32))


def test_quantize_roundtrip():
    """``tests/test_system.py::test_quantize_roundtrip`` on the port."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(1000,)) * 0.01).astype(np.float32))
    back = A.dequantize_q8(A.quantize_q8(x), x.shape)
    np.testing.assert_allclose(back.numpy(), x.numpy(),
                               atol=float(x.abs().max()) / 100)


def _tree(rng, scale=1.0):
    """A parameter-shaped tree: nested dicts, a stacked leaf, a scalar, a
    leaf whose size is not a multiple of the q8 block, one in bf16."""
    def arr(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"embed": arr(33, 16), "final_norm": arr(16),
            "blocks": {"l0": {"w": arr(3, 16, 40), "xgate": arr()}},
            "head": arr(16, 7).astype(jnp.bfloat16)}


def _grads(rng, params, scale):
    return jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32)
        .astype(p.dtype), params)


@pytest.mark.parametrize("case", ["plain", "clipped", "q8"])
def test_apply_updates_is_the_reference(case):
    """Two steps with a schedule factor: the parameters, both moments and
    the count equal the reference's. ``plain`` keeps the gradients' global
    norm under ``grad_clip``, ``clipped`` puts it far above."""
    rng = np.random.default_rng(7)
    cfg = dict(lr=1e-2, quantized_moments=case == "q8")
    gscale = 30.0 if case == "clipped" else 1e-3
    params = _tree(rng)
    ref_p = jax.tree_util.tree_map(jnp.asarray, params)
    port_p = tree_map(_t, params)
    ref_s = R.init_state(ref_p, R.AdamWConfig(**cfg))
    port_s = A.init_state(port_p, A.AdamWConfig(**cfg))
    for step, lr_scale in enumerate((0.5, 1.0)):
        grads = _grads(rng, params, gscale)
        gnorm = float(R.global_norm(grads))
        assert (gnorm > 1.0) == (case == "clipped"), gnorm
        assert float(A.global_norm(tree_map(_t, grads))) == pytest.approx(
            gnorm, rel=1e-6)
        ref_p, ref_s = R.apply_updates(ref_p, grads, ref_s, R.AdamWConfig(**cfg),
                                       jnp.float32(lr_scale))
        port_p, port_s = A.apply_updates(port_p, tree_map(_t, grads), port_s,
                                         A.AdamWConfig(**cfg),
                                         torch.tensor(lr_scale))
        assert int(port_s["count"]) == int(ref_s["count"]) == step + 1
        want = dict(leaves_with_paths(jax.tree_util.tree_map(
            np.asarray, {"params": ref_p, "m": ref_s["m"], "v": ref_s["v"]})))
        got = dict(leaves_with_paths({"params": port_p, "m": port_s["m"],
                                      "v": port_s["v"]}))
        assert got.keys() == want.keys()
        for k, w in want.items():
            g = got[k]
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), k
            if k.endswith("/q"):
                np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
                continue
            bound = (2 ** -8 if g.dtype == torch.bfloat16 else 1e-6) * \
                max(float(np.abs(_f32(w)).max()), 1e-30)
            np.testing.assert_allclose(_np(g), _f32(w), rtol=0, atol=bound,
                                       err_msg=f"{case} step {step} {k}")


def test_apply_updates_writes_in_place():
    rng = np.random.default_rng(3)
    params = tree_map(_t, _tree(rng))
    state = A.init_state(params, A.AdamWConfig())
    ids = [id(x) for x in leaves(params) + leaves(state["m"])]
    before = [x.clone() for x in leaves(params)]
    new_p, new_s = A.apply_updates(params, tree_map(torch.ones_like, params),
                                   state, A.AdamWConfig())
    assert [id(x) for x in leaves(new_p) + leaves(new_s["m"])] == ids
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves(new_p)))


@pytest.mark.parametrize("quant", [False, True])
def test_init_and_abstract_state_are_the_reference_layout(quant):
    cfg = REGISTRY["jamba-1.5-large-398b"].smoke()
    params = build_params(cfg, seed=0, device=CPU)
    ref = jax.eval_shape(lambda: R.init_state(
        jax.tree_util.tree_map(lambda p: jnp.zeros(p.shape, str(p.dtype).replace(
            "torch.", "")), params), R.AdamWConfig(quantized_moments=quant)))
    want = [(k, tuple(v.shape), str(v.dtype)) for k, v in leaves_with_paths(
        {"m": ref["m"], "v": ref["v"], "count": ref["count"]})]
    opt = A.AdamWConfig(quantized_moments=quant)
    for state, device in ((A.init_state(params, opt), "cpu"),
                          (A.abstract_state(params, opt), "meta")):
        got = [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in leaves_with_paths(state)]
        assert got == want
        assert {v.device.type for v in leaves(state)} == {device}
    assert all(not torch.any(v) for v in leaves(A.init_state(params, opt)))


@pytest.mark.parametrize("step", [0, 50, 100, 5000, 9999, 12000])
def test_cosine_schedule_is_the_reference(step):
    want = float(R.cosine_schedule(jnp.int32(step)))
    for arg in (step, torch.tensor(step, dtype=torch.int32)):
        got = A.cosine_schedule(arg)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_cosine_schedule_shape():
    """``tests/test_system.py::test_cosine_schedule_shape`` on the port."""
    assert float(A.cosine_schedule(0, warmup=10, total=100)) == 0.0
    assert abs(float(A.cosine_schedule(10, warmup=10, total=100)) - 1.0) < 1e-6
    end = float(A.cosine_schedule(100, warmup=10, total=100))
    assert 0.09 < end < 0.11


@pytest.fixture(scope="module")
def tiny():
    cfg = REGISTRY["h2o-danube-1.8b"].smoke()
    return cfg, build_params(cfg, seed=0, device=CPU)


def test_adamw_reduces_loss(tiny):
    """``tests/test_system.py::test_adamw_reduces_loss`` on the port."""
    cfg, params = tiny
    opt = A.AdamWConfig(lr=1e-2)
    step = make_train_step(cfg, opt, schedule_total=100)
    p = tree_map(torch.clone, params)
    state = {"params": p, "opt": A.init_state(p, opt),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = demo_batch(cfg, batch=2, seq=32, kind="train", device=CPU)
    losses = []
    for _ in range(5):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_adamw_quantized_close_to_exact(tiny):
    """``tests/test_system.py::test_adamw_quantized_close_to_exact`` on the
    port: leaf 5 in the reference's (sorted) order."""
    cfg, params = tiny
    batch = demo_batch(cfg, batch=2, seq=16, kind="train", device=CPU)
    flat = [p.detach().clone().requires_grad_() for p in leaves(params)]
    from repro_torch.tree import unflatten
    loss = loss_fn(unflatten(params, flat), batch, cfg)
    grads = unflatten(params, list(torch.autograd.grad(loss, flat)))
    outs = {}
    for quant in (False, True):
        opt = A.AdamWConfig(lr=1e-3, quantized_moments=quant)
        p = tree_map(torch.clone, params)
        outs[quant], _ = A.apply_updates(p, grads, A.init_state(p, opt), opt)
    a = leaves(outs[False])[5].float()
    b = leaves(outs[True])[5].float()
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3)
    assert leaves(params)[5].shape == a.shape
    assert not torch.equal(a, leaves(params)[5].float())  # it moved


def test_a_bf16_config_trains(tiny):
    """bf16 parameters stay bf16 through a step; the fp32 router stays fp32."""
    cfg = replace(REGISTRY["qwen3-moe-30b-a3b"].smoke())
    params = build_params(cfg, seed=1, device=CPU)
    opt = A.AdamWConfig()
    dtypes = [p.dtype for p in leaves(params)]
    state = {"params": params, "opt": A.init_state(params, opt),
             "step": torch.tensor(10, dtype=torch.int32)}
    state, m = make_train_step(cfg, opt)(state, demo_batch(cfg, 2, 16, device=CPU))
    assert np.isfinite(float(m["loss"]))
    assert [p.dtype for p in leaves(state["params"])] == dtypes
    assert int(state["step"]) == 11 and int(state["opt"]["count"]) == 1
