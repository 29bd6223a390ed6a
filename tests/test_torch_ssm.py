"""repro_torch.models.ssm against the JAX package's, in fp32 at smoke shapes:
the causal conv, ``ssd_apply`` over one chunk and several (with and without
its decode state), ``ssd_decode``, the conv tail when S < W-1, softplus
past torch's threshold of 20; and the port against itself: ``ssd_apply``
with its state followed by ``ssd_decode`` steps equals ``ssd_apply`` over
the longer sequence. Tolerance: 1e-5 absolute and relative."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY
from repro.models import ssm as R
from repro_torch.models import ssm as M

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with
    XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name="mamba2-780m"):
    return replace(REGISTRY[name].smoke(), dtype="float32")


def _params(cfg, seed=0):
    """Random SSM parameters with non-trivial biases, norms and decays."""
    rng = np.random.default_rng(seed)
    D = cfg.d_model
    inner, H, P, N = M.ssm_dims(cfg)
    W = cfg.ssm_conv

    def a(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return {"w_z": a(D, inner, s=D ** -0.5), "w_x": a(D, inner, s=D ** -0.5),
            "w_BC": a(D, 2 * N, s=D ** -0.5), "w_dt": a(D, H, s=D ** -0.5),
            "conv_x": a(W, inner, s=0.3), "conv_bx": a(inner, s=0.1),
            "conv_BC": a(W, 2 * N, s=0.3), "conv_bBC": a(2 * N, s=0.1),
            "A_log": np.log(np.linspace(1.0, 16.0, H)).astype(np.float32),
            "D": a(H), "dt_bias": a(H, s=0.5), "norm": a(inner, s=0.1),
            "w_out": a(inner, D, s=inner ** -0.5)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _close(got, want, **tol):
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _close(got[k], want[k], **tol)
        return
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def test_softplus_past_torchs_threshold():
    x = np.array([-40.0, -5.0, 0.0, 3.0, 19.9, 20.0, 20.1, 25.0, 80.0], np.float32)
    np.testing.assert_array_equal(M.softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x))))


@pytest.mark.parametrize("S", [1, 2, 3, 9])
def test_causal_conv(S):
    rng = np.random.default_rng(2)
    u = rng.normal(size=(2, S, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    _close(M._causal_conv(*map(torch.from_numpy, (u, w, b))),
           R._causal_conv(*map(jnp.asarray, (u, w, b))))


@pytest.mark.parametrize("name", ["mamba2-780m", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("S,chunk", [(1, 128), (2, 128), (3, 128), (37, 128),
                                     (64, 16), (256, 128)])
def test_ssd_apply_with_and_without_state(name, S, chunk):
    """One chunk (S % chunk != 0 takes chunk = S), several chunks (64/16,
    256/128), and the conv tail when S < W-1 (S = 1, 2)."""
    cfg = _cfg(name)
    jp, tp = _both(_params(cfg))
    x = _x(cfg, 2, S)
    want = R.ssd_apply(jp, jnp.asarray(x), cfg, chunk=chunk)
    tol = TOL
    if S > chunk:
        # several chunks: the carried state sums a chunk's terms in another
        # order than XLA's, and the RMS norm rescales that rounding (about
        # 4e-6 of the output's largest value, 40 ulp there) onto outputs
        # near 0, so the absolute bound is 1e-5 of the largest output
        tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    _close(M.ssd_apply(tp, torch.from_numpy(x), cfg, chunk=chunk), want, **tol)
    got, got_st = M.ssd_apply(tp, torch.from_numpy(x), cfg, chunk=chunk,
                              return_state=True)
    want, want_st = R.ssd_apply(jp, jnp.asarray(x), cfg, chunk=chunk,
                                return_state=True)
    _close(got, want, **tol)
    _close(got_st, want_st)


def test_init_ssm_layout_and_cache():
    cfg = _cfg()
    gen, key = torch.Generator().manual_seed(0), jax.random.PRNGKey(0)
    got = M.init_ssm(gen, cfg, torch.float32)
    want = R.init_ssm(key, cfg, jnp.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for k in ("A_log", "D", "dt_bias", "norm", "conv_bx", "conv_bBC"):
        _close(got[k], want[k])  # the deterministic leaves are equal
    _close(M.init_ssm_cache(cfg, 3, torch.float32),
           R.init_ssm_cache(cfg, 3, jnp.float32))


def test_ssd_decode_steps():
    cfg = _cfg()
    jp, tp = _both(_params(cfg))
    rng = np.random.default_rng(3)
    inner, H, P, N = M.ssm_dims(cfg)
    cache = {"state": rng.normal(size=(2, H, P, N)).astype(np.float32),
             "conv_x": rng.normal(size=(2, 3, inner)).astype(np.float32),
             "conv_BC": rng.normal(size=(2, 3, 2 * N)).astype(np.float32)}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    for step in range(4):
        x = _x(cfg, 2, 1, seed=10 + step)
        want, jc = R.ssd_decode(jp, jnp.asarray(x), jc, cfg)
        got, tc = M.ssd_decode(tp, torch.from_numpy(x), tc, cfg)
        _close(got, want)
        _close(tc, jc)


@pytest.mark.parametrize("S,k", [(2, 5), (16, 8), (128, 4)])
def test_state_then_decode_equals_the_longer_sequence(S, k):
    """ssd_apply over S tokens, then k ssd_decode steps, gives the outputs
    of ssd_apply over all S + k tokens at those positions (S = 2 < W-1
    starts from the padded conv tail)."""
    cfg = _cfg()
    _, tp = _both(_params(cfg, seed=4))
    x = torch.from_numpy(_x(cfg, 2, S + k, seed=5))
    full = M.ssd_apply(tp, x, cfg)
    _, cache = M.ssd_apply(tp, x[:, :S], cfg, return_state=True)
    for i in range(k):
        out, cache = M.ssd_decode(tp, x[:, S + i : S + i + 1], cache, cfg)
        np.testing.assert_allclose(out.numpy(), full[:, S + i : S + i + 1].numpy(),
                                   **TOL)
