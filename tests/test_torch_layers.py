"""repro_torch.models.layers against the JAX package's, function by
function, in fp32 at smoke shapes with fewer KV heads than query heads:
RMSNorm, softcap, RoPE (theta up to 5e6), chunked attention (causal,
sliding window, logit cap, bias, cross, chunks smaller than the sequence, a
sequence no chunk divides, a query offset), decode attention (ring and
full, the clamped write at pos >= S_cache), the SwiGLU MLP and the MoE (both
dispatch forms, either side of T = 4096, capacity drops, exact router ties
broken by the lower expert index). Tolerance: 1e-5 absolute and relative."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY
from repro.models import layers as R
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name="yi-9b", **kw):
    return replace(REGISTRY[name].smoke(), dtype="float32", **kw)


def _arr(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _attn_params(cfg, rng, bias=False):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": _arr(rng, D, H * hd, scale=D ** -0.5),
         "wk": _arr(rng, D, K * hd, scale=D ** -0.5),
         "wv": _arr(rng, D, K * hd, scale=D ** -0.5),
         "wo": _arr(rng, H * hd, D, scale=D ** -0.5)}
    if bias:
        p.update(bq=_arr(rng, H * hd), bk=_arr(rng, K * hd), bv=_arr(rng, K * hd))
    return p


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


# ------------------------------------------------------------------ helpers
def test_rms_norm_and_softcap():
    rng = np.random.default_rng(0)
    x, s = _arr(rng, 3, 5, 64, scale=3.0), _arr(rng, 64)
    _close(L.rms_norm(_t(x), _t(s), 1e-6), R.rms_norm(jnp.asarray(x),
                                                       jnp.asarray(s), 1e-6))
    for cap in (None, 30.0, 50.0):
        _close(L.softcap(_t(x * 20), cap), R.softcap(jnp.asarray(x * 20), cap))


def test_rms_norm_casts_back_in_bf16():
    rng = np.random.default_rng(1)
    x, s = _arr(rng, 2, 7, 64), _arr(rng, 64)
    got = L.rms_norm(_t(x).bfloat16(), _t(s).bfloat16())
    want = R.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0, 1_000_000.0, 5_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(2)
    x = _arr(rng, 2, 9, 4, 16)
    pos = np.array([0, 1, 7, 100, 1000, 4095, 8191, 32767, 524287], np.int32)
    _close(L.rope(_t(x), _t(pos), theta),
           R.rope(jnp.asarray(x), jnp.asarray(pos), theta))


# ----------------------------------------------------------------- attention
ATTN_CASES = {
    # name: (cfg overrides, Sq, Sk or None, kwargs)
    "causal": ({}, 16, None, dict(causal=True, window=None, cap=None)),
    "window": ({}, 24, None, dict(causal=True, window=5, cap=None)),
    "cap": ({}, 16, None, dict(causal=True, window=None, cap=5.0)),
    "window+cap": ({}, 16, None, dict(causal=True, window=4, cap=2.0)),
    "bias": ({"qkv_bias": True}, 12, None, dict(causal=True, window=None, cap=None)),
    "cross": ({}, 10, 22, dict(causal=False, window=None, cap=None)),
    "chunked": ({}, 32, None, dict(causal=True, window=6, cap=None, chunk_q=8)),
    "non-multiple": ({}, 30, None, dict(causal=True, window=None, cap=None,
                                        chunk_q=8)),
    "bidirectional chunked": ({}, 15, None, dict(causal=False, window=None,
                                                 cap=None, chunk_q=4)),
    "offset": ({"rope_theta": 1_000_000.0}, 8, None,
               dict(causal=True, window=None, cap=None, q_offset=5)),
    "mqa": ({"n_kv_heads": 1}, 16, None, dict(causal=True, window=3, cap=None)),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention(case):
    over, Sq, Sk, kw = ATTN_CASES[case]
    cfg = _cfg(**{"n_kv_heads": 2, **over})
    assert cfg.n_kv_heads < cfg.n_heads
    rng = np.random.default_rng(3)
    jp, tp = _both(_attn_params(cfg, rng, bias=cfg.qkv_bias))
    x = _arr(rng, 2, Sq, cfg.d_model)
    kv = x if Sk is None else _arr(rng, 2, Sk, cfg.d_model)
    want = R.attention(jp, jnp.asarray(x), jnp.asarray(kv), cfg, **kw)
    got = L.attention(tp, _t(x), _t(kv), cfg, **kw)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("pos", [0, 3, 9, 10, 11, 17])
def test_decode_attention(window, pos):
    """S_cache = 10: pos 10, 11 and 17 are past the cache, where the full
    cache's write clamps to slot 9 as ``dynamic_update_slice`` does and the
    ring wraps."""
    cfg = _cfg(n_kv_heads=2)
    rng = np.random.default_rng(4)
    jp, tp = _both(_attn_params(cfg, rng))
    S = 10 if window is None else window
    ck = _arr(rng, 2, S, cfg.n_kv_heads, cfg.hd)
    cv = _arr(rng, 2, S, cfg.n_kv_heads, cfg.hd)
    x = _arr(rng, 2, 1, cfg.d_model)
    wo, wk, wv = R.decode_attention(jp, jnp.asarray(x), jnp.asarray(ck),
                                    jnp.asarray(cv), jnp.int32(pos), cfg,
                                    window=window, cap=3.0)
    ck_t, cv_t = _t(ck), _t(cv)
    go, gk, gv = L.decode_attention(tp, _t(x), ck_t, cv_t,
                                    torch.tensor(pos, dtype=torch.int32), cfg,
                                    window=window, cap=3.0)
    _close(go, wo)
    _close(gk, wk)
    _close(gv, wv)
    # the caches passed in are written in place, at one slot only
    assert gk is ck_t and gv is cv_t
    slot = min(pos, S - 1) if window is None else pos % S
    for got, was in ((gk, ck), (gv, cv)):
        changed = np.flatnonzero(np.any(got.numpy() != was, axis=(0, 2, 3)))
        assert changed.tolist() == [slot]


# ----------------------------------------------------------------- MLP / MoE
def test_mlp():
    cfg = _cfg()
    rng = np.random.default_rng(5)
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"w_gate": _arr(rng, D, Fd, scale=D ** -0.5),
         "w_up": _arr(rng, D, Fd, scale=D ** -0.5),
         "w_down": _arr(rng, Fd, D, scale=Fd ** -0.5)}
    jp, tp = _both(p)
    x = _arr(rng, 2, 11, D)
    _close(L.mlp(tp, _t(x)), R.mlp(jp, jnp.asarray(x)))


def _moe_params(cfg, rng, skew=0.0):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    router = _arr(rng, D, E, scale=D ** -0.5)
    router[:, 0] += skew  # skewed routing overflows expert 0's capacity
    return {"router": router,
            "w_gate": _arr(rng, E, D, Fd, scale=D ** -0.5),
            "w_up": _arr(rng, E, D, Fd, scale=D ** -0.5),
            "w_down": _arr(rng, E, Fd, D, scale=Fd ** -0.5)}


def _kept(cfg, logits: np.ndarray) -> int:
    """Assignments the reference keeps, recomputed from its router logits."""
    T = logits.shape[0]
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), cfg.top_k)
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=cfg.n_experts)
    C = max(8, min(int(np.ceil(T * cfg.top_k / cfg.n_experts
                               * cfg.capacity_factor)), T))
    return int(np.minimum(counts, C).sum())


@pytest.mark.parametrize("name", ["mixtral-8x22b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("B,S", [(2, 5), (1, 4095), (1, 4096), (2, 2100)])
def test_moe_both_dispatch_forms(name, B, S):
    """T = B*S below 4096 scatters the payload, at and above it scatters
    token indices and gathers rows; both against the reference, with
    capacity drops (a skewed router)."""
    cfg = _cfg(name)
    rng = np.random.default_rng(6)
    p = _moe_params(cfg, rng, skew=2.0)
    jp, tp = _both(p)
    # inputs with a positive mean: most tokens pick expert 0
    x = _arr(rng, B, S, cfg.d_model) + 0.5
    want = R.moe(jp, jnp.asarray(x), cfg)
    got = L.moe(tp, _t(x), cfg)
    _close(got, want)
    logits = x.reshape(-1, cfg.d_model) @ p["router"]
    assert _kept(cfg, logits) < B * S * cfg.top_k  # some assignments dropped


@pytest.mark.parametrize("B,S", [(1, 64), (1, 4096)])
def test_moe_exact_ties_take_the_lower_expert(B, S):
    """Inputs on a coarse grid make the router logits exact, with ties
    among experts: both packages then pick the same experts (ties to the
    lower index, as ``lax.top_k``) and drop the same assignments."""
    cfg = _cfg("mixtral-8x22b")
    rng = np.random.default_rng(7)
    p = _moe_params(cfg, rng)
    p["router"] = rng.integers(-1, 2, size=p["router"].shape).astype(np.float32)
    p["router"][:, 1] = p["router"][:, 2]  # experts 1 and 2 always tie
    jp, tp = _both(p)
    x = rng.integers(-2, 3, size=(B, S, cfg.d_model)).astype(np.float32)
    _close(L.moe(tp, _t(x), cfg), R.moe(jp, jnp.asarray(x), cfg))
    vals, idx = L.top_k(torch.tensor([[0.2, 0.3, 0.3, 0.2]]), 3)
    assert idx.tolist() == [[1, 2, 0]]
    _, ref_idx = jax.lax.top_k(jnp.asarray([[0.2, 0.3, 0.3, 0.2]]), 3)
    assert np.asarray(ref_idx).tolist() == idx.tolist()


def test_moe_capacity_floor():
    """C = max(8, min(C, T)): with T = 3 tokens the capacity is 8."""
    cfg = _cfg("qwen3-moe-30b-a3b")
    rng = np.random.default_rng(8)
    jp, tp = _both(_moe_params(cfg, rng, skew=5.0))
    x = _arr(rng, 1, 3, cfg.d_model)
    _close(L.moe(tp, _t(x), cfg), R.moe(jp, jnp.asarray(x), cfg))


# -------------------------------------------------------------------- init
def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_functions_match_the_reference_layout(dtype):
    cfg = replace(_cfg("qwen1.5-4b", n_kv_heads=2), dtype=dtype)
    moe_cfg = replace(_cfg("mixtral-8x22b"), dtype=dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    for ref_fn, port_fn, c in ((R.init_attention, L.init_attention, cfg),
                               (R.init_mlp, L.init_mlp, cfg),
                               (R.init_moe, L.init_moe, moe_cfg)):
        assert _shapes(port_fn(gen, c, tdt)) == _shapes(ref_fn(key, c, jdt))


def test_sharding_hooks_are_no_ops():
    x = torch.ones(2, 3)
    L.set_mesh_context(None)
    assert L.constrain(x, None, "model") is x
    assert L.batch_axes() == R.batch_axes() == (None,)
