"""repro_torch.models against the JAX package's for all ten architectures
at their smoke configs, in fp32, on the reference's parameters converted by
``repro_torch.convert.params_from_reference``: the logits of
``model_forward``, ``serve_prefill`` (and every leaf of its cache) and 8
``serve_decode`` steps fed the reference's greedy ids, which the port's must
equal. The decode steps run past ``max_seq`` (the full-attention caches'
clamped write, the rings' wrap), and a second prefill has S > max_seq (the
full-attention sublayers take the ring branch). Also ``loss_fn``, the
configs and ``demo_batch``. Tolerance: 1e-4 absolute and relative for
whole-model logits and caches."""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as R
from repro_torch import configs
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.models import model as M

ARCHS = sorted(ref_configs.REGISTRY)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with
    XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)


def _close_tree(got, want, what):
    g, w = dict(_leaves(got)), dict(_leaves(_np_tree(want)))
    assert g.keys() == w.keys(), what
    for k in g:
        assert tuple(g[k].shape) == w[k].shape, (what, k)
        _close(g[k], w[k], f"{what} {k}")


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name):
        if name not in cache:
            cfg = replace(ref_configs.REGISTRY[name].smoke(), dtype="float32")
            ref = R.build_params(cfg, seed=0)
            cache[name] = (cfg, ref, params_from_reference(_np_tree(ref),
                                                           device="cpu"))
        return cache[name]

    return get


@pytest.mark.parametrize("name", ARCHS)
def test_forward_prefill_decode_match_the_reference(pairs, name):
    cfg, ref, port = pairs(name)
    batch = R.demo_batch(cfg, batch=2, seq=32, kind="train")
    _close(M.model_forward(port, _batch(batch), cfg),
           R.model_forward(ref, batch, cfg), f"{name} forward")
    np.testing.assert_allclose(float(M.loss_fn(port, _batch(batch), cfg)),
                               float(R.loss_fn(ref, batch, cfg)), **TOL)

    # prefill 16, then 8 decode steps at pos 16..23 against max_seq 20
    pb = R.demo_batch(cfg, batch=2, seq=16, kind="prefill", seed=1)
    want, wcache = R.serve_prefill(ref, pb, cfg, max_seq=20)
    got, gcache = M.serve_prefill(port, _batch(pb), cfg, max_seq=20)
    _close(got, want, f"{name} prefill")
    _close_tree(gcache, wcache, f"{name} prefill cache")
    tok = jnp.argmax(want, axis=-1)[:, None].astype(jnp.int32)
    assert torch.equal(torch.argmax(got, -1)[:, None],
                       torch.from_numpy(np.asarray(tok, np.int64)))
    for step in range(8):
        want, wcache = R.serve_decode(ref, wcache, {"token": tok}, cfg)
        got, gcache = M.serve_decode(port, gcache,
                                     {"token": torch.from_numpy(np.array(tok))},
                                     cfg)
        _close(got, want, f"{name} decode step {step}")
        tok = jnp.argmax(want, axis=-1)[:, None].astype(jnp.int32)
        assert np.array_equal(torch.argmax(got, -1).numpy(), np.asarray(tok)[:, 0])
    assert int(gcache["pos"]) == int(wcache["pos"]) == 24
    _close_tree(gcache, wcache, f"{name} cache after decode")


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_longer_than_max_seq(pairs, name):
    """S = 16 > max_seq = 12: every attention sublayer keeps the last 12
    positions rolled into slot order; then two decode steps."""
    cfg, ref, port = pairs(name)
    pb = R.demo_batch(cfg, batch=2, seq=16, kind="prefill", seed=2)
    want, wcache = R.serve_prefill(ref, pb, cfg, max_seq=12)
    got, gcache = M.serve_prefill(port, _batch(pb), cfg, max_seq=12)
    _close(got, want, f"{name} prefill")
    _close_tree(gcache, wcache, f"{name} ring cache")
    for step in range(2):
        tok = jnp.argmax(want, axis=-1)[:, None].astype(jnp.int32)
        want, wcache = R.serve_decode(ref, wcache, {"token": tok}, cfg)
        got, gcache = M.serve_decode(port, gcache,
                                     {"token": torch.from_numpy(np.array(tok))},
                                     cfg)
        _close(got, want, f"{name} decode step {step}")


@pytest.mark.parametrize("name", ARCHS)
def test_decode_writes_the_cache_in_place(pairs, name):
    """A decode step updates the stacked cache leaves it was given, and
    gives what the same step gives on a copy of that cache."""
    cfg, _, port = pairs(name)
    pb = R.demo_batch(cfg, batch=2, seq=8, kind="prefill", seed=5)
    _, cache = M.serve_prefill(port, _batch(pb), cfg, max_seq=12)
    copy = jax.tree_util.tree_map(torch.clone, cache)
    tok = _batch(R.demo_batch(cfg, batch=2, seq=1, kind="decode", seed=6))
    got, out = M.serve_decode(port, cache, tok, cfg)
    want, out_copy = M.serve_decode(port, copy, tok, cfg)
    assert torch.equal(got, want)
    leaves, copied = dict(_leaves(out["blocks"])), dict(_leaves(out_copy["blocks"]))
    for k, leaf in _leaves(cache["blocks"]):
        assert leaves[k] is leaf, k
        assert torch.equal(leaf, copied[k]), k
    assert int(out["pos"]) == int(cache["pos"]) + 1 == 9


@pytest.mark.parametrize("name", ["yi-9b", "jamba-1.5-large-398b"])
def test_converted_caches_decode_alike(pairs, name):
    """A reference cache converted with ``cache_from_reference`` decodes to
    the reference's logits."""
    cfg, ref, port = pairs(name)
    pb = R.demo_batch(cfg, batch=2, seq=8, kind="prefill", seed=3)
    _, wcache = R.serve_prefill(ref, pb, cfg, max_seq=16)
    gcache = cache_from_reference(_np_tree(wcache), device="cpu")
    tok = R.demo_batch(cfg, batch=2, seq=1, kind="decode", seed=4)["token"]
    want, _ = R.serve_decode(ref, wcache, {"token": tok}, cfg)
    got, _ = M.serve_decode(port, gcache, _batch({"token": tok}), cfg)
    _close(got, want, name)


# ----------------------------------------------------------------- configs
def test_registry_and_cells_match_the_reference():
    assert list(configs.REGISTRY) == list(ref_configs.REGISTRY)
    for name, cfg in configs.REGISTRY.items():
        ref = ref_configs.REGISTRY[name]
        assert asdict(cfg) == asdict(ref)
        assert asdict(cfg.smoke()) == asdict(ref.smoke())
        for attr in ("hd", "layers_per_block", "n_blocks", "is_attention_free",
                     "supports_long_decode", "has_decoder"):
            assert getattr(cfg, attr) == getattr(ref, attr), (name, attr)
        assert cfg.n_params() == ref.n_params()
        assert cfg.n_active_params() == ref.n_active_params()
    assert configs.runnable_cells() == ref_configs.runnable_cells()
    assert configs.skipped_cells() == ref_configs.skipped_cells()
    assert {k: asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: asdict(v) for k, v in ref_configs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch 'nope'"):
        configs.get_arch("nope")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["whisper-medium", "llama-3.2-vision-90b",
                                  "mamba2-780m"])
def test_demo_batch_is_the_reference_batch(name, kind):
    cfg = replace(configs.REGISTRY[name].smoke(), dtype="float32")
    want = R.demo_batch(cfg, 3, 7, kind=kind, seed=5)
    got = M.demo_batch(cfg, 3, 7, kind=kind, seed=5, device="cpu")
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == (torch.int32 if k in ("tokens", "targets", "token")
                                else torch.float32)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
