"""Decode against caches split along their sequence over ``data``
(``long_500k``'s batch of one), attended on a rank's own slice, against the
port's one-device run and the reference's mesh decode.

With a batch smaller than the data axes, ``cache_specs_tree`` splits a KV
cache's sequence over ``data`` where S divides and S >= 4 d, leaf by leaf.
Spawned gloo ranks (``tests/_torch_dist.py`` ``seq_cache_worker``) prefill
a batch of one 16-token row into 20 slots and decode 6 steps (across the
8-slot SWA ring's wrap and the full cache's clamp at slot 19, which lies
on the last data rank) at meshes (2, 1), (4, 1) and (2, 2), in fp32:

* jamba-1.5-large (a full cache split, the SSM state and conv replicated,
  MoE), h2o-danube-1.8b (its 8-slot ring split at d = 2, whole at d = 4),
  whisper-medium (the ``xk``/``xv`` cross caches split too), gemma2-2b
  (at d = 4 the 8-slot ring whole beside the 20-slot full cache split)
  and llama-3.2-vision (its 8 vision tokens' cross ``k``/``v`` split at
  d = 2, whole at d = 4);
* at (4, 1), a prefill of 4 tokens: at the first decode step three data
  ranks hold only masked slots;
* jamba and gemma2 in bf16 at (2, 1) and (4, 1), held to the port's
  one-device bf16 run by :func:`bf16_close` (one bf16 step an element, in
  at most 1 % of the elements), and ``attend_cache`` alone in bf16 at 2
  and 4 ranks (``attend_split_worker``, all-masked ranks included), held
  to its whole-cache run the same way: the split softmax rounds its
  probabilities to bf16 and its PV sum once, as one device does.

In fp32, every rank's logits of each step, and the cache gathered after
the steps, equal the port's one-device run on the same weights within 1e-4 of the
largest value; the logits equal the reference's jitted ``make_decode_step``
under ``use_mesh`` on 4 forced host devices (its cache placed by its own
``cache_specs_tree``, the same weights converted) within 1e-4, up to the
full cache's clamp, and its one-device decode at every step. Each decode
step issues no all-gather over ``data`` and exactly 3 all-reduces over
``data`` for every attention sublayer, self or cross, whose cache is split
(:func:`split_of`, the rule as a function of the config, asserted against
the placements), and a rank's split leaves keep S/d slots.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from _torch_dist import (SEQ_MAX, SEQ_STEPS, attend_split_worker, load_reference_params,
                         run_ranks, seq_cache_worker, smoke_cfg)
from repro_torch.models.model import build_params, demo_batch, serve_decode, serve_prefill
from repro_torch.models.transformer import block_plan
from repro_torch.tree import leaves_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 1e-4
ARCHS = {"jamba": "jamba-1.5-large-398b", "h2o-danube": "h2o-danube-1.8b",
         "whisper": "whisper-medium", "gemma2": "gemma2-2b",
         "vision": "llama-3.2-vision-90b"}
#: case -> (arch key, (data, model), prompt tokens)
CASES = {f"{a}-{d}x{m}": (a, (d, m), 16) for a in ARCHS for d, m in ((2, 1), (4, 1), (2, 2))}
CASES.update({"jamba-p4-4x1": ("jamba", (4, 1), 4), "gemma2-p4-4x1": ("gemma2", (4, 1), 4)})
#: the same in bf16, held to the port's one-device bf16 run (``BF16_BOUND``)
BF16_CASES = {f"{a}-bf16-{d}x1": (a, (d, 1), 16) for a in ("jamba", "gemma2") for d in (2, 4)}
#: one bf16 step relative to a value, and the share of elements that may
#: differ by one (:func:`bf16_close`)
BF16_STEP, BF16_SHARE = 2.0 ** -7, 0.01
#: attention alone in bf16: world -> [(case, S, pos)], the slots past pos masked
#: (at world 4 and pos 10, ranks 1-3 hold only masked slots)
ATTEND_CASES = {w: [("s64", 64, 63), ("s64-p40", 64, 40), ("s64-p10", 64, 10),
                    ("s16", 16, 15)] for w in (2, 4)}


def case_cfg(name: str):
    key = {**CASES, **BF16_CASES}[name][0]
    cfg = smoke_cfg(ARCHS[key], 512)
    return replace(cfg, dtype="bfloat16") if name in BF16_CASES else cfg


def split_of(cfg, d: int) -> dict:
    """``{sublayer: {leaf names}}`` of the KV cache leaves that a batch of
    one splits over ``d`` data ranks: the reference's rule, S % d == 0 and
    S >= 4 d, of each leaf's own length."""
    out: dict = {}

    def rule(key, names, S):
        if d > 1 and S % d == 0 and S >= 4 * d:
            out.setdefault(key, set()).update(names)

    for i, sub in enumerate(block_plan(cfg)):
        if sub.kind == "ssm":
            continue
        if sub.kind == "cross":
            rule(f"l{i}", {"k", "v"}, max(1, cfg.n_vision_tokens))
            continue
        rule(f"l{i}", {"k", "v"}, min(sub.window, SEQ_MAX) if sub.window else SEQ_MAX)
        if sub.kind == "attn_cross":
            rule(f"l{i}", {"xk", "xv"}, max(1, cfg.enc_seq))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's jitted prefill and decode steps of every case on its
    mesh of the first d x m of 4 forced host devices (the cache placed by
    its ``cache_specs_tree`` for a batch of one, kept so between steps),
    the same steps on one device, and each architecture's parameters (seed
    0) saved by path: ({arch key: npz path}, {case: [[logits of each mesh
    decode step], [logits of each one-device step]]})."""
    root = tmp_path_factory.mktemp("ref-seq")
    code = f"""
import json
from dataclasses import replace
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import REGISTRY
from repro.distributed.sharding import (batch_specs, cache_specs_tree, param_shardings,
                                        replicated, use_mesh)
from repro.models.config import ShapeConfig
from repro.models.model import build_params, demo_batch
from repro.train.train_step import make_decode_step, make_prefill_step
archs = {ARCHS!r}
npz, out = {{}}, {{}}
params = {{}}
for key, arch in archs.items():
    cfg = replace(REGISTRY[arch].smoke(), dtype="float32", vocab_size=512)
    params[key] = (cfg, build_params(cfg, seed=0))
    flat = {{"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params[key][1])}}
    npz[key] = {str(root)!r} + "/" + key + ".npz"
    np.savez(npz[key], **flat)
one = {{}}
for name, (key, shape, prompt) in {CASES!r}.items():
    cfg, p = params[key]
    if (key, prompt) not in one:  # the reference on one device
        _, cache = jax.jit(make_prefill_step(cfg, max_seq={SEQ_MAX}))(
            p, demo_batch(cfg, 1, prompt, kind="prefill", seed=1))
        step, one[key, prompt] = jax.jit(make_decode_step(cfg)), []
        for i in range({SEQ_STEPS}):
            logits, cache = step(p, cache, demo_batch(cfg, 1, 1, kind="decode", seed=2 + i))
            one[key, prompt].append(np.asarray(logits).tolist())
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
    batch = demo_batch(cfg, 1, prompt, kind="prefill", seed=1)
    with use_mesh(mesh):
        p_sh = param_shardings(p, mesh, cfg)
        _, cache = jax.jit(make_prefill_step(cfg, max_seq={SEQ_MAX}),
                           in_shardings=(p_sh, batch_specs(batch, mesh)))(p, batch)
        c_sh = cache_specs_tree(cache, mesh, cfg, ShapeConfig("seq", {SEQ_MAX}, 1, "decode"))
        cache = jax.device_put(cache, c_sh)
        tok = demo_batch(cfg, 1, 1, kind="decode", seed=2)
        step = jax.jit(make_decode_step(cfg), in_shardings=(p_sh, c_sh, batch_specs(tok, mesh)),
                       out_shardings=(replicated(mesh), c_sh))
        steps = []
        for i in range({SEQ_STEPS}):
            logits, cache = step(p, cache, demo_batch(cfg, 1, 1, kind="decode", seed=2 + i))
            steps.append(np.asarray(logits).tolist())
    out[name] = [steps, one[key, prompt]]
print(json.dumps([npz, out]))
"""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    npz, raw = json.loads(proc.stdout.strip().splitlines()[-1])
    return npz, {k: [[torch.from_numpy(np.asarray(s, np.float32)) for s in run]
                     for run in v] for k, v in raw.items()}


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    """Every case on its gloo ranks (the (2, 1) cases on two, the others on
    four), the fp32 ones on the reference's weights, the bf16 ones on the
    port's of seed 0: {case: (out dir, ranks)}."""
    npz, _ = reference
    tmp = tmp_path_factory.mktemp("seq-ranks")
    out = {}
    for world in (2, 4):
        jobs = [(name, case_cfg(name), shape, prompt, npz[key] if name in CASES else None)
                for name, (key, shape, prompt) in {**CASES, **BF16_CASES}.items()
                if shape[0] * shape[1] == world]
        where = run_ranks(world, seq_cache_worker, (jobs,), tmp)
        out.update({job[0]: (where, world) for job in jobs})
    return out


@pytest.fixture(scope="module")
def one_device(reference):
    """The port's one-device run of every case on the same weights: the
    prefill's logits, each decode step's and the cache after them."""
    npz, _ = reference
    out = {}
    for name, (key, _, prompt) in {**CASES, **BF16_CASES}.items():
        cfg = case_cfg(name)
        params = (load_reference_params(npz[key]) if name in CASES
                  else build_params(cfg, seed=0, device="cpu"))
        logits, cache = serve_prefill(
            params, demo_batch(cfg, 1, prompt, kind="prefill", seed=1, device="cpu"), cfg,
            max_seq=SEQ_MAX)
        steps = []
        for i in range(SEQ_STEPS):
            lg, cache = serve_decode(params, cache, demo_batch(cfg, 1, 1, kind="decode",
                                                               seed=2 + i, device="cpu"), cfg)
            steps.append(lg)
        out[name] = (logits, steps, cache)
    return out


@pytest.fixture(scope="module")
def attend_runs(tmp_path_factory):
    """``ATTEND_CASES`` on their gloo ranks: {world: out dir}."""
    tmp = tmp_path_factory.mktemp("attend-ranks")
    return {w: run_ranks(w, attend_split_worker, (cases,), tmp)
            for w, cases in ATTEND_CASES.items()}


def close(got, want, what):
    bound = BOUND * max(float(want.float().abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max())
    assert got.shape == want.shape and err <= bound, (what, err, bound)


def bf16_close(got, want, what):
    """``got`` and ``want`` are bf16 roundings of fp32 values that differ
    only in the order of fp32 sums (the softmax's denominator and the PV
    product summed over ``data``), about S 2**-24 relative: an element may
    land one bf16 step (at most 2**-7 of its value) away, and only where its
    fp32 value lies that close to a rounding boundary, about S 2**-24 /
    2**-8 of the elements (0.1 % at S = 64). Allowed: one step each, in at
    most ``BF16_SHARE`` of the elements. A probability or PV partial rounded
    where the one-device softmax does not round it moves about half."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, what
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= BF16_STEP * want.float().abs()).all()), (what, float(diff.max()))
    share = float((diff > 0).float().mean())
    assert share <= BF16_SHARE, (what, share)


def _rank(runs, name, r):
    where, _ = runs[name]
    return torch.load(os.path.join(where, f"{name}-rank{r}.pt"), weights_only=False)


@pytest.mark.parametrize("name", list(CASES))
def test_seq_split_decode_is_the_one_device_run(name, runs, one_device):
    logits, steps, cache = one_device[name]
    for r in range(runs[name][1]):
        got = _rank(runs, name, r)
        close(got["logits"], logits, f"{name} rank {r} prefill")
        for i, (a, b) in enumerate(zip(got["steps"], steps, strict=True)):
            close(a, b, f"{name} rank {r} decode step {i + 1}")
    whole = torch.load(os.path.join(runs[name][0], f"{name}-cache.pt"), weights_only=False)
    want = dict(leaves_with_paths(cache))
    assert set(dict(leaves_with_paths(whole))) == set(want)
    for path, t in leaves_with_paths(whole):
        close(t, want[path], f"{name} cache {path}")


@pytest.mark.parametrize("name", list(CASES))
def test_seq_split_decode_is_the_references(name, runs, reference):
    """Every step against the reference's one-device decode, and against
    its mesh decode up to the full cache's clamp: at pos >= S the
    reference's mesh decode leaves a sequence-split cache unwritten where
    its one-device decode (and the port) overwrite slot S - 1 (ROADMAP
    Queue 3), so there it is held to the one-device run only."""
    key, _, prompt = CASES[name]
    mesh_steps, one_steps = reference[1][name]
    full = any(sub.kind != "ssm" and sub.window is None
               for sub in block_plan(smoke_cfg(ARCHS[key], 512)))
    for r in range(runs[name][1]):
        steps = _rank(runs, name, r)["steps"]
        for i, (a, b, c) in enumerate(zip(steps, mesh_steps, one_steps, strict=True)):
            close(a, c, f"{name} rank {r} decode step {i + 1} vs the reference on one device")
            if prompt + i < SEQ_MAX or not full:
                close(a, b, f"{name} rank {r} decode step {i + 1} vs the reference's mesh")


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_seq_split_decode_in_bf16_is_the_one_device_run(name, runs, one_device):
    """In bf16, the split softmax rounds as the one-device softmax does:
    the probabilities to bf16, the PV product summed in fp32 over ``data``
    and rounded once (:func:`bf16_close`)."""
    logits, steps, cache = one_device[name]
    for r in range(runs[name][1]):
        got = _rank(runs, name, r)
        bf16_close(got["logits"], logits, f"{name} rank {r} prefill")
        for i, (a, b) in enumerate(zip(got["steps"], steps, strict=True)):
            bf16_close(a, b, f"{name} rank {r} decode step {i + 1}")
    whole = dict(leaves_with_paths(
        torch.load(os.path.join(runs[name][0], f"{name}-cache.pt"), weights_only=False)))
    for path, t in leaves_with_paths(cache):
        if t.dtype == torch.bfloat16:
            bf16_close(whole[path], t, f"{name} cache {path}")
        else:
            assert torch.equal(whole[path], t), (name, path)


@pytest.mark.parametrize("world,case", [(w, c[0]) for w, cs in ATTEND_CASES.items()
                                        for c in cs])
def test_split_attention_in_bf16_rounds_as_one_device(world, case, attend_runs):
    for r in range(world):
        got = torch.load(os.path.join(attend_runs[world], f"{case}-rank{r}.pt"))
        bf16_close(got["split"], got["whole"], f"{case} at {world} ranks, rank {r}")


@pytest.mark.parametrize("name", list(CASES) + list(BF16_CASES))
def test_seq_split_decode_collectives(name, runs):
    key, (d, m), prompt = {**CASES, **BF16_CASES}[name]
    cfg = case_cfg(name)
    split = split_of(cfg, d)
    # the rule's cases the configs were chosen for
    if key == "h2o-danube":
        assert bool(split) == (d == 2)
    if key == "gemma2":
        assert set(split) == ({"l0", "l1"} if d == 2 else {"l1"})
    if key == "whisper":
        assert split == {"l0": {"k", "v", "xk", "xv"}}
    if key == "vision":  # the 8 vision tokens' k/v split at d = 2 only
        assert ("l0" in split) == (d == 2) and set(split) >= {"l1", "l2", "l3", "l4"}
    if not (key == "h2o-danube" and d == 4):
        assert split, name
    # each attention sublayer's split caches: self ("k") and cross ("xk")
    sublayers = sum(("k" in names) + ("xk" in names) for names in split.values())
    for r in range(d * m):
        got = _rank(runs, name, r)
        assert got["split"] == split, (name, r, got["split"])
        for path, shape in got["local"].items():
            sub, leaf = path.split("/")[1:] if path.startswith("blocks/") else (None, None)
            if leaf in split.get(sub, ()):
                S = shape[2] * d
                assert S % d == 0 and S >= 4 * d and shape[2] == S // d, (name, path, shape)
        for i, c in enumerate(got["counts"]):
            calls = c["calls"]
            assert ("data", "all-gather") not in calls, (name, r, i, calls)
            assert calls.get(("data", "all-reduce"), 0) == 3 * cfg.n_blocks * sublayers, \
                (name, r, i, calls)
            assert not any(a == "data" for a, _ in c["gathered"]), (name, r, i)
    if prompt < SEQ_MAX // d:  # the first step's slot lies on rank 0: the others are
        assert d == 4 and split  # past it, every slot of theirs masked


def test_split_rule_is_the_references():
    """``split_of`` is the placements the port's ``cache_specs_tree`` gives
    a batch of one (the reference's rule, copied)."""
    from repro_torch.distributed.sharding import cache_specs_tree
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import abstract_cache

    for key, arch in ARCHS.items():
        cfg = smoke_cfg(arch, 512)
        for d in (1, 2, 4):
            specs = cache_specs_tree(abstract_cache(cfg, 1, SEQ_MAX), {"data": d, "model": 2},
                                     cfg, ShapeConfig("seq", SEQ_MAX, 1, "decode"))
            got: dict = {}
            for path, s in leaves_with_paths(specs["blocks"]):
                sub, leaf = path.split("/")
                if len(s.spec) == 5 and s.spec[2] == "data" and d > 1:
                    got.setdefault(sub, set()).add(leaf)
            assert got == split_of(cfg, d), (key, d, got)
