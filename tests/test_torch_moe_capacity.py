"""The MoE capacity split over ``data`` (``layers._capacity_group``), with
and without a ``pod`` axis, on spawned gloo ranks (``tests/_torch_dist.py``).

``layers.moe`` alone, on a (data 2, model 2) mesh of four ranks and a (pod
2, data 2, model 2) mesh of eight, each rank on its share of the batch rows
and its hidden columns of every expert (3 experts, or 5 at top-3: neither
divides over ``model``), held to the one-device ``moe`` of each column
block summed (what the ``model`` reduce sums), on the same inputs made
from a seed with numpy:

* its experts' flops (by leaf, forward and the input gradients) are 1/d
  of the column block's: it runs C/d slots. Over ``data`` it issues the
  routing's all-gather, the rows' all-gather (D + K columns, the gates
  beside the rows, in x's dtype) and the fp32 partials' reduce-scatter
  forward, and backward the partials' gradient all-gathered in x's dtype
  and the rows' gradients reduce-scattered: nothing else, so no (E, C, D)
  buffer (an all-to-all of the dense buffers moved El C D a rank);
* in fp32 its output, its x share's gradient and the sum over the data
  ranks of each parameter shard's gradient equal the one-device ones
  within 1e-5 of each one's largest value, in both of the reference's
  dispatch forms (a payload scatter below 4,096 tokens, an index gather
  from 4,096);
* in bf16 at top-2 its output equals the one-device one element for
  element (a token's two weighted outputs are summed in fp32 and rounded
  once, as the one-device sum over K does; the other ranks' terms are
  exact zeros), and at top-3 within :func:`bf16_close`: three fp32 terms
  summed in another order may land one bf16 step away, where partial
  sums rounded to bf16 before the exchange round twice. Its gradients in
  bf16 are within :data:`BF16_GRAD` of the largest value (:func:`near`),
  not element for element: a parameter shard's gradient is rounded on
  each data rank over its own slots before the sum over data, where the
  one-device call rounds once over all of them, and x's gradient adds the
  router's and the experts' terms of the ``model`` ranks in another order.

And mixtral with 3 experts whole, in bf16 on the (2, 2) ranks, against the
port's one-device bf16 run (:func:`test_bf16_capacity_split_steps`).
"""

import math
import os
from dataclasses import replace

import pytest
import torch

from _torch_dist import (BATCH, DECODE_STEPS, SEQ, WeightFlops, batches, bf16_serve_worker,
                         model_columns, moe_case, moe_layer_worker, run_ranks, smoke_cfg)
from repro_torch.models import layers
from repro_torch.models.model import (build_params, demo_batch, loss_fn, serve_decode,
                                     serve_prefill)
from repro_torch.tree import leaves_with_paths

BOUND = 1e-5
BF16_STEP, BF16_SHARE = 2.0 ** -7, 0.01
#: bf16 gradients against the one-device ones, of the largest value
#: (measured: at most 0.0072, 0.92 of a step, x's in the index form)
BF16_GRAD = 2 * BF16_STEP
#: name -> (mesh, dtype, experts, top_k, batch, seq)
CASES = {
    "2x2-fp32-payload": ((2, 2), "float32", 3, 2, 4, 16),
    "2x2-fp32-index": ((2, 2), "float32", 3, 2, 4, 1024),
    "2x2-bf16-payload": ((2, 2), "bfloat16", 3, 2, 4, 16),
    "2x2-bf16-index": ((2, 2), "bfloat16", 3, 2, 4, 1024),
    "2x2-bf16-top3": ((2, 2), "bfloat16", 5, 3, 4, 16),
    "2x2x2-fp32-payload": ((2, 2, 2), "float32", 3, 2, 4, 16),
    "2x2x2-fp32-index": ((2, 2, 2), "float32", 3, 2, 4, 1024),
    "2x2x2-bf16-payload": ((2, 2, 2), "bfloat16", 3, 2, 4, 16),
    "2x2x2-bf16-top3": ((2, 2, 2), "bfloat16", 5, 3, 4, 16),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case_cfg(name: str):
    _, dtype, E, K, _, _ = CASES[name]
    return replace(smoke_cfg("mixtral-8x22b", 512, n_experts=E, top_k=K), dtype=dtype)


def capacity(cfg, tokens: int) -> int:
    c = math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, min(c, tokens))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's ranks, the cases of a world in one spawn: {name: [the
    ranks' results]}."""
    root = tmp_path_factory.mktemp("moe-cap")
    out = {}
    for world in (4, 8):
        jobs = [(name, shape, case_cfg(name), B, S, 7) for name, (shape, _, _, _, B, S)
                in CASES.items() if math.prod(shape) == world]
        where = run_ranks(world, moe_layer_worker, (jobs,), root)
        for name, *_ in jobs:
            out[name] = [torch.load(os.path.join(where, f"{name}-rank{r}.pt"),
                                    weights_only=False) for r in range(world)]
    return out


def one_device(name: str) -> dict:
    """The one-device ``moe`` of each model rank's column block, summed in
    the activation dtype as the ``model`` reduce sums it, and its gradients
    (each column block's parameter gradient apart)."""
    shape, _, _, _, B, S = CASES[name]
    cfg = case_cfg(name)
    case = moe_case(cfg, B, S, 7)
    m = shape[-1]
    x = case["x"].clone().requires_grad_()
    parts = [{k: t.clone().requires_grad_() for k, t in
              model_columns(case["params"], j, m).items()} for j in range(m)]
    weights = {t.untyped_storage().data_ptr(): (j, k)
               for j, p in enumerate(parts) for k, t in p.items()}
    with WeightFlops(weights) as wf:
        outs = [layers.moe(p, x, cfg) for p in parts]
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        (out.float() * case["probe"]).sum().backward()
    return {"out": out.detach(), "x_grad": x.grad,
            "grads": [{k: t.grad for k, t in p.items()} for p in parts],
            "flops": wf.flops, "cfg": cfg}


def close(got, want, what):
    bound = BOUND * max(float(want.float().abs().max()), 1e-30)
    err = float((got.double() - want.double()).abs().max())
    assert got.shape == want.shape and err <= bound, (what, err, bound)


def bf16_close(got, want, what):
    """One bf16 step (2**-7 of the value) an element, in at most
    ``BF16_SHARE`` of the elements: both sides round fp32 sums of the same
    terms taken in other orders."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, what
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= BF16_STEP * want.float().abs()).all()), (what, float(diff.max()))
    share = float((diff > 0).float().mean())
    assert share <= BF16_SHARE, (what, share)


def near(got, want, what) -> float:
    """Within ``BF16_GRAD`` of the largest value: bf16 values rounded from
    sums of the same terms in other groupings. Returns the error, of the
    largest value."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert got.shape == want.shape and err <= BF16_GRAD * scale, (what, err, scale)
    return err / scale


@pytest.mark.parametrize("name", list(CASES))
def test_moe_capacity_split_on_a_ranks_slots(ranks, name):
    shape, dtype, E, K, B, S = CASES[name]
    got = ranks[name]
    want = one_device(name)
    cfg = want["cfg"]
    pod, d, m = shape if len(shape) == 3 else (1, *shape)
    C = capacity(cfg, B * S)
    assert E % m and C % d == 0, name
    assert (B * S >= 4096) == name.endswith("-index")
    rows = B // (pod * d)
    D, T, size = cfg.d_model, rows * S, torch.finfo(getattr(torch, dtype)).bits // 8
    exchange = [("all-gather", d * T * K * 8),            # the routing (int64)
                ("all-gather", d * T * (D + K) * size),   # the rows and gates
                ("reduce-scatter", T * D * 4),            # the fp32 partials
                ("all-gather", d * T * D * size),         # their gradient
                ("reduce-scatter", T * (D + K) * size)]   # the rows' gradients
    worst = {}
    for r, g in enumerate(got):
        tag = f"{name} rank {r}"
        # the signature: the rank's C/d slots, and the exchange over data
        for k in ("w_gate", "w_up", "w_down"):
            assert g["flops"][k] * d == want["flops"][g["model"], k], (tag, k, g["flops"])
        assert [(k, n) for a, k, n in g["log"] if a == "data"] == exchange, (tag, g["log"])
        share = slice(g["share"] * rows, (g["share"] + 1) * rows)
        if dtype == "float32":
            close(g["out"], want["out"][share], f"{tag} output")
            close(g["x_grad"], want["x_grad"][share], f"{tag} x gradient")
            continue
        if K == 2:
            assert torch.equal(g["out"], want["out"][share]), \
                (tag, float((g["out"].float() - want["out"][share].float()).abs().max()))
        else:
            bf16_close(g["out"], want["out"][share], f"{tag} output")
        worst["x"] = max(worst.get("x", 0.0),
                         near(g["x_grad"], want["x_grad"][share], f"{tag} x gradient"))
    # each shard's gradient summed over the data ranks
    router = sum(w["router"] for w in want["grads"])  # every column block's
    for j in range(m):
        for k in want["grads"][j]:
            total = sum(g["grads"][k].float() for g in got if g["model"] == j)
            ref = router if k == "router" else want["grads"][j][k]
            if dtype == "float32":
                close(total, ref, f"{name} model rank {j} {k} gradient")
            else:
                worst[k] = max(worst.get(k, 0.0), near(total, ref.float(),
                                                       f"{name} model rank {j} {k} gradient"))
    if worst:
        print(name, "bf16 gradients' worst error of the largest value:", worst)


def test_bf16_capacity_split_steps(tmp_path):
    """mixtral with 3 experts in bf16 on (2, 2) ranks against the port's
    one-device bf16 run: the prefill and decode logits and the cache within
    four bf16 steps (2**-7 each) of the largest value, and the loss within
    1e-3 of its value. Not element for element: the ``model`` split rounds
    each rank's partial sums of the row-parallel matmuls (attention's
    ``wo``, the experts' ``w_down``) to bf16 before the all-reduce over
    ``model`` sums them (measured: 0.87 % prefill, 1.43 % decode, 0.80 %
    cache, 1.4e-4 loss); the capacity exchange itself adds no rounding at
    top-2 (:func:`test_moe_capacity_split_on_a_ranks_slots`)."""
    cfg = replace(smoke_cfg("mixtral-8x22b", 512, n_experts=3), dtype="bfloat16")
    out = run_ranks(4, bf16_serve_worker, (cfg, (2, 2)), tmp_path)

    params = build_params(cfg, seed=0, device="cpu")
    batch = demo_batch(cfg, BATCH, SEQ, kind="prefill", seed=1, device="cpu")
    with torch.no_grad():
        logits, cache = serve_prefill(params, batch, cfg, max_seq=SEQ + DECODE_STEPS)
        steps = []
        for i in range(DECODE_STEPS):
            token = demo_batch(cfg, BATCH, 1, kind="decode", seed=2 + i, device="cpu")
            d_logits, cache = serve_decode(params, cache, token, cfg)
            steps.append(d_logits)
        loss = float(loss_fn(params, batches(cfg, 1)[0], cfg))
    rows = BATCH // 2
    report = {}

    def rel(a, b, what):
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        report[what] = max(report.get(what, 0.0), err)
        return err

    for r in range(4):
        got = torch.load(os.path.join(out, f"bf16-rank{r}.pt"), weights_only=False)
        i = got["dp_index"]
        rel(got["logits"], logits[i * rows:(i + 1) * rows], "prefill")
    got = torch.load(os.path.join(out, "bf16.pt"), weights_only=False)
    for a, b in zip(got["steps"], steps):
        rel(a, b, "decode")
    for (p, a), (_, b) in zip(leaves_with_paths(got["cache"]), leaves_with_paths(cache)):
        if a.is_floating_point():
            rel(a, b, "cache")
        else:
            assert torch.equal(a, b), p
    report["loss"] = abs(got["loss"] - loss) / abs(loss)
    print(report)
    assert max(report["prefill"], report["decode"], report["cache"]) <= 4 * BF16_STEP, report
    assert report["loss"] <= 1e-3, report
