"""FSDP in the port's mesh steps (``repro_torch.train.mesh_step``): each
block's FSDP shards gathered over ``data`` where the block runs, against
the port's one-device steps, on spawned gloo ranks
(``tests/_torch_dist.py``).

Two smoke configs are widened until their block leaves reach the FSDP
threshold of 2^20 entries (``sharding._extend_fsdp``): yi-9b's (d_model
256, d_ff 4,096, 2 KV heads, 2 blocks: the MLP's three leaves are
FSDP-sharded, attention's are not) and jamba's, a hybrid (16 layers, so 2
blocks of 7 SSM layers and 1 attention layer; d_model 128, d_ff 1,024 and
8 experts in an MoE layer a block, the attention layer's: the experts'
leaves are FSDP-sharded, the MLPs' are not).

* Training at (2, 2) and (4, 1) with ``fsdp=True``, remat on and off, 1
  and 2 microbatches, and a batch of 3 rows that does not divide over
  ``data`` at (2, 2) (every rank computes the whole batch): the losses,
  and every rank's shard of the parameters and both moments after each of
  two steps, equal the one-device run's within 1e-4 of each leaf's largest
  value (the bound of ``tests/test_torch_mesh_train.py``), a parameter's
  beyond Adam's allowance for a gradient change of 1e-4 of the leaf's
  largest gradient (the bound ``chip_smoke.py`` holds the mesh ranks on the
  card to: where a gradient entry nearly cancels, the step m/(sqrt(v) +
  eps) follows its last digits, which the mesh's order of sums sets
  apart; the moments get no allowance). The first step's all-gathers over
  ``data`` whose result is an FSDP block leaf's block (its ``model``
  shard) are FSDP block leaves x blocks x microbatches, twice with remat
  (the forward pass and the recompute); for yi-9b, whose step issues no
  other all-gather over ``data``, that is all of them
  (``CollectiveCounter.by_group``). Their gradients are reduce-scattered
  over ``data`` once a block a microbatch where the batch was split, and
  not at all where it was not (every rank computed it whole: its slice).
* The mesh prefill of a (4, 16) batch and 4 decode steps against its own
  cache, at (2, 2) and (4, 1): the logits within 1e-4 of the largest of
  the one-device run's (each rank its data share's rows in prefill) with
  equal greedy ids, and each call's all-gathers over ``data`` of FSDP
  block leaves equal to FSDP block leaves x blocks (for yi-9b, all of
  them, and one more a decode step: its logits).

* q8 moments with FSDP at (2, 2) (yi-9b), where each rank updates the
  positions of its own q8 rows (``repro_torch.optim.q8_shard``), an FSDP
  leaf's gradient reaching them from the ranks' FSDP shards by an
  all-to-all over ``data`` and the step going back the same way: held as
  ``tests/test_torch_mesh_train.py`` holds its q8 run, step by step from
  the mesh run's own state (the update alone, against the whole-leaf
  update bit for bit, is ``tests/test_torch_q8_shard.py``).

* The gather's backward alone, on a bf16 leaf at (2, 2) and (4, 1): the
  shard's gradient is exactly the data ranks' gradients summed and
  divided in fp32 and rounded once to bf16 (at (4, 1) a sum in bf16
  would round otherwise, which the test checks its weights show), and
  where the batch did not split, the rank's own gradient's slice.

Each case asserts that some block leaf is FSDP-sharded, so none can pass
with no gather at all.
"""

import os

import pytest
import torch

from _torch_dist import (BATCH, DECODE_STEPS, SEQ, batches, fsdp_grad_worker,
                         fsdp_serve_worker, fsdp_train_worker, run_ranks, smoke_cfg,
                         train_worker)
from test_torch_mesh_train import assert_close_state, one_device, q8_step_allowance
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import make_abstract_state, state_shardings
from repro_torch.tree import leaves_with_paths, tree_map

BOUND = 1e-4
STEPS = 2
CONFIGS = {"yi-9b": {"d_model": 256, "d_ff": 4096, "n_kv_heads": 2},
           "jamba-1.5-large-398b": {"d_model": 128, "d_ff": 1024, "n_layers": 16,
                                    "n_experts": 8, "moe_every": 8}}
#: (name, (data, model), remat, microbatches, batch rows)
TRAIN = [("d2m2-remat", (2, 2), True, 1, BATCH),
         ("d2m2-noremat", (2, 2), False, 1, BATCH),
         ("d2m2-mb2", (2, 2), True, 2, BATCH),
         ("d2m2-unsplit", (2, 2), True, 1, 3),
         ("d4m1-remat", (4, 1), True, 1, BATCH),
         ("d4m1-noremat-mb2", (4, 1), False, 2, 2 * BATCH)]
MESHES = [(2, 2), (4, 1)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fsdp_blocks(cfg, mesh: tuple) -> list:
    """The shape of each FSDP block leaf's block as a rank gathers it over
    ``data`` at ``mesh`` (its ``model`` shard, the gathered dim first, as
    ``all_gather_into_tensor`` fills it); at least one such leaf exists."""
    sizes = {"data": mesh[0], "model": mesh[1]}
    abstract = make_abstract_state(cfg, AdamWConfig())
    sh = dict(leaves_with_paths(state_shardings(abstract, sizes, cfg, fsdp=True)["params"]))
    shapes = []
    for path, t in leaves_with_paths(abstract["params"]):
        spec = sh[path].spec
        if path.startswith("blocks/") and "data" in spec:
            whole = tuple(None if e == "data" else e for e in spec)
            block = NamedSharding(sizes, whole).local_shape(t.shape)[1:]
            d = spec.index("data") - 1
            shapes.append((block[d], *block[:d], *block[d + 1:]))
    assert shapes, f"no block leaf of {cfg.name} is FSDP-sharded at {mesh}"
    return shapes


def data_gathers(counts: dict, shapes) -> tuple[int, int]:
    """The all-gathers over ``data`` of a counted call: those whose result
    has one of ``shapes``, and all of them."""
    of = sum(1 for axis, s in counts["gathered"] if axis == "data" and s in shapes)
    return of, counts["calls"].get(("data", "all-gather"), 0)


def assert_close(got, want, what: str) -> None:
    bound = BOUND * max(float(want.float().abs().max()), 1e-30)
    err = float((got.double() - want.double()).abs().max())
    assert got.shape == want.shape and err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_fsdp_training_is_the_one_device_run(arch, tmp_path):
    cfg = smoke_cfg(arch, 512, **CONFIGS[arch])
    assert cfg.n_blocks == 2
    out = run_ranks(4, fsdp_train_worker, (cfg, TRAIN, BOUND), tmp_path)
    for name, mesh, remat, mb, rows in TRAIN:
        shapes = fsdp_blocks(cfg, mesh)
        for r in range(4):
            got = torch.load(os.path.join(out, f"{name}-rank{r}.pt"), weights_only=False)
            for a, b in zip(got["losses"], got["want"], strict=True):
                assert abs(a - b) <= BOUND * abs(b), (name, r, got["losses"], got["want"])
            for step, path, err, bound in got["diffs"]:
                assert err <= bound, f"{arch} {name} rank {r} step {step} {path}: " \
                    f"{err:.3e} > {bound:.3e}"
            if r == 0:
                want = len(shapes) * cfg.n_blocks * mb * (2 if remat else 1)
                fsdp, every = data_gathers(got["counted"], set(shapes))
                assert fsdp == want, (name, fsdp, want)
                if not cfg.n_experts:
                    assert every == want, (name, every, want)
                # a gradient every rank computed whole is sliced, not reduced
                split = rows // mb % mesh[0] == 0  # each microbatch's rows
                scatters = got["counted"]["calls"].get(("data", "reduce-scatter"), 0)
                assert scatters == (len(shapes) * cfg.n_blocks * mb if split else 0), \
                    (name, scatters)


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_fsdp_prefill_and_decode_are_the_one_device_steps(arch, tmp_path):
    from repro_torch.models.model import build_params, demo_batch, serve_decode, serve_prefill

    cfg = smoke_cfg(arch, 512, **CONFIGS[arch])
    jobs = [(f"d{d}m{m}", cfg, (d, m)) for d, m in MESHES]
    out = run_ranks(4, fsdp_serve_worker, (jobs,), tmp_path)
    params = build_params(cfg, seed=0, device="cpu")
    batch = demo_batch(cfg, BATCH, SEQ, kind="prefill", seed=1, device="cpu")
    with torch.no_grad():
        logits, cache = serve_prefill(params, batch, cfg, max_seq=SEQ + DECODE_STEPS)
        steps = []
        for i in range(DECODE_STEPS):
            token = demo_batch(cfg, BATCH, 1, kind="decode", seed=2 + i, device="cpu")
            d_logits, cache = serve_decode(params, cache, token, cfg)
            steps.append(d_logits)
    for name, _, (d, m) in jobs:
        shapes = fsdp_blocks(cfg, (d, m))
        rows = BATCH // d
        for r in range(4):
            got = torch.load(os.path.join(out, f"{name}-prefill-rank{r}.pt"))
            i = got["dp_index"]
            want = logits[i * rows:(i + 1) * rows]
            assert_close(got["logits"], want, f"{arch} {name} prefill rank {r}")
            assert torch.equal(got["logits"].argmax(-1), want.argmax(-1)), (name, r)
        got = torch.load(os.path.join(out, f"{name}-decode.pt"))
        for i, (a, b) in enumerate(zip(got["steps"], steps, strict=True)):
            assert_close(a, b, f"{arch} {name} decode {i + 1}")
            assert torch.equal(a.argmax(-1), b.argmax(-1)), (name, i)
        for c, counts in enumerate(got["counts"]):  # the prefill, then each decode step
            fsdp, every = data_gathers(counts, set(shapes))
            assert fsdp == len(shapes) * cfg.n_blocks, (name, c, fsdp)
            if not cfg.n_experts:  # a decode step gathers its logits over data too
                assert every == fsdp + (c > 0), (name, c, every)


def test_fsdp_with_q8_moments_is_the_one_device_run(tmp_path):
    cfg = smoke_cfg("yi-9b", 512, **CONFIGS["yi-9b"])
    fsdp_blocks(cfg, (2, 2))
    out = run_ranks(4, train_worker, (cfg, [("q8", (2, 2), True, True, True, STEPS, False)]),
                    tmp_path)
    got = torch.load(os.path.join(out, "q8.pt"), weights_only=False)
    losses, states = one_device(cfg, True, steps=[0])
    more = one_device(cfg, True, tree_map(torch.clone, got["states"][0]), steps=[1])
    losses, states = losses + more[0], states + more[1]
    allow = [None, q8_step_allowance(got["states"][0], batches(cfg, STEPS)[1], cfg)]
    for a, b in zip(got["losses"], losses, strict=True):
        assert abs(a - b) <= BOUND * abs(b), (got["losses"], losses)
    for i, (g, w) in enumerate(zip(got["states"], states)):
        assert_close_state(g["params"], w["params"], f"q8 step {i + 1} params", allow[i])
        assert_close_state(g["opt"], w["opt"], f"q8 step {i + 1} moments")


GRAD_JOBS = [("d2m2-bf16", (2, 2), torch.bfloat16, True),
             ("d4m1-bf16", (4, 1), torch.bfloat16, True),
             ("d2m2-unsplit-bf16", (2, 2), torch.bfloat16, False)]


def test_fsdp_gradient_is_reduced_in_fp32(tmp_path):
    out = run_ranks(4, fsdp_grad_worker, (GRAD_JOBS,), tmp_path)
    for name, (d, m), dtype, split in GRAD_JOBS:
        w = torch.load(os.path.join(out, f"{name}-w.pt"))
        for r in range(4):
            got = torch.load(os.path.join(out, f"{name}-rank{r}.pt"))
            assert got["gathered"], (name, r)
            peers = [q for q in range(4) if q % m == r % m]  # r's data group
            if split:
                want = (sum(w[q].to(dtype).float() for q in peers) / d).to(dtype)
            else:
                want = w[r].to(dtype)
            want = want.chunk(d, 1)[got["data"]]
            assert got["grad"].dtype == dtype and torch.equal(got["grad"], want), (name, r)
        if (d, dtype) == (4, torch.bfloat16):  # the weights tell the two sums apart
            in_dtype = w[0].to(dtype)
            for q in range(1, 4):
                in_dtype = in_dtype + w[q].to(dtype)
            assert not torch.equal((in_dtype / d).to(dtype),
                                   (sum(x.to(dtype).float() for x in w) / d).to(dtype))
