"""The port's dry-run (``repro_torch.launch.dryrun``) and roofline report
(``repro_torch.launch.roofline``).

* The collectives the dry-run counts for a smoke config's train step on a
  (2, 2) mesh, traced on ``meta`` tensors under torch's fake process group,
  equal what the same step issues on a real gloo (2, 2) run, kind by kind,
  in calls and bytes, counted by the same hook (qwen3-moe, so the MoE's
  routing gathers are in it; FSDP, and q8 moments).
* At (1, 4), where the step is tensor-parallel over ``model``, the
  dry-run's collectives equal a real gloo run's too, and its rank's flops
  are the one-device step's with the share that is split over ``model``
  divided by 4: for qwen3-moe (whole heads, experts, vocabulary-parallel
  head and embedding) everything but the router, whose matmuls (forward,
  remat's recompute and two in the backward, 2 T D E flops each) every
  rank computes whole; for a yi-9b of one KV head (the rank's query heads
  against the KV head built whole) and a gemma2-2b of 6 heads (the rank's
  quarter of the query sequence with every head) everything. At (2, 2)
  and at (pod 2, data 2, model 2), a mixtral of 3 experts (each expert's
  width over ``model``, its capacity slots over ``data``) counts alike
  too, call for call (axis, kind and bytes in the order issued): its
  capacity exchange over ``data`` is the pod's token rows all-gathered
  and the partial outputs reduce-scattered, and no collective over
  ``data`` carries an (E, C, D) buffer.
* The mesh prefill and decode steps the dry-run traces for prefill and
  decode cells give, on a real gloo (2, 2) run, the one-device logits and
  cache within 1e-4 of the largest value (the whole-model bound of
  ``tests/test_torch_model.py``): qwen3-moe (attention caches, MoE routed
  over the whole batch) with FSDP, and mamba2-780m (SSM states).
* A batch-1 decode of the jamba smoke config at a fake (4, 1) mesh, its
  attention cache split along its sequence over ``data``: the dry-run's
  collectives equal a real gloo (4, 1) run's decode step, kind by kind, in
  calls and bytes (3 all-reduces over ``data`` for the one attention
  sublayer), and neither gathers anything.
* A rank's peak live bytes (``peak_live_bytes``) of a yi-9b smoke config
  widened until its MLP leaves reach the FSDP threshold (d_model 256, d_ff
  4,096), traced with FSDP at a fake (4, 1) mesh: at least its argument
  bytes, and from 2 to 4 blocks the peak grows by the argument bytes'
  growth, the two more blocks' saved inputs (remat) and less than one
  block's gathered bytes more, where gathering the whole tree at the
  step's start would hold two more blocks' gathered bytes.
* A production cell (mamba2-780m ``decode_32k`` on the 16x16 mesh, 256
  fake ranks in this process) gives a whole record with the card's
  constants, which the port's ``roofline.load_records`` and ``fmt_row``
  read back from a directory the test gives; the reference's
  ``results/dryrun/`` is not touched.
"""

import math
import os

import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

from _torch_dist import (BATCH, SEQ, SEQ_MAX, run_ranks, seq_cache_worker, serve_worker,
                         smoke_cfg, train_worker)
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import abstract_params
from repro_torch.tree import leaves

CFG = smoke_cfg("qwen3-moe-30b-a3b", 16384)


def test_dryrun_collectives_are_a_real_runs(tmp_path):
    jobs = [("fsdp", (2, 2), True, False, True, 1, True),
            ("q8", (2, 2), True, True, False, 1, True)]
    out = run_ranks(4, train_worker, (CFG, jobs), tmp_path)
    for name, _, remat, q8, fsdp, _, _ in jobs:
        real = torch.load(os.path.join(out, f"{name}.pt"), weights_only=False)["counted"]
        traced = dryrun.trace_step(CFG, ShapeConfig("smoke", SEQ, BATCH, "train"), 4,
                                   lambda dt: make_host_mesh(2, 2, device_type=dt),
                                   fsdp=fsdp, quantized=q8, remat=remat)
        assert traced["collective_calls"] == real["calls"], name
        assert traced["collectives"] == real["bytes"], name
        assert traced["collective_bytes_total"] == sum(real["bytes"].values()) > 0
        assert {"all-gather", "reduce-scatter" if not q8 else "all-reduce"} <= set(real["bytes"])
        assert traced["flops"] > 0 and traced["op_bytes"] > traced["flops"] / 1e3


def test_dryrun_of_the_tensor_parallel_step(tmp_path):
    jobs = [("tp", (1, 4), True, False, False, 1, True)]
    out = run_ranks(4, train_worker, (CFG, jobs), tmp_path)
    real = torch.load(os.path.join(out, "tp.pt"), weights_only=False)["counted"]
    shape = ShapeConfig("smoke", SEQ, BATCH, "train")
    traced = {m: dryrun.trace_step(CFG, shape, m,
                                   lambda dt, m=m: make_host_mesh(1, m, device_type=dt))
              for m in (1, 4)}
    assert traced[4]["collective_calls"] == real["calls"]
    assert traced[4]["collectives"] == real["bytes"]
    assert real["calls"]["all-reduce"] > traced[1]["collective_calls"]["all-reduce"]
    router = CFG.n_blocks * 4 * 2 * (BATCH * SEQ) * CFG.d_model * CFG.n_experts
    assert traced[4]["flops"] == (traced[1]["flops"] - router) / 4 + router
    assert traced[4]["argument_size_in_bytes"] < traced[1]["argument_size_in_bytes"] / 2


@pytest.mark.parametrize("arch, changes, mesh", [
    ("yi-9b", {"n_kv_heads": 1}, (1, 4)),                     # the rank's query heads
    ("gemma2-2b", {"n_heads": 6, "n_kv_heads": 3}, (1, 4)),  # the rank's queries
    ("mixtral-8x22b", {"n_experts": 3}, (2, 2)),              # the rank's capacity slots
    ("mixtral-8x22b", {"n_experts": 3}, (2, 2, 2)),           # and beside a pod axis
], ids=["query-heads", "query-sequence", "capacity", "capacity-pod"])
def test_dryrun_of_work_on_a_ranks_share(arch, changes, mesh, tmp_path):
    cfg = smoke_cfg(arch, 512, **changes)
    pod, d, m = mesh if len(mesh) == 3 else (1, *mesh)
    H, K, E = cfg.n_heads, cfg.n_kv_heads, cfg.n_experts
    C = max(8, min(math.ceil(BATCH * SEQ * cfg.top_k / max(E, 1) * cfg.capacity_factor),
                   BATCH * SEQ))
    assert {"yi-9b": H % m == 0 and K % m, "gemma2-2b": H % m and SEQ % m == 0 and SEQ > m,
            "mixtral-8x22b": E % m and C % d == 0}[arch]
    jobs = [("tp", mesh, True, False, False, 1, True)]
    out = run_ranks(pod * d * m, train_worker, (cfg, jobs), tmp_path)
    real = torch.load(os.path.join(out, "tp.pt"), weights_only=False)["counted"]
    shape = ShapeConfig("smoke", SEQ, BATCH, "train")
    names = ("pod", "data", "model") if pod > 1 else ("data", "model")
    traced = {n: dryrun.trace_step(cfg, shape, pod * d * n,
                                   lambda dt, n=n: init_device_mesh(
                                       dt, (pod, d, n)[-len(names):], mesh_dim_names=names))
              for n in (1, m)}
    assert traced[m]["collective_calls"] == real["calls"]
    assert traced[m]["collectives"] == real["bytes"]
    assert traced[m]["collective_log"] == real["log"]  # call for call, axis and bytes
    if arch == "gemma2-2b":  # there and back, forward and backward, a layer
        assert real["calls"]["all-to-all"] >= 4 * cfg.n_layers
    if arch == "mixtral-8x22b":
        # the capacity's exchange over data, a MoE layer: the rows (and
        # gates) of the pod's d shares gathered in the forward and in
        # remat's recompute and reduce-scattered back in the backward; the
        # partial outputs reduce-scattered in the forward (the recompute
        # stops before them: nothing after them is saved), their gradients
        # gathered; and no collective over data carries an (E, C, D) buffer
        T, D = BATCH * SEQ // (pod * d), cfg.d_model
        on_data = [(k, n) for a, k, n in real["log"] if a == "data"]
        for kind, nbytes, per_layer in [("all-gather", d * T * (D + cfg.top_k) * 4, 2),
                                        ("reduce-scatter", T * (D + cfg.top_k) * 4, 1),
                                        ("reduce-scatter", T * D * 4, 1),
                                        ("all-gather", d * T * D * 4, 1)]:
            assert on_data.count((kind, nbytes)) == per_layer * cfg.n_layers, (kind, nbytes)
        assert not [n for _, n in on_data if n == E * C * D * 4], on_data
        assert "all-to-all" not in real["calls"]
    if d == 1:  # every weight is split over model, and so is attention's work
        assert traced[m]["flops"] * m == traced[1]["flops"]
    else:  # below 1/m of (d, 1)'s: the experts there run every slot
        assert traced[m]["flops"] * m < traced[1]["flops"]


def test_dryrun_of_a_sequence_split_decode(tmp_path):
    cfg = smoke_cfg("jamba-1.5-large-398b", 512)
    jobs = [("jamba", cfg, (4, 1), SEQ, None)]
    out = run_ranks(4, seq_cache_worker, (jobs,), tmp_path)
    real = torch.load(os.path.join(out, "jamba-rank0.pt"), weights_only=False)["counts"][0]
    traced = dryrun.trace_step(cfg, ShapeConfig("smoke", SEQ_MAX, 1, "decode"), 4,
                               lambda dt: make_host_mesh(4, 1, device_type=dt))
    assert traced["collective_calls"] == real["kinds"]
    assert traced["collectives"] == real["bytes"]
    # the softmax combined over data: 3 all-reduces for the block's attention
    assert real["calls"] == {("data", "all-reduce"): 3 * cfg.n_blocks}
    assert "all-gather" not in traced["collective_calls"]


def test_dryrun_peak_gathers_a_block_at_a_time():
    shape = ShapeConfig("smoke", SEQ, BATCH, "train")
    traced, block = {}, 0
    for n in (2, 4):
        cfg = smoke_cfg("yi-9b", 512, d_model=256, d_ff=4096, n_layers=n)
        traced[n] = dryrun.trace_step(cfg, shape, 4,
                                      lambda dt: make_host_mesh(4, 1, device_type=dt),
                                      fsdp=True)
        assert traced[n]["peak_live_bytes"] >= traced[n]["argument_size_in_bytes"] > 0
        block = sum(t[0].numel() * t.element_size()
                    for t in leaves(abstract_params(cfg)["blocks"]))
    inputs = 2 * (BATCH // 4) * SEQ * cfg.d_model * 4  # two more blocks' fp32 inputs
    growth = (traced[4]["peak_live_bytes"] - traced[2]["peak_live_bytes"]
              - (traced[4]["argument_size_in_bytes"] - traced[2]["argument_size_in_bytes"])
              - inputs)
    assert 0 < growth < block, (growth, block)


def test_roofline_reads_the_dryrun_records(tmp_path):
    root = str(tmp_path / "dry")
    rec = dryrun.run_cell("mamba2-780m", "decode_32k", False, False, root=root)
    assert "error" not in rec, rec.get("traceback")
    assert rec["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert (rec["peak_flops"], rec["hbm_bw"], rec["link_bw"]) == (989e12, 3.35e12, 450e9)
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    for key in ("flops_hlo_raw", "bytes_hlo_raw", "compile_s"):
        assert key not in rec
    assert rec["t_compute_s"] == rec["flops"] / 989e12
    assert rec["t_collective_s"] == rec["collective_bytes_total"] / 450e9
    assert rec["bytes_accessed"] > rec["memory"]["argument_size_in_bytes"] > 0
    recs = roofline.load_records("16x16", root)
    assert [r["_file"] for r in recs] == ["mamba2-780m__decode_32k.json"]
    row = roofline.fmt_row(recs[0])
    assert row["bottleneck"] == rec["bottleneck"] and row["device"] == rec["device"]
    bound = max(rec["t_compute_s"], rec["t_memory_s"], rec["t_collective_s"])
    assert math.isclose(roofline.roofline_fraction(rec),
                        rec["model_flops"] / 256 / 989e12 / bound)
    assert roofline.load_records("2x16x16", root) == []


def test_dryrun_refuses_beside_another_process_group():
    from repro_torch.launch.mesh import fake_process_group

    with fake_process_group(4):
        with pytest.raises(RuntimeError):
            with fake_process_group(4):
                pass


def _close(got, want, what):
    bound = 1e-4 * max(float(want.float().abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max())
    assert got.shape == want.shape and err <= bound, (what, err, bound)


def test_mesh_prefill_and_decode_are_the_one_device_steps(tmp_path):
    from repro_torch.models.model import build_params, demo_batch, serve_decode, serve_prefill
    from repro_torch.tree import leaves_with_paths

    jobs = [("moe", CFG, (2, 2), True), ("ssm", smoke_cfg("mamba2-780m", 512), (2, 2), False)]
    out = run_ranks(4, serve_worker, (jobs,), tmp_path)
    for name, cfg, _, _ in jobs:
        params = build_params(cfg, seed=0, device="cpu")
        batch = demo_batch(cfg, BATCH, SEQ, kind="prefill", seed=1, device="cpu")
        logits, cache = serve_prefill(params, batch, cfg, max_seq=SEQ + 4)
        token = demo_batch(cfg, BATCH, 1, kind="decode", seed=2, device="cpu")
        d_logits, d_cache = serve_decode(params, cache, token, cfg)
        rows = BATCH // 2
        for r in range(4):
            got = torch.load(os.path.join(out, f"{name}-prefill-rank{r}.pt"))
            i = got["dp_index"]
            _close(got["logits"], logits[i * rows:(i + 1) * rows], f"{name} prefill rank {r}")
        got = torch.load(os.path.join(out, f"{name}-decode.pt"))
        _close(got["logits"], d_logits, f"{name} decode logits")
        want = dict(leaves_with_paths(d_cache))
        for k, t in leaves_with_paths(got["cache"]):
            _close(t, want[k], f"{name} decode cache {k}")
