"""Multi-pod dry-run of the port: every (architecture x shape) cell on the
production meshes, traced in one process, and its roofline inputs.

For each cell this script:
  1. starts torch's fake process group of the mesh's size (256 or 512
     ranks in this one process; collectives move nothing) and builds the
     production ``DeviceMesh``;
  2. places the abstract state (train) or the parameters and cache
     (prefill, decode) by the port's rules as DTensors over ``meta`` shards
     (nothing is allocated);
  3. runs the port's own mesh step (:mod:`repro_torch.train.mesh_step`) as
     rank 0, once, on ``meta`` inputs, counting the matmul flops
     (``FlopCounterMode``), the bytes every aten op reads and writes (views
     free), the collectives where the step issues them
     (:class:`~repro_torch.distributed.comm.CollectiveCounter`, the hook a
     real run is counted by) and the peak of the bytes the rank holds
     alive (:class:`LiveBytes`);
  4. writes one JSON record to ``results/dryrun_torch/<mesh>/<arch>__<shape>.json``
     (or under ``--out``).

The record keeps the reference's keys that mean something in torch: the
cell (``arch``, ``shape``, ``mesh``, ``chips``, ``fsdp``,
``quantized_moments``, ``microbatches``, ``remat``, ``tag``),
``memory.argument_size_in_bytes`` (the rank's bytes of the state, or of
the parameters and cache, and of its inputs, under their placements),
``memory.peak_live_bytes`` (the port's own key: the most bytes of storage
alive at once while the step runs, the arguments included; the reference
records XLA's ``temp_size_in_bytes`` instead),
``flops`` and ``bytes_accessed`` (the rank's, plus the argument bytes, as
the reference's ``hlo_analysis`` counts them), ``collectives`` and
``collective_bytes_total`` (each op's result on the rank), the three
roofline terms, ``bottleneck``, ``model_flops`` and ``useful_ratio``. It
drops ``flops_hlo_raw``, ``bytes_hlo_raw``, ``compile_s``, ``lower_s`` and
the XLA memory-analysis fields: nothing is lowered or compiled, and
``launch/hlo_analysis.py``, which reads XLA's HLO text, stays with the
reference. The step is tensor-parallel over ``model`` as the rules place
the weights, so a rank's flops are its data-parallel share's with what is
split over ``model`` divided by the axis: attention by query heads, or by
queries where the heads do not divide (on one block of queries), and MoE
experts by expert or hidden column, with their capacity slots split over
``data`` where the experts do not divide. The MoE router, the replicated
leaves and attention over more than one block of queries whose heads do
not divide stay whole on every rank. The collectives include the
``model`` axis's all-reduces and all-to-alls and the capacity's exchange
over ``data`` (the token rows all-gathered, the partial outputs
reduce-scattered).

The roofline constants are the card's, not the reference's TPU's:
NVIDIA's data sheet for the NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W
power limit — 989 TFLOP/s of dense bf16, 3.35 TB/s of HBM, and 450 GB/s a
direction of NVLink for the collective term. Each record stores them
beside the card's name.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-done]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

#: the card the roofline terms are for, as ``nvidia-smi`` names it
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12   # dense bf16 a card
HBM_BW = 3.35e12      # bytes/s a card
LINK_BW = 450e9       # NVLink, bytes/s a direction a card
HBM_BYTES = 80e9      # the card's memory, 80 GB


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


class OpTraffic(TorchDispatchMode):
    """The bytes every aten op inside it reads and writes: its tensor
    operands and results, each counted once an op; views (and the
    collectives, which the collective counter reads) count nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.namespace in ("c10d", "_c10d_functional"):
            return out
        seen = {}
        for t in _tensors(args, []) + _tensors(kwargs or {}, []) + _tensors(out, []):
            seen[id(t)] = t.numel() * t.element_size()
        self.bytes += sum(seen.values())
        self.ops += 1
        return out


class LiveBytes(TorchDispatchMode):
    """The bytes of storage alive inside it, and their peak: every storage
    an op returns counts its bytes once, from the op until it is freed (a
    weakref finalizer on the storage), on top of the storages of the
    tensors given to :meth:`hold` (the step's arguments). A DTensor counts
    its local shard."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, int] = {}
        self.now = 0
        self.peak = 0

    def hold(self, tensors) -> None:
        for t in tensors:
            self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        local = getattr(t, "_local_tensor", None)
        st = (t if local is None else local).untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.now += self.live[key]
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out, []):
            self._add(t)
        return out


def _local_bytes(tree, shardings) -> int:
    from repro_torch.tree import leaves_with_paths

    sh = dict(leaves_with_paths(shardings))
    return sum(math.prod(sh[k].local_shape(t.shape)) * t.element_size()
               for k, t in leaves_with_paths(tree))


def trace_step(cfg, shape, world: int, make_mesh, fsdp: bool = False,
               quantized: bool = False, microbatches: int = 1, remat: bool = True,
               ) -> dict:
    """Run the port's mesh step of ``cfg`` for one ``shape`` (a
    ``ShapeConfig``) as rank 0 of a fake process group of ``world`` ranks,
    on the mesh ``make_mesh(device_type)`` builds over it, on ``meta``
    tensors; return the rank's argument bytes, peak live bytes, matmul
    flops, op bytes and collectives (by kind, and call by call as
    ``(mesh axis, kind, bytes)`` in the order issued)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import (batch_specs, cache_specs_tree,
                                                  param_shardings, place_tree)
    from repro_torch.launch.mesh import fake_process_group
    from repro_torch.models.model import cache_specs, input_specs
    from repro_torch.models.transformer import abstract_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.mesh_step import (make_mesh_decode_step,
                                             make_mesh_prefill_step,
                                             make_mesh_train_step)
    from repro_torch.train.state import make_abstract_state, state_shardings
    from repro_torch.tree import leaves

    with fake_process_group(world):
        mesh = make_mesh("cpu")
        inputs = input_specs(cfg, shape)
        arg_bytes = _local_bytes(inputs, batch_specs(inputs, mesh))
        if shape.kind == "train":
            opt = AdamWConfig(quantized_moments=quantized)
            abstract = make_abstract_state(cfg, opt)
            sh = state_shardings(abstract, mesh, cfg, fsdp)
            arg_bytes += _local_bytes(abstract, sh)
            state = place_tree(abstract, sh, meta=True)
            step = make_mesh_train_step(cfg, opt, mesh, sh, microbatches=microbatches,
                                        remat=remat)
            run = lambda: step(state, inputs)  # noqa: E731
            args = [state, inputs]
        else:
            aparams = abstract_params(cfg)
            p_sh = param_shardings(aparams, mesh, cfg, fsdp)
            arg_bytes += _local_bytes(aparams, p_sh)
            params = place_tree(aparams, p_sh, meta=True)
            if shape.kind == "prefill":
                step = make_mesh_prefill_step(cfg, mesh, max_seq=shape.seq_len)
                run = lambda: step(params, inputs)  # noqa: E731
                args = [params, inputs]
            else:
                acache = cache_specs(cfg, shape)
                c_sh = cache_specs_tree(acache, mesh, cfg, shape)
                arg_bytes += _local_bytes(acache, c_sh)
                cache = place_tree(acache, c_sh, meta=True)
                step = make_mesh_decode_step(cfg, mesh)
                run = lambda: step(params, cache, inputs)  # noqa: E731
                args = [params, cache, inputs]
        with CollectiveCounter() as cc, FlopCounterMode(display=False) as fc, \
                OpTraffic() as traffic, LiveBytes() as live:
            live.hold(t for a in args for t in leaves(a))
            del args
            run()
        axis = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    return {"argument_size_in_bytes": int(arg_bytes), "peak_live_bytes": live.peak,
            "flops": float(fc.get_total_flops()), "op_bytes": int(traffic.bytes),
            "ops": traffic.ops, "collectives": dict(cc.bytes),
            "collective_calls": dict(cc.calls),
            "collective_log": [(axis.get(g, g), k, n) for g, k, n in cc.log],
            "collective_bytes_total": int(cc.total_bytes)}


def roofline_terms(record: dict) -> dict:
    """The three terms of a record (rank numbers over the card's rates), its
    bottleneck, the model's flops and the share of the cluster's flops they
    are."""
    t = {"t_compute_s": record["flops"] / record["peak_flops"],
         "t_memory_s": record["bytes_accessed"] / record["hbm_bw"],
         "t_collective_s": record["collective_bytes_total"] / record["link_bw"]}
    by = {"compute": t["t_compute_s"], "memory": t["t_memory_s"],
          "collective": t["t_collective_s"]}
    t["bottleneck"] = max(by, key=by.get)
    return t


def analyze_cell(arch: str, shape_name: str, multi_pod: bool = False,
                 fsdp: bool | None = None, microbatches: int = 1,
                 remat: bool = True, extra_tag: str = "") -> dict:
    from repro_torch.configs import REGISTRY
    from repro_torch.models.config import SHAPES

    from repro_torch.launch.mesh import make_production_mesh

    cfg = REGISTRY[arch]
    shape = SHAPES[shape_name]
    if fsdp is None:
        fsdp = cfg.n_params() * 2 > 8e9  # >8 GB of bf16 params -> FSDP
    quantized = cfg.n_params() > 50e9
    record: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256, "fsdp": fsdp,
        "quantized_moments": quantized,
        "microbatches": microbatches, "remat": remat, "tag": extra_tag,
        "device": CARD, "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
        "link_bw": LINK_BW,
    }
    t0 = time.perf_counter()
    traced = trace_step(cfg, shape, record["chips"],
                        lambda dt: make_production_mesh(multi_pod=multi_pod,
                                                        device_type=dt),
                        fsdp=fsdp, quantized=quantized, microbatches=microbatches,
                        remat=remat)
    record["trace_s"] = round(time.perf_counter() - t0, 2)
    record["memory"] = {k: traced[k] for k in ("argument_size_in_bytes", "peak_live_bytes")}
    record["flops"] = traced["flops"]
    record["bytes_accessed"] = traced["op_bytes"] + traced["argument_size_in_bytes"]
    record["collectives"] = traced["collectives"]
    record["collective_bytes_total"] = traced["collective_bytes_total"]
    record.update(roofline_terms(record))
    nd = 6 * cfg.n_active_params() * shape.global_batch * (
        shape.seq_len if shape.kind == "train" else 1)
    if shape.kind != "train":
        nd = 2 * cfg.n_active_params() * shape.global_batch * (
            shape.seq_len if shape.kind == "prefill" else 1)
    record["model_flops"] = float(nd)
    cluster = record["flops"] * record["chips"]
    record["useful_ratio"] = record["model_flops"] / cluster if cluster else 0.0
    return record


def cell_path(arch: str, shape: str, multi_pod: bool, tag: str = "",
              root: str = RESULTS_DIR) -> str:
    mesh = "2x16x16" if multi_pod else "16x16"
    d = os.path.abspath(os.path.join(root, mesh))
    os.makedirs(d, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(d, f"{arch}__{shape}{suffix}.json")


def run_cell(arch: str, shape: str, multi_pod: bool, skip_done: bool,
             root: str = RESULTS_DIR, **kw) -> dict:
    path = cell_path(arch, shape, multi_pod, kw.get("extra_tag", ""), root)
    if skip_done and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    try:
        rec = analyze_cell(arch, shape, multi_pod, **kw)
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec = {"arch": arch, "shape": shape,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def fits(rec: dict) -> str:
    """A record's peak live bytes a rank, and whether they fit the card."""
    peak = rec["memory"]["peak_live_bytes"]
    return (f"peak={peak / 1e9:.2f}GB "
            f"{'fits' if peak <= HBM_BYTES else 'over'} {HBM_BYTES / 1e9:.0f}GB")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory of the records (default results/dryrun_torch)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    from repro_torch.configs import runnable_cells

    cells = runnable_cells() if args.all else [(args.arch, args.shape)]
    for arch, shape in cells:
        rec = run_cell(arch, shape, args.multi_pod, args.skip_done, root=args.out,
                       microbatches=args.microbatches, extra_tag=args.tag)
        status = ("ERROR " + rec["error"]) if "error" in rec else (
            f"ok {rec['bottleneck']:>10s} comp={rec['t_compute_s']:.4f}s "
            f"mem={rec['t_memory_s']:.4f}s coll={rec['t_collective_s']:.4f}s "
            f"{fits(rec)} (traced in {rec.get('trace_s', 0):.0f}s)")
        print(f"[{rec['mesh']}] {arch:24s} {shape:12s} {status}", flush=True)
        if not args.all and "error" not in rec:
            print("memory:", json.dumps(rec["memory"], indent=1))
            print("flops=%.4e bytes=%.4e (%s)" % (rec["flops"], rec["bytes_accessed"],
                                                  rec["device"]))
            print("collectives:", json.dumps(rec["collectives"], indent=1))


if __name__ == "__main__":
    main()
