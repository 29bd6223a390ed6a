#!/usr/bin/env python
"""Which collectives gloo runs on CUDA tensors: two ranks on card 0.

The port's tensor-parallel check on one card (``chip_smoke.py``'s dist
phase, (e)) puts two ranks on one device, which NCCL refuses, so they meet
over gloo. This probe tries each ``torch.distributed`` collective the port
could use on CUDA tensors and prints one line a rank: ``ok`` or the error.
DTensor's redistribution (functional collectives) is tried last, since on
the card it can end the process with a signal rather than an error.

  python tools/gloo_cuda_probe.py      # on a machine with a card
"""

from __future__ import annotations

import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    dev = torch.device("cuda", 0)
    x = torch.full((8,), float(rank + 1), device=dev)

    def empty(n):
        return torch.empty(n, device=dev)

    checks = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather (list)": lambda: dist.all_gather([empty(8), empty(8)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(empty(16), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(empty(4), x),
        "all_to_all_single": lambda: dist.all_to_all_single(empty(8), x),
        "all_to_all (list)": lambda: dist.all_to_all(list(empty(8).chunk(2)),
                                                     list(x.chunk(2))),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
    }

    def dtensor():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
        t = DTensor.from_local(torch.ones(2, 4, device=dev), mesh, [Replicate(), Shard(0)])
        t.redistribute(mesh, [Replicate(), Replicate()]).to_local()

    checks["DTensor Shard -> Replicate"] = dtensor
    for name, fn in checks.items():
        try:
            fn()
            torch.cuda.synchronize()
            print(f"rank {rank}: {name}: ok", flush=True)
        except Exception as e:  # noqa: BLE001 - every failure is the finding
            print(f"rank {rank}: {name}: {type(e).__name__}: {str(e)[:160]}", flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(port,), nprocs=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
