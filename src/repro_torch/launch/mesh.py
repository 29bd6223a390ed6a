"""Mesh construction, the port's copy of ``repro.launch.mesh`` (spec:
single-pod 16x16, multi-pod 2x16x16), on ``torch.distributed.DeviceMesh``.

Functions, not module-level constants: importing this module touches no
process group. A mesh needs one of as many ranks as it has devices: the
launcher's (``torchrun``, NCCL on the card, gloo on the host) or the fake
one of the dry-run (:func:`fake_process_group`). :func:`process_group`
starts one rank's group for a launcher.
"""

from __future__ import annotations

import contextlib
import math
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: the collective backend of each device type; no other is tried
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
    ``("pod", "data", "model")``; the process group must have 256 or 512
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over the ranks that exist: ``data * model``
    must equal the process group's size (nothing is padded, and there is no
    fallback to fewer devices)."""
    return _mesh(device_type, (data, model), ("data", "model"))


def _mesh(device_type: str, shape: tuple, axes: tuple) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a process "
                           "group; none is initialized")
    n = math.prod(shape)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def parse_mesh(text: str) -> tuple[int, int]:
    """``"d,m"`` as ``(d, m)``, both at least 1."""
    try:
        d, m = (int(x) for x in text.split(","))
    except ValueError:
        raise ValueError(f"--mesh takes data,model (two integers), not {text!r}") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {text}: both axes must be at least 1")
    return d, m


def free_port() -> int:
    """A port on ``localhost`` that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(device: torch.device):
    """The process group of one rank, for ``device``'s backend (NCCL on the
    card, gloo on the host), destroyed on exit. Under ``torchrun``
    (``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` set) it joins the launcher's
    rendezvous and, on the card, takes the card of its ``LOCAL_RANK``;
    otherwise it is a group of one rank at a free port on ``localhost``. A
    group that already exists is used as it is and left alone."""
    if dist.is_initialized():
        yield
        return
    backend = BACKENDS[device.type]
    if "RANK" in os.environ and "MASTER_ADDR" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                                rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """torch's fake process group of ``world_size`` ranks in this one
    process (rank 0): collectives return at once and move nothing, so a
    production mesh and its DTensors can be built, and a step traced on
    ``meta`` tensors, without the devices. Refused while another group
    exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group already exists in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
