"""Mesh construction (torch port of the reference's ``launch/mesh.py``).

The LM stack's meshes are ``torch.distributed`` ``DeviceMesh``es built
through the one ``_build`` funnel, with the reference's shapes and axis
names: the production pod ``(16, 16)`` ``("data", "model")``, two pods
``(2, 16, 16)`` ``("pod", "data", "model")``, and the host mesh over the
visible cards.  They need a default process group of as many ranks as the
mesh has devices; nothing here initialises one (the caller or the dry-run
does).

The data plane's queue fan-out is a list of devices, by the one rule the
reference's ``make_queue_mesh`` applies: the queue axis is spread over
every device when the device count divides the queue count, and otherwise
over the largest device count that does (``gcd``), so each device serves
the same number of contiguous queues.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _build(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str = "cuda"):
    """The one funnel every LM mesh layout goes through."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("no default process group: initialise one with "
                           f"{math.prod(shape)} ranks before building a mesh")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 GPUs per pod; 2 pods = 512 GPUs multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _build(shape, axes, "cuda")


def make_host_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """A ``(world // model_parallel, model_parallel)`` ``("data", "model")``
    mesh over the default group's ranks, one per visible card; refuses to
    build without CUDA unless ``device_type="cpu"``."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device_type='cpu' to "
                           "lay the mesh out on the CPU")
    n = dist.get_world_size() if dist.is_initialized() else 1
    model_parallel = min(model_parallel, n)
    return _build((n // model_parallel, model_parallel), ("data", "model"), device_type)


def make_queue_mesh(num_queues: int, devices=None):
    """The devices whose leading axis shards the queue dimension.

    ``devices`` defaults to the visible CUDA devices.  All of them are used
    when their count divides ``num_queues`` (axis ``"data"``); otherwise the
    first ``gcd(num_queues, len(devices))`` (axis ``"queues"``).  Returns
    ``(devices, axis_name)``; queue group ``i`` is queues
    ``i * Q/d .. (i + 1) * Q/d - 1`` on ``devices[i]``.
    """
    if num_queues < 1:
        raise ValueError("need at least one queue")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass devices=[...] to "
                               "lay the queues out on other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("need at least one device")
    if num_queues % len(devs) == 0:
        return devs, "data"
    return devs[:math.gcd(num_queues, len(devs))], "queues"
