"""Device layout for the data plane's queue fan-out (torch port).

The one rule the reference's ``make_queue_mesh`` applies: the queue axis is
spread over every device when the device count divides the queue count,
and otherwise over the largest device count that does (``gcd``), so each
device serves the same number of contiguous queues.  The reference's
``make_production_mesh`` and ``make_host_mesh`` lay out the LM stack and
are not part of the port.
"""

from __future__ import annotations

import math

import torch


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
