"""The paper's full system on the PyTorch/CUDA port, end to end: train both
resident slot models on the synthetic IoT-23-like workload, preload the
bank, replay a boundary stream, and report the headline numbers (Fig. 4 /
Table IV analogues).

The counterpart of ``examples/packet_pipeline.py``: it runs
``repro_torch.launch.packetpath`` with ``--train`` (the reference's driver
always trains) and the same arguments, on the ``fused`` strategy by
default.  Trailing arguments pass through: ``--strategy take`` for the
exact per-row baseline, ``--device cpu`` to run without a card.

Run:  PYTHONPATH=src python examples/packet_pipeline_torch.py            # CUDA
      PYTHONPATH=src python examples/packet_pipeline_torch.py --device cpu
(equivalent to: python -m repro_torch.launch.packetpath --train --packets 2048
 --epochs 2 --samples-per-group 512)
"""

import sys

from repro_torch.launch import packetpath

ARGS = ["--train", "--packets", "2048", "--epochs", "2", "--samples-per-group", "512"]


def main(argv=None) -> int:
    return packetpath.main(ARGS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(main())
