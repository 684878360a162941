"""The paper's own model: h32 BNN packet classifier behind the resident bank."""

from repro_torch.core.executor import BNNConfig

CONFIG = BNNConfig(d_bits=8192, hidden=32, n_out=1)
