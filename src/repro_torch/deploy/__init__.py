"""Continuous deployment (torch port): sample live traffic, fine-tune BNN
slot models, roll out via canary ``SwapSlot`` epochs, auto-remediate.

The subsystem closes training -> checkpoint -> rollout -> verification
under live traffic (DESIGN.md §12): ``PacketSampler`` harvests labeled
examples off the retire/drop taps, ``OnlineTrainer`` fine-tunes and
checkpoints slot models on the card, ``CanaryController`` stages, bakes
and decides every rollout as typed control epochs covered by
``continuity_audit()``, and ``AutoRemediator`` wires
``AnomalyDetector.proposals()`` into the same gate.
"""

from repro_torch.deploy.canary import (CanaryController, bank_of, deploy_log_of,
                                       live_queues, paired_err, unwrap,
                                       wrong_verdict_total)
from repro_torch.deploy.remediate import (AutoRemediator, DeployDriver,
                                          ScheduledRollout, corrupt_params)
from repro_torch.deploy.sampler import (LabelOracle, PacketSampler, Reservoir,
                                        labeled_pool)
from repro_torch.deploy.trainer import OnlineTrainer, TrainResult, words_to_pm1

__all__ = [
    "AutoRemediator", "CanaryController", "DeployDriver", "LabelOracle",
    "OnlineTrainer", "PacketSampler", "Reservoir", "ScheduledRollout",
    "TrainResult", "bank_of", "corrupt_params", "deploy_log_of",
    "labeled_pool", "live_queues", "paired_err", "unwrap", "words_to_pm1",
]
