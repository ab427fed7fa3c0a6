"""Watchdogs — host-side training guards; counterpart of
``awesome_tpu/events/watchdog.py``.

Spec: `awesome/event/watchdog.py:6` and
`awesome/event/watchdogs/learning_rate_stop_training_watchdog.py:24-64`.
The in-loop equivalent (updates freeze when the plateau scale decays
below ``lr_stop_scale``) lives in the fit engine; this host-loop watchdog
raises StopTraining between epochs for the epoch-driven trainers.
"""
from __future__ import annotations

from awesome_tpu_torch.events.event import EpochEventArgs, StopTraining


class LearningRateStopWatchdog:
    """Raises StopTraining when the observed LR scale <= threshold."""

    def __init__(self, threshold_scale: float = 1e-3):
        self.threshold_scale = threshold_scale

    def __call__(self, sender, args: EpochEventArgs) -> None:
        scale = args.metrics.get("lr_scale")
        if scale is not None and scale <= self.threshold_scale:
            raise StopTraining(
                f"LR scale {scale} <= threshold {self.threshold_scale}"
            )
