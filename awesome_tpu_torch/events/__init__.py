"""Observer-pattern events and watchdogs for the host-side loops."""
from awesome_tpu_torch.events.event import (  # noqa: F401
    EpochEventArgs,
    Event,
    EventArgs,
    SaveEventArgs,
    StopTraining,
)
from awesome_tpu_torch.events.watchdog import (  # noqa: F401
    LearningRateStopWatchdog,
)
