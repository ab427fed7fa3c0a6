"""Observer-pattern events for host-side orchestration; counterpart of
``awesome_tpu/events/event.py``.

Behavior port of `awesome/event/event.py:8-101` (attach/notify/remove,
shared context, cancelable args) and the typed-error hierarchy
(`awesome/error/stop_training.py`). Inside the fit loops events don't
exist (those hooks are loop state: plateau LR, watchdog, NaN guard); this
module serves the HOST loop: epoch callbacks, checkpoint saves, metric
logging, plot dumps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

T = TypeVar("T")


class StopTraining(Exception):
    """Graceful training-stop control flow.

    Spec: `awesome/error/stop_training.py`.
    """


@dataclasses.dataclass
class EventArgs:
    """Base payload; ``cancel`` stops remaining handlers."""

    cancel: bool = False
    context: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class EpochEventArgs(EventArgs):
    epoch: int = 0
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    mode: str = "train"


@dataclasses.dataclass
class SaveEventArgs(EventArgs):
    """Spec: `awesome/event/agent_save_event_args.py` (SaveStage)."""

    stage: str = "checkpoint"  # 'pretrain' | 'best' | 'end' | 'checkpoint'
    path: Optional[str] = None


@dataclasses.dataclass
class ModelStepEventArgs(EventArgs):
    """Per-step/epoch payload: what the reference hands every handler.

    Spec: `awesome/event/torch_model_step_event_args.py` (model, output,
    loss, tracker, mode, scope, remaining_iterations). Params stand in for
    the mutable torch model; outputs/losses arrive as (batched) arrays.
    """

    params: Any = None
    output: Any = None
    loss: Optional[float] = None
    tracker: Any = None
    mode: str = "train"  # LearningMode: 'train' | 'val'
    scope: str = "batch"  # LearningScope: 'batch' | 'epoch'
    remaining_iterations: int = 0
    indices: Any = None


@dataclasses.dataclass
class OptimizerCreatedEventArgs(EventArgs):
    """Spec: `awesome/event/torch_optimizer_created_event_args.py` — fired
    when the optimizer state is (re)built so schedulers/watchdogs can
    re-register."""

    optimizer_name: str = ""
    opt_state: Any = None
    lr: Optional[float] = None


@dataclasses.dataclass
class ParamAlteredEventArgs(EventArgs):
    """Dynamic param-set changes (multi-prior grow/shrink) so the
    optimizer state can be resynced.

    Spec: `awesome/event/torch_param_altered_event_args.py` +
    `awesome/run/awesome_runner.py:477-490` _alter_optimizer. In the
    stacked-tree design this carries the new active count + the slots
    whose moments must be reset.
    """

    added_slots: Optional[List[int]] = None
    removed_slots: Optional[List[int]] = None
    new_count: Optional[int] = None


@dataclasses.dataclass
class TrainingStartedEventArgs(EventArgs):
    """Spec: `awesome/event/torch_training_started_event_args.py`."""

    num_epochs: int = 0
    start_epoch: int = 0


@dataclasses.dataclass
class TrainingFinishedEventArgs(EventArgs):
    """Spec: `awesome/event/training_finished_event_args.py` — records the
    error (if any) that ended training, for the on-training-error save
    handles."""

    error: Optional[BaseException] = None
    interrupted: bool = False


class Event(Generic[T]):
    """attach/notify/remove with mute support."""

    def __init__(self, name: str = ""):
        self.name = name
        self._handlers: List[Callable[[Any, T], None]] = []
        self.muted = False

    def attach(self, handler: Callable[[Any, T], None]) -> Callable:
        self._handlers.append(handler)
        return handler

    def remove(self, handler: Callable) -> None:
        self._handlers.remove(handler)

    def notify(self, sender: Any, args: T) -> None:
        if self.muted:
            return
        for h in list(self._handlers):
            h(sender, args)
            if getattr(args, "cancel", False):
                break

    def __len__(self) -> int:
        return len(self._handlers)
