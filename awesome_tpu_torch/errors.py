"""Typed error hierarchy; counterpart of ``awesome_tpu/errors.py``.

Spec: `awesome/error/*.py` (50 LoC): StopTraining (re-exported from
events), MissingGroundTruthError, ArgumentNoneError, serialization errors.
"""
from __future__ import annotations

from awesome_tpu_torch.events.event import StopTraining  # noqa: F401


class AwesomeError(Exception):
    """Base class for framework errors."""


class MissingGroundTruthError(AwesomeError):
    """Raised when an operation requires dense GT that the sample lacks."""


class ArgumentNoneError(AwesomeError, ValueError):
    """Raised when a required argument is None."""

    def __init__(self, name: str):
        super().__init__(f"Argument '{name}' must not be None")
        self.name = name


class SerializationError(AwesomeError):
    """Raised when a value cannot be (de)serialized."""


class NoTrainableParametersError(AwesomeError):
    """Raised when a training step receives an empty parameter tree."""
