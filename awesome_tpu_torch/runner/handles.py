"""Composable event-handle library for the runner loop; counterpart of
``awesome_tpu/runner/handles.py``.

Behavior port of `awesome/run/handles.py:25-477`: reusable predicates
(``callable_or``/``callable_and``, nth-epoch, training-done,
on-training-error) and handle factories (checkpoint/prior-cache saves,
eval metrics incl. CRF, image dumps) that attach to
``AwesomeRunner.handles['epoch_processed' | 'training_finished']``.

The runner wires the reference's DEFAULT handle set itself (cadenced
saves/metrics/dumps in ``AwesomeRunner.train``); this module is for
experiments that attach EXTRA behaviors, mirroring the reference's
composition style. Handle signature: ``fn(runner, epoch)`` for
epoch_processed, ``fn(runner)`` for training_finished.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence


def callable_or(*preds: Callable) -> Callable:
    """Spec: `awesome/run/handles.py:25` — any predicate passes."""

    def pred(runner, epoch) -> bool:
        return any(p(runner, epoch) for p in preds)

    return pred


def callable_and(*preds: Callable) -> Callable:
    """Spec: `awesome/run/handles.py:51`."""

    def pred(runner, epoch) -> bool:
        return all(p(runner, epoch) for p in preds)

    return pred


def only_nth_epoch(n: int, also_after_n: bool = False) -> Callable:
    """Every nth epoch (optionally only once past epoch n).
    Spec: `awesome/run/handles.py:77` get_only_nth_epoch."""

    def pred(runner, epoch) -> bool:
        if n <= 0:
            return False
        if also_after_n and epoch < n:
            return False
        return epoch % n == 0

    return pred


def only_training_done() -> Callable:
    """Spec: `awesome/run/handles.py:134` get_only_training_done."""

    def pred(runner, epoch) -> bool:
        return epoch >= runner.config.num_epochs

    return pred


def only_last_epoch() -> Callable:
    """Spec: `awesome/run/handles.py:160`."""
    return only_training_done()


def on_training_error(want_error: bool = True,
                      count_keyboard_interrupt_as_error: bool = True
                      ) -> Callable:
    """Gate on whether training ended with an error (stored on the runner
    by the training_finished notifier).
    Spec: `awesome/run/handles.py:195` get_on_training_error."""

    def pred(runner, epoch=None) -> bool:
        err = getattr(runner, "training_error", None)
        if isinstance(err, KeyboardInterrupt) and (
            not count_keyboard_interrupt_as_error
        ):
            err = None
        return (err is not None) == want_error

    return pred


def _gated(action: Callable, only_execute_on: Optional[Callable]) -> Callable:
    def handle(runner, epoch=None):
        if only_execute_on is not None and not only_execute_on(runner, epoch):
            return
        action(runner, epoch)

    return handle


def save_handle(tag: str = "latest",
                only_execute_on: Optional[Callable] = None) -> Callable:
    """Checkpoint-save handle (incl. the prior cache — the reference's
    separate prior-save handle is folded into ``Runner.save_checkpoint``).
    Spec: `awesome/run/handles.py:215-232`."""
    return _gated(lambda r, e: r.save_checkpoint(tag), only_execute_on)


def compute_eval_metrics_handle(
    compute_crf: bool = False,
    only_execute_on: Optional[Callable] = None,
) -> Callable:
    """Full-dataset eval-metrics handle.
    Spec: `awesome/run/handles.py:339` get_compute_eval_metrics."""
    return _gated(
        lambda r, e: r.evaluate(compute_crf=compute_crf), only_execute_on
    )


def image_dump_handle(
    indices: Sequence[int],
    folder: str = "output",
    only_execute_on: Optional[Callable] = None,
) -> Callable:
    """Qualitative image-dump handle (spec: `awesome_runner.py:304-333`)."""
    return _gated(
        lambda r, e: r._dump_images(e or 0, folder, indices), only_execute_on
    )
