"""Host milliseconds a fit-loop step takes in the traced units: the port's
``fit.loss_grad`` and ``fit.update`` spans' host seconds over the count of
``fit.loss_grad``, as ``utils.profiling.span`` adds them up while the
profiler runs. A step that the card is behind waits in its launches for
room in the card's queue, so this reads the loop's pace: the host's own
cost where that is the larger. None without a trace, or where the port has
no spans in this process (a mesh's ranks keep theirs)."""


def read(record):
    if record["kind"] != "fit" or not record.get("trace"):
        return None
    try:
        from awesome_tpu_torch.utils.profiling import span
    except ImportError:
        return None
    grad = span.totals.get("fit.loss_grad")
    update = span.totals.get("fit.update")
    if not grad or not update or grad[0] <= 0:
        return None
    return 1e3 * (grad[1] + update[1]) / grad[0]
