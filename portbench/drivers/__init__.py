"""One module per entry that a cell's window drives. Each has
``setup(ctx) -> state``, ``unit(state, index) -> dict`` (one unit of work,
ended by a device synchronize: its ``kind``, requested ``work``, loop
``steps``, model ``flops`` and ``attempts``), ``bounds(state)`` (seconds
per launch of the kernels on its path), ``release(state)`` (drops the
program's state), ``failed(state)`` (outputs that are not finite) and
``check(state) -> {name: number}`` (the numbers compared with the cell's
limits). A driver whose window runs in other processes (a mesh's ranks)
has ``measure(ctx, seconds, trace, start_wall) -> (record, state)`` in
place of ``setup`` and the harness's window."""
