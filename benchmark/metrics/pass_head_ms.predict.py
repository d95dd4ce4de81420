"""Mean host time from a pass's entry (``save_survey_predictions_zarr``
or ``predict_reader``) to its first chunk's device work (the program's
``PhaseTimer`` phase ``pass_head``, on the launch thread: the store's
removal, the seabed lookup, the static grid's shape and the wait for the
first chunk's slab), in ms a pass over the traced passes."""


def read(ctx):
    total, n = ctx["timer"].get("pass_head", (0.0, 0))
    return total / n * 1e3 if n else None
