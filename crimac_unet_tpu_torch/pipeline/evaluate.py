"""Evaluation entry point of the port (memmap surveys).

    python -m crimac_unet_tpu_torch.pipeline.evaluate --yaml_path ... \
        --checkpoint_path model.pt --save_path_metrics ... \
        --save_path_plot ... [--device cpu]

Reference surface (pipeline_train_predict/evaluate.py:120-167): per
evaluation survey, sliding-window metrics in the configured eval mode
(all/region/fish->trace) written as ``<survey>_test.csv`` and
``<survey>_pr.png`` (the plot needs matplotlib) under
``<save_path>/<experiment>/<checkpoint-run>/``.  Under torchrun
(``torchrun --nproc_per_node N -m crimac_unet_tpu_torch.pipeline.
evaluate ...``) every rank evaluates its share of each sub-batch, the
histograms are summed over the ranks, and rank 0 writes and prints.
"""

from __future__ import annotations

import os

from ..constants import EVAL_MODE_MAP
from ..ops import metrics as M
from ..parallel.mesh import barrier, is_writer
from .eval_gridded import evaluate_reader
from .infer_common import grid_height_for_reader
from .segpipe import save_metrics_dict, save_pr_plot


def evaluate_survey(runner, readers, eval_mode, save_path_metrics=None,
                    save_path_plot=None, progress=False):
    """One PR curve per survey over all its readers (reference
    evaluate.py:39-117 concatenates readers into one metric).  Under
    ``static_grid`` every reader runs the survey-max grid height (JAX
    evaluate.py:31-46); the histogram is the per-reader one."""
    hist = M.new_histogram()
    readers = list(readers)
    fixed_R = None
    if runner.static_grid and readers:
        fixed_R = max(grid_height_for_reader(r, runner.window[0],
                                             runner.overlap)
                      for r in readers)
    for reader in readers:
        hist = evaluate_reader(runner, reader, hist,
                               eval_mode=EVAL_MODE_MAP[eval_mode],
                               progress=progress, fixed_R=fixed_R)
    curve = M.pr_curve_from_histogram(hist)
    # every rank holds the same histogram; rank 0 writes and prints
    if is_writer():
        if save_path_metrics is not None:
            save_metrics_dict(curve, save_path_metrics)
        if save_path_plot is not None:
            save_pr_plot(curve, save_path_plot)
        f1, _ = M.max_f1(curve)
        print(f"F1 score: {f1}")
    barrier()
    return curve


def main(argv=None):
    from .cli_common import load_eval_context

    ctx = load_eval_context("eval", argv, want_plots=True)
    for survey in ctx.data_obj.get_evaluation_surveys():
        readers = ctx.data_obj.get_survey_readers(survey)
        print("Running evaluation for", survey)
        evaluate_survey(
            ctx.runner, readers, ctx.config["eval_mode"],
            save_path_metrics=os.path.join(ctx.metrics_dir,
                                           f"{survey}_test.csv"),
            save_path_plot=os.path.join(ctx.plot_dir, f"{survey}_pr.png"),
            progress=True)
    print(ctx.runner.timer.report())


if __name__ == "__main__":
    main()
