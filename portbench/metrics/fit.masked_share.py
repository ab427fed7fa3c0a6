"""Of the fit loops' image-steps in the run (the warm-up's, the window's
and the traced units'), the share whose image was masked out (``active``
false: the passing images that the gate's retry refits all the same), in
percent; 0 where no image-step is thrown away. Read from the port's own
counters (``fit.prior_fit.fit_loop_counts``, one host read after the run);
None where the port keeps none."""


def read(record):
    if record["kind"] != "fit":
        return None
    try:
        from awesome_tpu_torch.fit.prior_fit import fit_loop_counts
    except ImportError:
        return None
    counts = fit_loop_counts()
    if counts["image_steps"] <= 0:
        return None
    return 100.0 * counts["masked_image_steps"] / counts["image_steps"]
