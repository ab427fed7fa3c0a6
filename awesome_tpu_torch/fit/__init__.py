"""The prior-fit engine (optimizers, the per-image, fused and
spatio-temporal fits), joint training, checkpoints and the tracker."""
