"""The prior-fit engine: optimizers, the per-image fit, the fused fit."""
