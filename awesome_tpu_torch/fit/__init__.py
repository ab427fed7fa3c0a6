"""The prior-fit engine (optimizers, the per-image, fused and
spatio-temporal fits), joint training, checkpoints and the tracker."""
from awesome_tpu_torch.fit.optim import (  # noqa: F401
    adam_init,
    adam_update,
    adamax_init,
    adamax_update,
    plateau_init,
    plateau_update,
)
from awesome_tpu_torch.fit.prior_fit import (  # noqa: F401
    FitConfig,
    fit_prior,
    fit_priors_batched,
    fit_priors_sequential,
    learn_convex_net,
    learn_flow_identity,
)
