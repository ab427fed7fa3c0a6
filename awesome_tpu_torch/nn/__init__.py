"""Prior networks as ``torch.nn.Module`` hyperparameter holders with
functional ``init`` / ``apply`` over param dicts."""
from awesome_tpu_torch.nn import (  # noqa: F401
    flows,
    icnn,
    init,
    linear,
    path_connected,
)
from awesome_tpu_torch.nn.module import Module  # noqa: F401
