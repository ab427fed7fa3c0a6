"""Host-side utilities: timers and profiling, formatting, logging,
TensorBoard logging, image corruptions and the reference's API shims."""
from awesome_tpu_torch.utils.format import snake_case, strfdelta  # noqa: F401
from awesome_tpu_torch.utils.timer import Timer  # noqa: F401
