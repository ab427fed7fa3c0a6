"""Loss weights and segmentation metrics."""
from awesome_tpu_torch.measures.losses import (  # noqa: F401
    ae,
    awesome_loss,
    bce,
    fbms_joint_loss,
    gradient_penalty,
    se,
    total_variation,
    unaries_weight,
    unaries_weighted_loss,
)
from awesome_tpu_torch.measures.metrics import (  # noqa: F401
    boundary_f1,
    iou,
    miou,
    pixel_accuracy,
)
