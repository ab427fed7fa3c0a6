"""Host-side data: the convexity benchmark's samples (on disk or
synthetic), SISBOSI and the generic sample assembler, FBMS sequences,
per-image feature maps, padding and train/val splits."""
from awesome_tpu_torch.data.batching import bucket_size, pad_points  # noqa: F401
from awesome_tpu_torch.data.convexity import ConvexityDataset  # noqa: F401
from awesome_tpu_torch.data.split import split_indices  # noqa: F401
from awesome_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_convexity_dataset,
)
