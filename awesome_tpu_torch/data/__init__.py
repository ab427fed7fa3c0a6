"""Host-side data: the convexity benchmark's samples (on disk or
synthetic), per-image feature maps, padding and train/val splits."""
