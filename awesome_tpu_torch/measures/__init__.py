"""Loss weights and segmentation metrics."""
