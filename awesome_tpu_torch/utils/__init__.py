"""Host-side utilities: TensorBoard logging."""
