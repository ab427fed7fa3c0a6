"""Prior networks as ``torch.nn.Module`` hyperparameter holders with
functional ``init`` / ``apply`` over param dicts."""
