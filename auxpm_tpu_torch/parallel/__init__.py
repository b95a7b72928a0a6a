"""Chains x particles parallelism on ``torch.distributed``."""
