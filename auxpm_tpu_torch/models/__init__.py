"""Targets: log-prior + deterministic likelihood-estimator pairs."""
