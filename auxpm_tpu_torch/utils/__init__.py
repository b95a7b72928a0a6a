"""Run configuration, metrics and chain diagnostics."""
