"""Transitions, the chain runner and warm-up adaptation."""
