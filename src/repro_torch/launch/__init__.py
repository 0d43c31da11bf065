"""Entry points."""
