"""Serving: the paged engine, the session API and workloads."""
