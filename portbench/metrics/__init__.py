"""Metric readers: ``metrics/<name>.py`` with ``read(run) -> number | None``."""
