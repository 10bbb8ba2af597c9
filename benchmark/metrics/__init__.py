"""The metrics readers: one file a metric, found by its name."""
