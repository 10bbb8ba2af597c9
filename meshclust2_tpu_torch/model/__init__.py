"""The weights file, the decision thresholds and the classifier (host and
float64 torch)."""
