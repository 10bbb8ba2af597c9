"""mutate subpackage."""
