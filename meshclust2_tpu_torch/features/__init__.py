"""features subpackage."""
