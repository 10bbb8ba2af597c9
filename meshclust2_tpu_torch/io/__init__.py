"""io subpackage."""
