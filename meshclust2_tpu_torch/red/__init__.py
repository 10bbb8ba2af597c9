"""red subpackage."""
