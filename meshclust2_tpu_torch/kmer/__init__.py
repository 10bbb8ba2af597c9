"""kmer subpackage."""
