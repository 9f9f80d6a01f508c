"""File codecs at the I/O edge (numpy only)."""
