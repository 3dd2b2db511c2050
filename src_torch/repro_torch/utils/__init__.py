"""Stdlib-only helpers of the port (the msgpack subset of the wire)."""
