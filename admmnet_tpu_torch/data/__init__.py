"""Input data: the bundled anchor case."""
