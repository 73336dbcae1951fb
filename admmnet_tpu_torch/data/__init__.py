"""Input data: the bundled anchor case and the synthetic datasets."""
