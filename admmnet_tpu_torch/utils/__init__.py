"""Host-side utilities of the port: plotting, profiling, numerical debugging."""
