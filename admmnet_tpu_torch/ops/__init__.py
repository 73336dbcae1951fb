"""Signal-model and linear-algebra primitives."""
