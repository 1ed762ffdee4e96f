"""The plain reference of the benchmark's configurations."""
