"""Social-graph construction of the port."""
