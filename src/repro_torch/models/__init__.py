"""Models of the port (this slice: the paper's MLP)."""
