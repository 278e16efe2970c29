"""Client-side training and server-side aggregation of the port."""
