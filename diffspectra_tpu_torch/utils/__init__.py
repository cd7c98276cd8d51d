"""Dense-graph tensor helpers and data scalers of the port."""
