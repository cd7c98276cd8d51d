"""Host-side data helpers of the port: dataset facts and the synthetic
generator (numpy only)."""
