"""Host-side molecule graphs and consensus ranking of the port (no RDKit)."""
