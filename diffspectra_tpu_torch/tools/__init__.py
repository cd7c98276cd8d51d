"""Tools of the port: ``diag_probes`` runs the Mosaic probes' kernels."""
