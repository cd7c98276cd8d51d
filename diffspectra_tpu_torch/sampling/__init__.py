"""Reverse diffusion and decoding of the port."""
