"""Noise schedules of the port."""
