"""DMT, SpecFormer and their layers, inference only."""
