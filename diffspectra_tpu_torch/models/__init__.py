"""DMT, its non-equivariant ablation DMT_WO_EQ, SpecFormer and their layers."""
