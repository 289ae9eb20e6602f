"""Field primitives (grids, occupancy mask, color MLP)."""
