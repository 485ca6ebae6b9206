"""Input generation: the world, the trajectories and the sweeps."""
