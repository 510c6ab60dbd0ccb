"""The port's core: numerics, bounds, the bright/dark partition, θ-kernels, the FlyMC step."""
