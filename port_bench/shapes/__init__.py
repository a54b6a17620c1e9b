"""Branch shapes of the solve_windows mixes, one module each, found by the
name a mix gives (generate.shape)."""
