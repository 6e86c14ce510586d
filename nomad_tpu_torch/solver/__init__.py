"""The placement solver: host precompute, wave kernels, lane fusion."""
