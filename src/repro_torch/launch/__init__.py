"""Launch-side helpers of the port: the in-process executable index."""
