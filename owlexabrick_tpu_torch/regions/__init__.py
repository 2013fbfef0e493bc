"""Same-bricks regions and their BSP (host numpy, and the native core)."""
