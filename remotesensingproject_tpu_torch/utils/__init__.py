"""I/O helpers."""
