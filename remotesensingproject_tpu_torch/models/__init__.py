"""Drivers: the 2-D depth computer and the fine-to-coarse pyramid."""
